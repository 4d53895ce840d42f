"""The fused LeNet inner unroll: T differentiable inner Adam steps as a
kernel pair.

Port of ``psvi_tpu/ops/fused_lenet.py::make_fused_unroll``: kernels A
(forward, ``call_A`` :973) and B (its VJP, ``call_B`` :997) behind one
``jax.custom_vjp`` become two hand-written CUDA entry points behind one
``torch.autograd.Function`` (:class:`LeNetUnroll`):

``lenet_fwd``  for t = 1..T: θ = μ + softplus(ρ)·ε_t; conv1 over the four
               pool parities, max, bias, ReLU; the same for conv2; fc1–fc3;
               the categorical NLL weighted by cw = N·f(v) plus the KL of the
               dense layers; the gradient by hand backprop; torch-exact Adam.
               Stores (p_t, m_t, n_t) for every t and emits the T losses.
``lenet_rev``  for t = T..1: recompute iteration t's forward and gradient
               at p_{t−1} (and m_t, n_t from it), the Adam VJP
               (``_sqrt_safe``: zero derivative at n = 0) to ḡ_t, then the
               VJP of g_t = ∇_p L_inner applied to ḡ_t as forward-over-
               reverse (a tangent pass in direction ḡ_t through the
               sampling, both pooled convs at their stored winning
               parities, the fc stack, the head and the backprop), plus the
               inner-loss cotangent. Emits p̄0, ū (M, 1, H, H) and, through
               ``core_weights``, v̄ and ᾱ.

The outer IW-ELBO stays plain PyTorch through autograd, as the JAX engine
leaves it to XLA. The noise is an input (one flat draw per iteration).

Layouts are the engine's natural ones, with the layout helpers of
``ops/fused_nested.py`` (``pack_params``, ``unpack_params``, ``pack_eps``,
``unpack_eps``, at ``LeNetCfg.layer_shapes()``): one flat parameter vector (per variational layer ``mu_w, rho_w, mu_b, rho_b``; conv
weights (K, C, k, k), fc weights (o, i)) and one flat noise draw per
iteration (per layer ``w (S, ...), b (S, o)``). The TPU kernel's
sample-major and class-major rows, position-major fc1 lanes, lane rolls and
0/1 selection matmuls were Mosaic workarounds and are not carried over.

Beside each kernel, its plain PyTorch version with the same formulas
written out (``lenet_fwd_torch``, ``lenet_rev_torch`` and one iteration's
VJP alone, ``rev_iter_torch_lenet``). The wrappers run the plain version
for CPU tensors and launch the kernel for CUDA tensors. Backends of
:func:`lenet_unroll`: ``"cuda"``, ``"torch"`` (the plain versions in the
Function) and ``"autograd"`` (the net's own layers through
``torch.autograd`` with ``create_graph=True``, the oracle). Everything is
float32; the plain versions run with TF32 off.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from psvi_torch.models.layers import (Flatten, Identity, MaxPool2d, ReLU, Sequential, VIConv2d,
                                      VIConvPool2d, VILinear, fuse_conv_pool, softplus)
from psvi_torch.models.networks import make_lenet
from psvi_torch.ops import elbo
from psvi_torch.ops.fused_nested import (_F, _I, _P, _adam, _check, _cw_vjp, _labels, _one_hot,
                                         core_weights, pack_eps, pack_params, unpack_eps,
                                         unpack_params)
from psvi_torch.ops.optim import _sqrt_safe
from psvi_torch.utils.resource import launch_counter, span
from psvi_torch.utils.tree import tree_leaves

# Caps of the CUDA design (enforced by supports()): the head keeps one
# logit row in registers (classes ≤ 32); the parity index is a uint8;
# S·M rows index the per-(sample, point) scratch; the conv-gradient
# partials take S·M·K2·K1·k² floats of workspace.
MAX_CLASSES = 32
MAX_SAMPLES = 64
MAX_POINTS = 1024

FC_HIDDEN = (400, 120, 84)  # LeNet's dense widths up to the classes


@dataclasses.dataclass(frozen=True)
class LeNetCfg:
    """Static configuration of the fused LeNet inner unroll."""

    T: int  # inner iterations
    S: int  # MC samples
    M: int  # coreset size
    nc: int  # classes
    N: float  # dataset-size rescaler
    parameterised: bool  # f(v) = softmax(v)
    use_alpha: bool  # f(v) *= exp(alpha)
    prior_sd: float
    b1: float = 0.9
    b2: float = 0.999
    adam_eps: float = 1e-8

    # the one geometry the kernels are checked at (make_lenet on 28×28
    # single-channel images; class constants, not fields)
    K1 = 6  # conv1 out channels (one input channel)
    K2 = 16  # conv2 out channels
    k = 5  # conv kernel (square); conv1 'same'-padded, conv2 unpadded
    H = 28  # input side

    @property
    def fc(self) -> Tuple[int, ...]:  # dense widths incl. input
        return FC_HIDDEN + (self.nc,)

    @property
    def pad(self):
        return (self.k - 1) // 2

    @property
    def P1(self):  # post-pool1 side
        return self.H // 2

    @property
    def H2(self):  # conv2 output side
        return self.P1 - self.k + 1

    @property
    def P2(self):  # post-pool2 side
        return self.H2 // 2

    @property
    def q(self):
        return self.k * self.k

    def layer_shapes(self):
        """(weight shape, bias size) of conv1, conv2, fc1, fc2, fc3."""
        f, k = self.fc, self.k
        return [((self.K1, 1, k, k), self.K1), ((self.K2, self.K1, k, k), self.K2),
                ((f[1], f[0]), f[1]), ((f[2], f[1]), f[2]), ((f[3], f[2]), f[3])]

    @property
    def n_theta(self):  # one sample of every weight and bias (61,706 at LeNet)
        return sum(math.prod(w) + o for w, o in self.layer_shapes())

    @property
    def n_params(self):  # P: flat parameter vector (μ and ρ)
        return 2 * self.n_theta

    @property
    def n_eps(self):  # E: one flat noise draw
        return self.S * self.n_theta

    def bias_corrections(self, t: int):
        """(1 − β₁ᵗ, √(1 − β₂ᵗ)) in double."""
        return 1.0 - self.b1 ** t, math.sqrt(1.0 - self.b2 ** t)


# ---------------------------------------------------------------------------
# plain PyTorch versions of the two kernels (hand-derived math)
# ---------------------------------------------------------------------------


def _parity_stack(x, k: int, pad: int, P: int):
    """Pool-parity im2col: x (..., h, h) → (4, ..., k², P, P) with entry
    [2a+b, ..., dy·k+dx, i, j] = xpad[..., 2i+a+dy, 2j+b+dx]."""
    xp = F.pad(x, (pad, pad, pad, pad)) if pad else x
    return torch.stack([
        torch.stack([xp[..., a + dy:a + dy + 2 * P - 1:2, b + dx:b + dx + 2 * P - 1:2]
                     for dy in range(k) for dx in range(k)], dim=-3)
        for a in range(2) for b in range(2)])


def _parity_fold(g, k: int, pad: int, h: int):
    """Transpose of :func:`_parity_stack`: (4, ..., k², P, P) → (..., h, h)."""
    P = g.shape[-1]
    out = g.new_zeros(*g.shape[1:-3], h + 2 * pad, h + 2 * pad)
    for a in range(2):
        for b in range(2):
            for dy in range(k):
                for dx in range(k):
                    out[..., a + dy:a + dy + 2 * P - 1:2, b + dx:b + dx + 2 * P - 1:2] += (
                        g[2 * a + b, ..., dy * k + dx, :, :])
    return out[..., pad:pad + h, pad:pad + h]


def _parity_mask(par):
    """Winning parity (S, M, K, P, P) → one-hot (4, S, M, K, P, P) floats."""
    return F.one_hot(par, 4).permute(5, 0, 1, 2, 3, 4).to(torch.float32)


def _sample(p, eps_t, cfg: LeNetCfg):
    prm = unpack_params(p, cfg)
    eps = unpack_eps(eps_t, cfg)
    sds = [(softplus(d["rho_w"]), softplus(d["rho_b"])) for d in prm]
    Ws = [d["mu_w"] + sw * ew for d, (sw, _), (ew, _) in zip(prm, sds, eps)]
    bs = [d["mu_b"] + sb * eb for d, (_, sb), (_, eb) in zip(prm, sds, eps)]
    return prm, eps, sds, Ws, bs


def _inner_value_grad(p, eps_t, X1, Y, cw, cfg: LeNetCfg):
    """L_inner(p) and ∇_p L_inner by hand backprop, with the residuals the
    reverse sweep needs. X1 is the parity stack of u (4, M, k², P1, P1)."""
    S, M, K1, K2, k, q = cfg.S, cfg.M, cfg.K1, cfg.K2, cfg.k, cfg.q
    sp = cfg.prior_sd
    sp2 = sp * sp
    prm, eps, sds, Ws, bs = _sample(p, eps_t, cfg)
    W1 = Ws[0].reshape(S, K1, q)
    W2 = Ws[1].reshape(S, K2, K1, q)
    # forward: conv1 + pool1 (max over parities, bias after the max), ReLU
    m1, par1 = torch.einsum("pmqij,skq->psmkij", X1, W1).max(0)
    p1 = m1 + bs[0][:, None, :, None, None]
    X2 = _parity_stack(torch.relu(p1), k, 0, cfg.P2)  # (4, S, M, K1, k², P2, P2)
    m2, par2 = torch.einsum("psmcqij,skcq->psmkij", X2, W2).max(0)
    p2 = (m2 + bs[1][:, None, :, None, None]).reshape(S, M, -1)
    z1 = torch.matmul(torch.relu(p2), Ws[2].transpose(1, 2)) + bs[2][:, None, :]
    z2 = torch.matmul(torch.relu(z1), Ws[3].transpose(1, 2)) + bs[3][:, None, :]
    z3 = torch.matmul(torch.relu(z2), Ws[4].transpose(1, 2)) + bs[4][:, None, :]
    lse = torch.logsumexp(z3, dim=-1)
    Pz = torch.exp(z3 - lse[..., None])
    nll = lse - (z3 * Y).sum(-1)  # (S, M)
    kl = sum(torch.sum(torch.log(sp / s) + (torch.square(s) + torch.square(d[mk])) / (2.0 * sp2) - 0.5)
             for d, sd in zip(prm[2:], sds[2:]) for mk, s in (("mu_w", sd[0]), ("mu_b", sd[1])))
    loss = torch.sum(nll @ cw) + kl
    # backward
    d3 = cw[None, :, None] * (Pz - Y)
    d2 = torch.matmul(d3, Ws[4]) * (z2 > 0)
    d1 = torch.matmul(d2, Ws[3]) * (z1 > 0)
    dp2 = torch.matmul(d1, Ws[2]) * (p2 > 0)
    mask1, mask2 = _parity_mask(par1), _parity_mask(par2)
    dc2 = mask2 * dp2.reshape(S, M, K2, cfg.P2, cfg.P2)[None]
    dp1 = _parity_fold(torch.einsum("psmkij,skcq->psmcqij", dc2, W2), k, 0, cfg.P1) * (p1 > 0)
    dc1 = mask1 * dp1[None]
    G = [
        (torch.einsum("psmkij,pmqij->skq", dc1, X1).reshape(Ws[0].shape), dp1.sum((1, 3, 4))),
        (torch.einsum("psmkij,psmcqij->skcq", dc2, X2).reshape(Ws[1].shape),
         dp2.reshape(S, M, K2, -1).sum((1, 3))),
        (torch.einsum("smo,smi->soi", d1, torch.relu(p2)), d1.sum(1)),
        (torch.einsum("smo,smi->soi", d2, torch.relu(z1)), d2.sum(1)),
        (torch.einsum("smo,smi->soi", d3, torch.relu(z2)), d3.sum(1)),
    ]
    grads, hs = [], []
    for l, (d, (sw, sb), (ew, eb), (GW, Gb)) in enumerate(zip(prm, sds, eps, G)):
        dense = 1.0 if l >= 2 else 0.0  # the reference's ELBOs skip conv KL
        hw = (GW * ew).sum(0) + dense * (-1.0 / sw + sw / sp2)
        hb = (Gb * eb).sum(0) + dense * (-1.0 / sb + sb / sp2)
        grads.append((GW.sum(0) + dense * d["mu_w"] / sp2, torch.sigmoid(d["rho_w"]) * hw,
                      Gb.sum(0) + dense * d["mu_b"] / sp2, torch.sigmoid(d["rho_b"]) * hb))
        hs.append((hw, hb))
    g = torch.cat([x.reshape(-1) for quad in grads for x in quad])
    cache = dict(prm=prm, eps=eps, sds=sds, Ws=Ws, W1=W1, W2=W2, X2=X2, p1=p1, p2=p2, z1=z1,
                 z2=z2, Pz=Pz, nll=nll, d3=d3, d2=d2, d1=d1, dp2=dp2, dc2=dc2, dp1=dp1, dc1=dc1,
                 mask1=mask1, mask2=mask2, hs=hs)
    return loss, g, cache


def _u_stack(u, cfg: LeNetCfg):
    return _parity_stack(u[:, 0], cfg.k, cfg.pad, cfg.P1)


def lenet_fwd_torch(p0, u, y, v, alpha, eps_in, lr: float, cfg: LeNetCfg):
    """T inner Adam iterations. Returns ``(losses (T,), hist (T+1, 3, P),
    cw (M,))``; ``hist[t] = (p_t, m_t, n_t)``, ``hist[T, 0]`` is paramsT."""
    cw = core_weights(v, alpha, cfg)
    Y = _one_hot(y, cfg.nc)
    X1 = _u_stack(u, cfg)
    p, m, n = p0, torch.zeros_like(p0), torch.zeros_like(p0)
    hist, losses = [torch.stack([p, m, n])], []
    for t in range(1, cfg.T + 1):
        loss, g, _ = _inner_value_grad(p, eps_in[t - 1], X1, Y, cw, cfg)
        p, m, n = _adam(p, m, n, g, t, lr, cfg)
        hist.append(torch.stack([p, m, n]))
        losses.append(loss)
    return torch.stack(losses), torch.stack(hist), cw


def rev_iter_torch_lenet(t: int, p_prev, m_prev, n_prev, pbar, mbar, nbar, dl, u, Y, cw, eps_t,
                         lr: float, cfg: LeNetCfg):
    """VJP of inner iteration t, ``(p_{t−1}, m_{t−1}, n_{t−1}, u, cw) →
    (p_t, m_t, n_t, loss_t)``, at the cotangent ``(p̄_t, m̄_t, n̄_t, dl)``.
    Returns ``(p̄_{t−1}, m̄_{t−1}, n̄_{t−1}, ū (M, 1, H, H), c̄w (M,))``.

    m_t and n_t are formed again from the recomputed gradient, not read
    from the forward's history: at t = 1 Adam's step is −lr·sign(g), whose
    VJP is the difference of two terms ∝ 1/|g| that cancel only when m_t
    and n_t come from the same g, so a gradient recomputed in another
    summation order against a stored n_t is ill-conditioned."""
    S, M, K1, K2, k, P2 = cfg.S, cfg.M, cfg.K1, cfg.K2, cfg.k, cfg.P2
    sp2 = cfg.prior_sd * cfg.prior_sd
    X1 = _u_stack(u, cfg)
    _, g, c = _inner_value_grad(p_prev, eps_t, X1, Y, cw, cfg)
    m_t = cfg.b1 * m_prev + (1.0 - cfg.b1) * g
    n_t = cfg.b2 * n_prev + (1.0 - cfg.b2) * torch.square(g)
    # Adam VJP (_sqrt_safe: zero derivative at n = 0)
    bc1, bc2s = cfg.bias_corrections(t)
    den = _sqrt_safe(n_t) / bc2s + cfg.adam_eps
    mbar_t = mbar - pbar * lr / (bc1 * den)
    pos = n_t > 0
    dsqrt = torch.where(pos, 0.5 / torch.sqrt(torch.where(pos, n_t, 1.0)), 0.0)
    nbar_t = nbar + pbar * lr * (m_t / bc1) / (den * den) * dsqrt / bc2s
    gbar = (1.0 - cfg.b1) * mbar_t + 2.0 * (1.0 - cfg.b2) * g * nbar_t

    # forward-over-reverse: the tangent of (forward, backprop) in direction ḡ
    prm, eps, sds, Ws = c["prm"], c["eps"], c["sds"], c["Ws"]
    p1, p2, z1, z2, Pz = c["p1"], c["p2"], c["z1"], c["z2"], c["Pz"]
    mask1, mask2, X2 = c["mask1"], c["mask2"], c["X2"]
    dirs = unpack_params(gbar, cfg)
    Wd = [gd["mu_w"] + torch.sigmoid(d["rho_w"]) * gd["rho_w"] * ew
          for gd, d, (ew, _) in zip(dirs, prm, eps)]
    bd = [gd["mu_b"] + torch.sigmoid(d["rho_b"]) * gd["rho_b"] * eb
          for gd, d, (_, eb) in zip(dirs, prm, eps)]
    W1d, W2d = Wd[0].reshape(S, K1, cfg.q), Wd[1].reshape(S, K2, K1, cfg.q)
    p1d = (mask1 * torch.einsum("pmqij,skq->psmkij", X1, W1d)).sum(0) + bd[0][:, None, :, None, None]
    a1d = p1d * (p1 > 0)
    X2d = _parity_stack(a1d, k, 0, P2)
    c2d = torch.einsum("psmcqij,skcq->psmkij", X2d, c["W2"]) + torch.einsum(
        "psmcqij,skcq->psmkij", X2, W2d)
    p2d = ((mask2 * c2d).sum(0) + bd[1][:, None, :, None, None]).reshape(S, M, -1)
    a2d = p2d * (p2 > 0)
    z1d = (torch.matmul(a2d, Ws[2].transpose(1, 2)) + torch.matmul(torch.relu(p2), Wd[2].transpose(1, 2))
           + bd[2][:, None, :])
    a3d = z1d * (z1 > 0)
    z2d = (torch.matmul(a3d, Ws[3].transpose(1, 2)) + torch.matmul(torch.relu(z1), Wd[3].transpose(1, 2))
           + bd[3][:, None, :])
    a4d = z2d * (z2 > 0)
    z3d = (torch.matmul(a4d, Ws[4].transpose(1, 2)) + torch.matmul(torch.relu(z2), Wd[4].transpose(1, 2))
           + bd[4][:, None, :])
    cwbar = ((Pz - Y) * z3d).sum(-1).sum(0) + dl * c["nll"].sum(0)
    d3d = cw[None, :, None] * Pz * (z3d - (Pz * z3d).sum(-1, keepdim=True))
    d2d = (torch.matmul(d3d, Ws[4]) + torch.matmul(c["d3"], Wd[4])) * (z2 > 0)
    d1d = (torch.matmul(d2d, Ws[3]) + torch.matmul(c["d2"], Wd[3])) * (z1 > 0)
    dp2d = (torch.matmul(d1d, Ws[2]) + torch.matmul(c["d1"], Wd[2])) * (p2 > 0)
    dc2d = mask2 * dp2d.reshape(S, M, K2, P2, P2)[None]
    dp1d = _parity_fold(torch.einsum("psmkij,skcq->psmcqij", dc2d, c["W2"])
                        + torch.einsum("psmkij,skcq->psmcqij", c["dc2"], W2d),
                        k, 0, cfg.P1) * (p1 > 0)
    dc1d = mask1 * dp1d[None]
    ubar = _parity_fold(torch.einsum("psmkij,skq->pmqij", dc1d + dl * c["dc1"], c["W1"])
                        + torch.einsum("psmkij,skq->pmqij", c["dc1"], W1d),
                        k, cfg.pad, cfg.H)[:, None]
    Gd = [
        (torch.einsum("psmkij,pmqij->skq", dc1d, X1).reshape(Ws[0].shape), dp1d.sum((1, 3, 4))),
        ((torch.einsum("psmkij,psmcqij->skcq", dc2d, X2)
          + torch.einsum("psmkij,psmcqij->skcq", c["dc2"], X2d)).reshape(Ws[1].shape),
         dp2d.reshape(S, M, K2, -1).sum((1, 3))),
        (torch.einsum("smo,smi->soi", d1d, torch.relu(p2)) + torch.einsum("smo,smi->soi", c["d1"], a2d),
         d1d.sum(1)),
        (torch.einsum("smo,smi->soi", d2d, torch.relu(z1)) + torch.einsum("smo,smi->soi", c["d2"], a3d),
         d2d.sum(1)),
        (torch.einsum("smo,smi->soi", d3d, torch.relu(z2)) + torch.einsum("smo,smi->soi", c["d3"], a4d),
         d3d.sum(1)),
    ]
    hvp = []
    for l, (gd, d, (sw, sb), (ew, eb), (hw, hb), (GWd, Gbd)) in enumerate(
            zip(dirs, prm, sds, eps, c["hs"], Gd)):
        dense = 1.0 if l >= 2 else 0.0
        for G, gm, gr, rho, sd, e, h in ((GWd, gd["mu_w"], gd["rho_w"], d["rho_w"], sw, ew, hw),
                                         (Gbd, gd["mu_b"], gd["rho_b"], d["rho_b"], sb, eb, hb)):
            sg = torch.sigmoid(rho)
            hvp.append(G.sum(0) + dense * gm / sp2)
            hvp.append(sg * (1.0 - sg) * gr * h
                       + sg * ((G * e).sum(0) + dense * (1.0 / (sd * sd) + 1.0 / sp2) * sg * gr))
    # hvp holds (mu_w, rho_w, mu_b, rho_b) per layer: the pack order
    hvp = torch.cat([x.reshape(-1) for x in hvp])
    return pbar + hvp + dl * g, cfg.b1 * mbar_t, cfg.b2 * nbar_t, ubar, cwbar


def lenet_rev_torch(hist, pbar, dlosses, u, y, v, alpha, eps_in, lr: float, cfg: LeNetCfg):
    """Reverse sweep t = T..1. Returns ``(p̄0 (P,), ū (M, 1, H, H), v̄ (M,),
    ᾱ (1,))``."""
    cw = core_weights(v, alpha, cfg)
    Y = _one_hot(y, cfg.nc)
    mbar, nbar = torch.zeros_like(pbar), torch.zeros_like(pbar)
    ubar, cwbar = torch.zeros_like(u), torch.zeros_like(cw)
    for t in range(cfg.T, 0, -1):
        pbar, mbar, nbar, du, dcw = rev_iter_torch_lenet(
            t, hist[t - 1, 0], hist[t - 1, 1], hist[t - 1, 2], pbar, mbar, nbar, dlosses[t - 1],
            u, Y, cw, eps_in[t - 1], lr, cfg)
        ubar = ubar + du
        cwbar = cwbar + dcw
    g_v, g_a = _cw_vjp(cwbar, cw, v, alpha, cfg)
    return pbar, ubar, g_v, g_a


# ---------------------------------------------------------------------------
# CUDA kernels (psvi_torch/ops/csrc/fused_lenet.cu)
# ---------------------------------------------------------------------------

#: Launch count of each kernel: its wrapper adds one where it launches it.
LAUNCHES = launch_counter({"lenet_fwd": 0, "lenet_rev": 0})


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_SIGNATURES = {
    # p0 u y v alpha eps | losses hist cw | workspace bytes
    "psvi_lenet_fwd": [_P] * 11,
    # hist pbar dlosses u y v alpha eps | p0bar ubar g_v g_alpha | workspace bytes
    "psvi_lenet_rev": [_P] * 14,
}


def _lib():
    from psvi_torch.ops._build import load_library

    lib = load_library("fused_lenet")
    if not getattr(lib, "_psvi_typed", False):
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args + [ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_double), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.psvi_lenet_workspace.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                                             ctypes.POINTER(ctypes.c_longlong)]
        lib.psvi_lenet_workspace.restype = ctypes.c_int
        lib._psvi_typed = True
    return lib


def _dims(cfg: LeNetCfg):
    vals = [cfg.S, cfg.M, cfg.T, cfg.nc, cfg.K1, cfg.K2, cfg.k, cfg.H, cfg.fc[1], cfg.fc[2],
            int(cfg.parameterised), int(cfg.use_alpha)]
    return (ctypes.c_int * len(vals))(*vals)


def _hyper(cfg: LeNetCfg, lr: float):
    vals = [cfg.N, cfg.prior_sd, cfg.b1, cfg.b2, cfg.adam_eps, float(lr)]
    return (ctypes.c_double * len(vals))(*vals)


def _launch(name, dev, args, cfg, lr, rev: bool):
    """Size and allocate the kernel's workspace, then call the C entry,
    which issues its launches on the current stream."""
    lib = _lib()
    sizes = (ctypes.c_longlong * 2)()
    dims = _dims(cfg)
    if lib.psvi_lenet_workspace(dims, int(rev), sizes) != 0:
        raise ValueError(f"{name}: configuration outside the kernel's caps")
    ws_f = torch.empty(int(sizes[0]), dtype=_F, device=dev)
    ws_b = torch.empty(int(sizes[1]), dtype=torch.uint8, device=dev)
    fn = getattr(lib, "psvi_" + name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*[_P(a.data_ptr()) for a in (*args, ws_f, ws_b)], dims, _hyper(cfg, lr),
                _P(stream))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1


def _inner_args(cfg, u, y, v, alpha, eps_in):
    M = cfg.M
    return [("u", u, _F, (M, 1, cfg.H, cfg.H)), ("y", y, _I, (M,)), ("v", v, _F, (M,)),
            ("alpha", alpha, _F, (1,)), ("eps_in", eps_in, _F, (cfg.T, cfg.n_eps))]


def _lenet_fwd_cuda(p0, u, y, v, alpha, eps_in, lr, cfg):
    dev = _check([("p0", p0, _F, (cfg.n_params,))] + _inner_args(cfg, u, y, v, alpha, eps_in))
    T, P, M = cfg.T, cfg.n_params, cfg.M
    out = (torch.empty(T, dtype=_F, device=dev), torch.empty((T + 1, 3, P), dtype=_F, device=dev),
           torch.empty(M, dtype=_F, device=dev))
    _launch("lenet_fwd", dev, (p0, u, y, v, alpha, eps_in) + out, cfg, lr, rev=False)
    return out


def _lenet_rev_cuda(hist, pbar, dlosses, u, y, v, alpha, eps_in, lr, cfg):
    P, M = cfg.n_params, cfg.M
    dev = _check([("hist", hist, _F, (cfg.T + 1, 3, P)), ("pbar", pbar, _F, (P,)),
                  ("dlosses", dlosses, _F, (cfg.T,))] + _inner_args(cfg, u, y, v, alpha, eps_in))
    out = (torch.empty(P, dtype=_F, device=dev), torch.empty_like(u),
           torch.empty(M, dtype=_F, device=dev), torch.empty(1, dtype=_F, device=dev))
    _launch("lenet_rev", dev, (hist, pbar, dlosses, u, y, v, alpha, eps_in) + out, cfg, lr,
            rev=True)
    return out


def lenet_fwd(p0, u, y, v, alpha, eps_in, lr: float, cfg: LeNetCfg):
    """Kernel A wrapper: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if p0.is_cuda:
        return _lenet_fwd_cuda(p0, u, _labels(y), v, alpha, eps_in, lr, cfg)
    return lenet_fwd_torch(p0, u, y, v, alpha, eps_in, lr, cfg)


def lenet_rev(hist, pbar, dlosses, u, y, v, alpha, eps_in, lr: float, cfg: LeNetCfg):
    """Kernel B wrapper (CUDA kernel for CUDA tensors, plain version on CPU)."""
    if hist.is_cuda:
        return _lenet_rev_cuda(hist, pbar, dlosses, u, _labels(y), v, alpha, eps_in, lr, cfg)
    return lenet_rev_torch(hist, pbar, dlosses, u, y, v, alpha, eps_in, lr, cfg)


# ---------------------------------------------------------------------------
# the differentiable unroll
# ---------------------------------------------------------------------------


class LeNetUnroll(torch.autograd.Function):
    """``(p0, u, v, alpha, z, eps_in, lr) → (pT, inner_losses)``; the
    backward gives ``(p̄0, ū, v̄, ᾱ)`` and nothing for the labels, the noise
    and the learning rate. ``plain=True`` runs the plain versions on any
    device (the ``"torch"`` backend)."""

    @staticmethod
    def forward(ctx, p0, u, v, alpha, z, eps_in, lr, cfg, plain):
        fwd = lenet_fwd_torch if plain else lenet_fwd
        with span("psvi.unroll.fwd"):
            losses, hist, _ = fwd(p0, u, z, v, alpha, eps_in, lr, cfg)
        ctx.save_for_backward(hist, u, v, alpha, z, eps_in)
        ctx.lr, ctx.cfg, ctx.plain = lr, cfg, plain
        return hist[cfg.T, 0].clone(), losses

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, pbar, dlosses):
        hist, u, v, alpha, z, eps_in = ctx.saved_tensors
        rev = lenet_rev_torch if ctx.plain else lenet_rev
        with span("psvi.unroll.rev"):
            p0bar, ubar, vbar, abar = rev(hist, pbar.contiguous(), dlosses.contiguous(), u, z, v,
                                          alpha, eps_in, ctx.lr, ctx.cfg)
        return p0bar, ubar, vbar, abar, None, None, None, None, None


def _autograd_unroll(p0, u, v, alpha, z, eps_in, lr, cfg: LeNetCfg):
    """The oracle: the fused LeNet's own layers through torch.autograd
    (``create_graph``); differentiable in whatever of p0, u, v, alpha
    requires grad."""
    net = fuse_conv_pool(make_lenet(prior_sd=cfg.prior_sd)).to(p0.device)
    didx = net.variational_layers

    def full(layers):
        tree = [{} for _ in net.layers]
        for k, i in enumerate(didx):
            tree[i] = layers[k]
        return tuple(tree)

    cw = core_weights(v, alpha, cfg)
    x = net.prep_input(u)
    p, m, n = p0, torch.zeros_like(p0), torch.zeros_like(p0)
    losses = []
    with torch.enable_grad():
        if not p.requires_grad:
            p = p.detach().requires_grad_(True)
        for t in range(1, cfg.T + 1):
            eps = full([{"w": w, "b": b} for w, b in unpack_eps(eps_in[t - 1], cfg)])
            loss_t = elbo.inner_elbo(net, full(unpack_params(p, cfg)), eps, x, z, cw, nc=cfg.nc)
            (g,) = torch.autograd.grad(loss_t, p, create_graph=True)
            p, m, n = _adam(p, m, n, g, t, lr, cfg)
            losses.append(loss_t)
    return p, torch.stack(losses)


def lenet_unroll(p0, u, v, alpha, z, eps_in, lr: float, cfg: LeNetCfg, backend=None):
    """The differentiable T-step inner unroll on flat parameters ``p0 (P,)``
    and flat noise ``eps_in (T, E)``; u (M, 1, H, H), v (M,), alpha (1,),
    z (M,) labels. ``backend``: ``None`` (the CUDA kernels for CUDA tensors,
    the plain versions for CPU tensors), ``"cuda"``, ``"torch"`` or
    ``"autograd"``. Returns ``(pT (P,), inner_losses (T,))``."""
    if backend is None:
        backend = "cuda" if p0.is_cuda else "torch"
    if backend == "autograd":
        return _autograd_unroll(p0, u, v, alpha, z, eps_in, lr, cfg)
    if backend == "cuda" and not p0.is_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors")
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    return LeNetUnroll.apply(p0, u, v, alpha, z, eps_in, lr, cfg, backend == "torch")


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

# the fused LeNet's exact layer sequence (make_lenet after fuse_conv_pool),
# and the literal one (make_lenet: conv, MaxPool2d), whose layers at the
# same indices hold the same parameters
_SEQUENCE = (VIConvPool2d, Identity, ReLU, VIConvPool2d, Identity, ReLU, Flatten,
             VILinear, ReLU, VILinear, ReLU, VILinear)
_LITERAL = (VIConv2d, MaxPool2d, ReLU, VIConv2d, MaxPool2d, ReLU) + _SEQUENCE[6:]


# LeNetCfg's geometry as (in channels, out channels, kernel, padding,
# stride, pool) of conv1 and conv2
_CONV1 = (1, LeNetCfg.K1, LeNetCfg.k, LeNetCfg.k // 2, 1, 2)
_CONV2 = (LeNetCfg.K1, LeNetCfg.K2, LeNetCfg.k, 0, 1, 2)


def _conv_geometry(c, pool=None):
    """A conv's geometry; a literal conv takes its pool's kernel from the
    MaxPool2d after it, which must be non-overlapping and unpadded."""
    if pool is None:
        pk = c.pool_k
    elif pool.stride == pool.kernel_size and pool.padding == 0:
        pk = pool.kernel_size
    else:
        return None
    return c.in_channels, c.out_channels, c.kernel_size, c.padding, c.stride, pk


def _lenet_dense(engine):
    """The three dense layers when the engine's net is exactly the LeNet
    the kernels compute, folded (``VIConvPool2d``) or literal (``VIConv2d``
    then ``MaxPool2d(2, 2)``, either pool backend: the same function), at
    the geometry they are checked at, else None."""
    net = engine.net
    if not isinstance(net, Sequential):
        return None
    L = list(net.layers)
    seq = next((q for q in (_SEQUENCE, _LITERAL)
                if len(L) == len(q) and all(type(l) is t for l, t in zip(L, q))), None)
    if seq is None:
        return None
    pools = (L[1], L[4]) if seq is _LITERAL else (None, None)
    c1, c2, dense = L[0], L[3], [L[7], L[9], L[11]]
    if (_conv_geometry(c1, pools[0]) != _CONV1 or _conv_geometry(c2, pools[1]) != _CONV2
            or engine.D != LeNetCfg.H ** 2):
        return None
    if any(l.compute_dtype != "float32" for l in (c1, c2, *dense)):
        return None
    if (tuple(l.in_dim for l in dense) != FC_HIDDEN
            or tuple(l.out_dim for l in dense[:2]) != FC_HIDDEN[1:]):
        return None
    if any(c.count_kl or not c.use_bias for c in (c1, c2)):
        return None
    if not all(l.count_kl and l.use_bias and l.prior_sd == dense[0].prior_sd for l in dense):
        return None
    return dense


def supports(engine) -> bool:
    """True when the engine's nested step can run as the LeNet kernel pair:
    exactly the LeNet of ``make_lenet``, folded (conv-pool, Identity, ReLU,
    conv-pool, Identity, ReLU, Flatten, fc1, ReLU, fc2, ReLU, fc3) or
    literal (conv, MaxPool2d(2, 2) of either backend, ReLU, ... at the same
    indices); conv KL not counted, one dense prior_sd; on 28×28
    single-channel images (conv 6/16/5, fc 400-120-84-classes); float32
    compute, parameters and data; categorical hard labels; the plain nested
    trainer (not truncated, ablated or evaluate-only) with inner Adam; and
    the CUDA design's caps (2 ≤ S ≤ 64, M ≤ 1024, classes ≤ 32). A packed
    net is not a ``Sequential`` and is refused, as in JAX; so are a step
    under the trial runner's vmap, ``shard_mc`` and a sharded batch (JAX
    ``fused_lenet.py:1143,1173-1174``)."""
    if engine._in_trial_vmap or engine.shard_mc or engine.data_shard is not None:
        return False
    dense = _lenet_dense(engine)
    if dense is None:
        return False
    fp32 = (all(x.dtype == torch.float32 for x in tree_leaves(engine.state.params))
            and engine.state.u.dtype == torch.float32)
    return (
        fp32
        and 2 <= engine.mc_samples <= MAX_SAMPLES
        and 0 < engine.num_pseudo <= MAX_POINTS
        and dense[2].out_dim == engine.nc <= MAX_CLASSES
        and engine.inner_it >= 1
        and engine.trainer == "nested"
        and not engine.truncated
        and engine.inner_optimizer == "adam"
        and engine.likelihood == "categorical"
        and not engine.spec.learn_z
        and not engine.spec.ablated
        and not engine.spec.evaluate_only
    )


def cfg_from_engine(engine) -> LeNetCfg:
    """The static kernel config of a supported engine."""
    dense = _lenet_dense(engine)
    if dense is None:
        raise ValueError("not the fused LeNet: call supports() first")
    return LeNetCfg(
        T=engine.inner_it, S=engine.mc_samples, M=engine.num_pseudo, nc=engine.nc,
        N=float(engine.N), parameterised=bool(engine.spec.parameterised),
        use_alpha=bool(engine.spec.learn_alpha or engine.spec.alpha_fixed),
        prior_sd=float(dense[0].prior_sd))
