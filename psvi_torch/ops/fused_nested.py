"""The fused nested PSVI step for the dense mean-field family.

Port of ``psvi_tpu/ops/fused_nested.py::fused_nested_outer``: one whole
bilevel outer step of a ``VILinear (ReLU VILinear)*`` net with a
categorical likelihood (class labels z) or a Gaussian one at precision τ
(real targets z, one output) —

- T differentiable inner Adam iterations on the inner ELBO
  ``Σ_s Σ_m cw_m·NLL(u_m, z_m; θ_s) + KL(q‖p)``, cw = N·f(v);
- the outer importance-weighted PSVI-ELBO on (u, minibatch) from paramsT;
- the hypergradients w.r.t. u, v and α through the whole unroll, and for
  the Gaussian likelihood w.r.t. the targets z (``learn_z``, the
  regressors).

The JAX package got the reverse sweep by tracing ``jax.value_and_grad``
into one Mosaic kernel. CUDA has no tracer, so here the reverse sweep is
derived by hand and split into three kernels, each with a plain-PyTorch
twin of the same math in this module:

``nested_fwd``   for t = 1..T: θ = μ + softplus(ρ)·ε_t, forward on u for all
                 S samples, NLL and KL, the first-order gradient by hand
                 backprop, the torch-exact Adam step. Stores (p, m, n) for
                 every t and emits the T inner losses.
``nested_outer`` from paramsT and the outer noise: the forward on (u, xb),
                 the pseudo and data NLLs, the per-sample NKL, the
                 self-normalized IW weights and the loss; its backward to
                 p̄_T and the direct ū, c̄w and z̄.
``nested_rev``   for t = T..1: the Adam VJP (``_sqrt_safe`` rule: zero
                 derivative at n = 0) to ḡ_t, then the VJP of
                 g_t = ∇_p L_inner(p_{t−1}; u, cw, z, ε_t) applied to ḡ_t
                 as forward-over-reverse — a tangent pass in direction ḡ_t
                 through the forward and the backprop — accumulating
                 p̄_{t−1}, ū, c̄w and z̄. Finally c̄w → v̄, ᾱ.

The likelihood enters only through the head on the outputs Z: the NLL,
its gradient ∂NLL/∂Z (softmax − onehot, or τ·(Z − z)) and its Hessian on
a tangent (the softmax Jacobian, or the constant τ). ∂NLL/∂z is −τ·(Z − z),
so z̄ is minus the sum over samples of the head's δ at the pseudo points:
in the outer step the IW-ELBO's δ, in iteration t the tangent δ̇ = cw·τ·Ż.

The layouts are the engine's natural ones: a flat parameter vector
(per layer ``mu_w (o,i), rho_w (o,i), mu_b (o), rho_b (o)``) and a flat
noise draw (per layer ``w (S,o,i), b (S,o)``). The TPU kernel's
sample-major/class-major rank-2 layouts and 0/1 mask matmuls were Mosaic
workarounds and are not carried over.

Each of the three runs as one thread block cluster whose blocks each hold a
group of the S samples; ``_nested_plan`` works out its size, the samples a
block holds and whether their maps fit in shared memory from the config
alone.

Backends of :func:`fused_nested_outer`: ``"cuda"`` (the hand-written
kernels, CUDA tensors only), ``"torch"`` (the plain versions),
``"autograd"`` (the ``_nested_core`` math through ``torch.autograd`` with
``create_graph=True`` — the oracle both are held against). Everything is
float32; the plain versions run with TF32 off (see ``psvi_torch.device``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from psvi_torch.models.layers import ReLU, Sequential, VILinear, softplus
from psvi_torch.models.networks import make_dense
from psvi_torch.ops import elbo
from psvi_torch.ops.optim import _sqrt_safe

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)

# Caps of the CUDA design (enforced by supports()): the kernels index samples
# in shared tables of MAX_SAMPLES and add a parameter's samples in one warp;
# the net struct holds MAX_LAYERS.
MAX_LAYERS = 8
MAX_SAMPLES = 32
MAX_WIDTH_X_S = 2048  # S·max(width), as the JAX gate
MAX_POINTS = 2048  # M + B, as the JAX gate

# The kernels run as one thread block cluster (csrc: MAX_CLUSTER, SMEM_CAP,
# FWD_THREADS): at most 8 blocks (the portable cluster size), each with at
# most SMEM_CAP bytes of dynamic shared memory (the card's 232,448 a block
# less room for its static arrays) and at most 32 warps.
MAX_CLUSTER = 8
SMEM_CAP = 232448 - 1024
NWARPS = 32


@dataclasses.dataclass(frozen=True)
class FusedCfg:
    """Static configuration of the fused nested step."""

    T: int  # inner iterations
    S: int  # MC samples
    widths: Tuple[int, ...]  # dense stack (D, h, ..., nc); ReLU between
    M: int  # coreset size
    B: int  # outer minibatch rows
    N: float  # dataset-size rescaler
    parameterised: bool  # f(v) = softmax(v)
    use_alpha: bool  # f(v) *= exp(alpha)
    prior_sd: float
    likelihood: str = "categorical"  # or "gaussian" (the regressors; nc = 1)
    tau: float = 0.1  # Gaussian precision
    learn_z: bool = False  # the Gaussian targets are hyperparameters (g_z)
    b1: float = 0.9
    b2: float = 0.999
    adam_eps: float = 1e-8

    @property
    def L(self):
        return len(self.widths) - 1

    @property
    def gaussian(self):
        return self.likelihood == "gaussian"

    @property
    def D(self):
        return self.widths[0]

    @property
    def nc(self):
        return self.widths[-1]

    def layer_dims(self):
        return [(self.widths[l], self.widths[l + 1]) for l in range(self.L)]

    def layer_shapes(self):
        """(weight shape, bias size) of each layer."""
        return [((o, i), o) for i, o in self.layer_dims()]

    @property
    def n_params(self):  # P: flat parameter vector length
        return sum(2 * (o * i + o) for i, o in self.layer_dims())

    @property
    def n_eps(self):  # E: one flat noise draw
        return self.S * sum(o * i + o for i, o in self.layer_dims())

    @property
    def n_units(self):  # Σ_l out_l: activation units per (sample, point)
        return sum(self.widths[1:])

    def bias_corrections(self, t: int):
        """(1 − β₁ᵗ, √(1 − β₂ᵗ)) in double, as the JAX core computes them."""
        return 1.0 - self.b1 ** t, math.sqrt(1.0 - self.b2 ** t)


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------


def pack_params(layers) -> torch.Tensor:
    """Per-layer dicts ``mu_w, rho_w, mu_b, rho_b`` → flat (P,)."""
    return torch.cat([p[key].reshape(-1) for p in layers
                      for key in ("mu_w", "rho_w", "mu_b", "rho_b")])


def unpack_params(flat: torch.Tensor, cfg):
    """Flat (P,) → per-layer dicts of views, at ``cfg.layer_shapes()``."""
    out, off = [], 0
    for wshape, o in cfg.layer_shapes():
        nw = math.prod(wshape)
        out.append({"mu_w": flat[off:off + nw].view(wshape),
                    "rho_w": flat[off + nw:off + 2 * nw].view(wshape),
                    "mu_b": flat[off + 2 * nw:off + 2 * nw + o],
                    "rho_b": flat[off + 2 * nw + o:off + 2 * nw + 2 * o]})
        off += 2 * (nw + o)
    return out


def pack_eps(layers, lead=()) -> torch.Tensor:
    """Per-layer noise dicts ``w (*lead, S, ...), b (*lead, S, o)`` → (*lead, E)."""
    n = len(lead)
    return torch.cat([torch.cat([e["w"].reshape(*lead, -1), e["b"].reshape(*lead, -1)], dim=n)
                      for e in layers], dim=n)


def unpack_eps(flat: torch.Tensor, cfg):
    """One flat draw (E,) → per-layer ``(w (S, ...), b (S, o))`` views."""
    out, off, S = [], 0, cfg.S
    for wshape, o in cfg.layer_shapes():
        nw = S * math.prod(wshape)
        out.append((flat[off:off + nw].view(S, *wshape), flat[off + nw:off + nw + S * o].view(S, o)))
        off += nw + S * o
    return out


def _mu_rho(flat, cfg):
    return [(p["mu_w"], p["rho_w"], p["mu_b"], p["rho_b"]) for p in unpack_params(flat, cfg)]


def _pack4(parts):
    return torch.cat([x.reshape(-1) for quad in parts for x in quad])


def core_weights(v, alpha, cfg: FusedCfg):
    """cw = N·f(v) (ref ``psvi_classes.py:111,1358-1360,1486-1488``)."""
    if cfg.parameterised:
        e = torch.exp(v - torch.max(v))
        f = e / torch.sum(e)
    else:
        f = v
    if cfg.use_alpha:
        f = torch.exp(alpha[0]) * f
    return cfg.N * f


# ---------------------------------------------------------------------------
# plain PyTorch versions of the three kernels (hand-derived math)
# ---------------------------------------------------------------------------


def _forward(Ws, bs, X):
    """Pre-activations z^l (S, P, out_l) of every layer for input X (P, D)."""
    zs = []
    for l, (W, b) in enumerate(zip(Ws, bs)):
        if l == 0:
            z = torch.einsum("pi,soi->spo", X, W)
        else:
            z = torch.matmul(torch.relu(zs[-1]), W.transpose(1, 2))
        zs.append(z + b[:, None, :])
    return zs


def _backward(Ws, zs, delta_top):
    """δ^l = ∂/∂z^l for every layer, from δ at the logits."""
    deltas = [None] * len(Ws)
    deltas[-1] = delta_top
    for l in range(len(Ws) - 1, 0, -1):
        deltas[l - 1] = torch.matmul(deltas[l], Ws[l]) * (zs[l - 1] > 0)
    return deltas


def _layer_input(zs, X, l):
    return X if l == 0 else torch.relu(zs[l - 1])


def _sample_grads(delta, a_prev):
    """Per-sample ∂/∂W (S,o,i) and ∂/∂b (S,o) from δ (S,P,o) and the input."""
    if a_prev.dim() == 2:
        GW = torch.einsum("spo,pi->soi", delta, a_prev)
    else:
        GW = torch.einsum("spo,spi->soi", delta, a_prev)
    return GW, delta.sum(1)


def _targets(y, cfg: FusedCfg):
    """The head's targets: one-hot rows (P, nc) of class labels, or the real
    targets (P,) of a Gaussian likelihood."""
    if cfg.gaussian:
        return y.reshape(-1)
    return _one_hot(y, cfg.nc)


def _head(Z, Y, cfg: FusedCfg):
    """The likelihood head on the outputs Z (S, P, nc): the NLL (S, P), its
    gradient ∂NLL/∂Z (S, P, nc), and the map Ż ↦ ∂²NLL/∂Z²·Ż."""
    if cfg.gaussian:
        scale = 1.0 / math.sqrt(cfg.tau)
        nll = 0.5 * torch.square((Y - Z[..., 0]) / scale) + math.log(scale) + _HALF_LOG_2PI
        return nll, cfg.tau * (Z - Y[:, None]), lambda Zd: cfg.tau * Zd
    lse = torch.logsumexp(Z, dim=-1)
    Pz = torch.exp(Z - lse[..., None])
    return (lse - (Z * Y).sum(-1), Pz - Y,
            lambda Zd: Pz * (Zd - (Pz * Zd).sum(-1, keepdim=True)))


def _zbar(delta_top, cfg: FusedCfg):
    """−Σ_s δ_{s,m} at the head: ∂/∂z_m of a sum whose head δ is
    c·τ·(Z − z) (zeros for class labels)."""
    if cfg.gaussian:
        return -delta_top[..., 0].sum(0)
    return torch.zeros(delta_top.shape[1], dtype=delta_top.dtype, device=delta_top.device)


def _inner_value_grad(p, eps_t, u, Y, cw, cfg: FusedCfg):
    """L_inner(p) and ∇_p L_inner by hand backprop, with the residuals the
    reverse sweep needs."""
    sp = cfg.prior_sd
    sp2 = sp * sp
    prm = _mu_rho(p, cfg)
    eps = unpack_eps(eps_t, cfg)
    sds = [(softplus(rw), softplus(rb)) for _, rw, _, rb in prm]
    Ws = [mw + sw * ew for (mw, _, _, _), (sw, _), (ew, _) in zip(prm, sds, eps)]
    bs = [mb + sb * eb for (_, _, mb, _), (_, sb), (_, eb) in zip(prm, sds, eps)]
    zs = _forward(Ws, bs, u)
    nll, G, hvp = _head(zs[-1], Y, cfg)
    kl = sum(
        torch.sum(torch.log(sp / s) + (torch.square(s) + torch.square(m)) / (2.0 * sp2) - 0.5)
        for (mw, _, mb, _), (sw, sb) in zip(prm, sds) for m, s in ((mw, sw), (mb, sb))
    )
    loss = torch.sum(nll @ cw) + kl
    deltas = _backward(Ws, zs, cw[None, :, None] * G)
    grads, hs = [], []
    for l, ((mw, rw, mb, rb), (sw, sb), (ew, eb)) in enumerate(zip(prm, sds, eps)):
        GW, Gb = _sample_grads(deltas[l], _layer_input(zs, u, l))
        # h = ∂L/∂σ; ∂L/∂ρ = sigmoid(ρ)·h
        hw = (GW * ew).sum(0) - 1.0 / sw + sw / sp2
        hb = (Gb * eb).sum(0) - 1.0 / sb + sb / sp2
        grads.append((GW.sum(0) + mw / sp2, torch.sigmoid(rw) * hw,
                      Gb.sum(0) + mb / sp2, torch.sigmoid(rb) * hb))
        hs.append((hw, hb))
    cache = dict(prm=prm, sds=sds, eps=eps, Ws=Ws, zs=zs, G=G, hvp=hvp, deltas=deltas, hs=hs)
    return loss, _pack4(grads), cache


def _adam(p, m, n, g, t, lr, cfg: FusedCfg):
    bc1, bc2s = cfg.bias_corrections(t)
    m = cfg.b1 * m + (1.0 - cfg.b1) * g
    n = cfg.b2 * n + (1.0 - cfg.b2) * torch.square(g)
    p = p - lr * (m / bc1) / (_sqrt_safe(n) / bc2s + cfg.adam_eps)
    return p, m, n


def _one_hot(y, nc):
    return F.one_hot(y.long(), nc).to(torch.float32)


def nested_fwd_torch(p0, u, y, v, alpha, eps_in, lr: float, cfg: FusedCfg):
    """T inner Adam iterations. Returns ``(losses (T,), hist (T+1, 3, P),
    cw (M,))``; ``hist[t] = (p_t, m_t, n_t)``, ``hist[T, 0]`` is paramsT."""
    cw = core_weights(v, alpha, cfg)
    Y = _targets(y, cfg)
    p, m, n = p0, torch.zeros_like(p0), torch.zeros_like(p0)
    hist, losses = [torch.stack([p, m, n])], []
    for t in range(1, cfg.T + 1):
        loss, g, _ = _inner_value_grad(p, eps_in[t - 1], u, Y, cw, cfg)
        p, m, n = _adam(p, m, n, g, t, lr, cfg)
        hist.append(torch.stack([p, m, n]))
        losses.append(loss)
    return torch.stack(losses), torch.stack(hist), cw


def nested_outer_torch(pT, u, y, cw, xb, yb, eps_out, cfg: FusedCfg):
    """Outer IW-ELBO from paramsT and its first-order backward. Returns
    ``(loss (), p̄_T (P,), ū (M, D), c̄w (M,), z̄ (M,))``."""
    S, M, B = cfg.S, cfg.M, cfg.B
    sp = cfg.prior_sd
    sp2 = sp * sp
    X = torch.cat([u, xb], dim=0)
    Y = torch.cat([_targets(y, cfg), _targets(yb, cfg)], dim=0)
    prm = _mu_rho(pT, cfg)
    eps = unpack_eps(eps_out, cfg)
    sds = [(softplus(rw), softplus(rb)) for _, rw, _, rb in prm]
    Ws = [mw + sw * ew for (mw, _, _, _), (sw, _), (ew, _) in zip(prm, sds, eps)]
    bs = [mb + sb * eb for (_, _, mb, _), (_, sb), (_, eb) in zip(prm, sds, eps)]
    zs = _forward(Ws, bs, X)
    nll, G, _ = _head(zs[-1], Y, cfg)
    pseudo = nll[:, :M] @ cw
    data = (cfg.N / B) * nll[:, M:].sum(1)
    spt = torch.tensor(sp, dtype=pT.dtype, device=pT.device)

    def logpdf(x, mu, sd):
        return -0.5 * torch.square((x - mu) / sd) - torch.log(sd) - _HALF_LOG_2PI

    nkl = 0.0
    for (mw, _, mb, _), (sw, sb), W, b in zip(prm, sds, Ws, bs):
        nkl = nkl + (logpdf(W, 0.0, spt) - logpdf(W, mw, sw)).sum((1, 2))
        nkl = nkl + (logpdf(b, 0.0, spt) - logpdf(b, mb, sb)).sum(1)
    log_w = -pseudo + nkl
    w = torch.softmax(log_w, dim=0)
    # d centred at its weighted mean in two passes, so that the coefficients
    # c_ps below sum to zero in fp32 as they do exactly (|d| ~ 10²)
    d = data - pseudo
    d_ref = torch.sum(w * d)
    dc = d - d_ref
    dcbar = torch.sum(w * dc)
    loss = d_ref + dcbar - torch.mean(log_w)
    # ∂loss/∂log_w, ∂loss/∂pseudo, ∂loss/∂data
    q = w * (dc - dcbar) - 1.0 / S
    c_ps = -w - q
    coef = torch.cat([c_ps[:, None] * cw[None, :],
                      (w * (cfg.N / B))[:, None].expand(S, B)], dim=1)
    deltas = _backward(Ws, zs, coef[..., None] * G)
    bars = []
    for l, ((mw, rw, mb, rb), (sw, sb), (ew, eb), W, b) in enumerate(
            zip(prm, sds, eps, Ws, bs)):
        GW, Gb = _sample_grads(deltas[l], _layer_input(zs, X, l))
        quad = []
        for G, th, mu, sd, rho, e, qs in ((GW, W, mw, sw, rw, ew, q[:, None, None]),
                                          (Gb, b, mb, sb, rb, eb, q[:, None])):
            r = (th - mu) / sd
            # nkl: ∂/∂θ = −θ/sp² + r/σ; direct ∂/∂μ = −r/σ, ∂/∂σ = (1 − r²)/σ
            thbar = G + qs * (-th / sp2 + r / sd)
            mubar = thbar.sum(0) - (qs * r / sd).sum(0)
            sdbar = (e * thbar).sum(0) + (qs * (1.0 - r * r) / sd).sum(0)
            quad.append((mubar, sdbar * torch.sigmoid(rho)))
        bars.append((quad[0][0], quad[0][1], quad[1][0], quad[1][1]))
    ubar = torch.einsum("spo,soi->pi", deltas[0][:, :M], Ws[0])
    # Σ_s c_ps·NLL with the NLL centred over the samples: the c_ps sum to
    # zero, so the value is the same, but the part of the NLL that all
    # samples share (for a Gaussian head most of it, the log-normaliser)
    # no longer cancels in fp32
    nll_ps = nll[:, :M]
    cwbar = (c_ps[:, None] * (nll_ps - nll_ps.mean(0))).sum(0)
    return loss, _pack4(bars), ubar, cwbar, _zbar(deltas[-1][:, :M], cfg)


def rev_iter_torch(t: int, p_prev, m_t, n_t, pbar, mbar, nbar, u, Y, cw, eps_t,
                   lr: float, cfg: FusedCfg):
    """VJP of inner iteration t, ``(p_{t−1}, m_{t−1}, n_{t−1}, u, cw, z) →
    (p_t, m_t, n_t)``, at the cotangent ``(p̄_t, m̄_t, n̄_t)``. ``Y`` holds
    the head's targets (``_targets``). Returns ``(p̄_{t−1}, m̄_{t−1},
    n̄_{t−1}, ū, c̄w, z̄)``; z̄ is zero for class labels."""
    sp2 = cfg.prior_sd * cfg.prior_sd
    _, g, c = _inner_value_grad(p_prev, eps_t, u, Y, cw, cfg)
    # Adam VJP (_sqrt_safe: zero derivative at n = 0)
    bc1, bc2s = cfg.bias_corrections(t)
    den = _sqrt_safe(n_t) / bc2s + cfg.adam_eps
    mbar_t = mbar - pbar * lr / (bc1 * den)
    pos = n_t > 0
    dsqrt = torch.where(pos, 0.5 / torch.sqrt(torch.where(pos, n_t, 1.0)), 0.0)
    nbar_t = nbar + pbar * lr * (m_t / bc1) / (den * den) * dsqrt / bc2s
    gbar = (1.0 - cfg.b1) * mbar_t + 2.0 * (1.0 - cfg.b2) * g * nbar_t

    # forward-over-reverse: tangent of (forward, backprop) in direction ḡ
    prm, sds, eps, Ws, zs = c["prm"], c["sds"], c["eps"], c["Ws"], c["zs"]
    G, hvp, deltas, hs = c["G"], c["hvp"], c["deltas"], c["hs"]
    dirs = _mu_rho(gbar, cfg)
    Wd = [gmw + torch.sigmoid(rw) * grw * ew
          for (gmw, grw, _, _), (_, rw, _, _), (ew, _) in zip(dirs, prm, eps)]
    bd = [gmb + torch.sigmoid(rb) * grb * eb
          for (_, _, gmb, grb), (_, _, _, rb), (_, eb) in zip(dirs, prm, eps)]
    zd = []
    for l in range(cfg.L):
        if l == 0:
            z = torch.einsum("pi,soi->spo", u, Wd[0])
        else:
            ad_prev = zd[-1] * (zs[l - 1] > 0)
            z = (torch.matmul(ad_prev, Ws[l].transpose(1, 2))
                 + torch.matmul(torch.relu(zs[l - 1]), Wd[l].transpose(1, 2)))
        zd.append(z + bd[l][:, None, :])
    Zd = zd[-1]
    cwbar = (G * Zd).sum(-1).sum(0)
    dd = [None] * cfg.L
    dd[-1] = cw[None, :, None] * hvp(Zd)
    for l in range(cfg.L - 1, 0, -1):
        dd[l - 1] = (torch.matmul(dd[l], Ws[l]) + torch.matmul(deltas[l], Wd[l])) * (zs[l - 1] > 0)
    ubar = (torch.einsum("spo,soi->pi", dd[0], Ws[0])
            + torch.einsum("spo,soi->pi", deltas[0], Wd[0]))
    hv = []
    for l, ((gmw, grw, gmb, grb), (mw, rw, mb, rb), (sw, sb), (ew, eb), (hw, hb)) in enumerate(
            zip(dirs, prm, sds, eps, hs)):
        GWd, Gbd = _sample_grads(dd[l], _layer_input(zs, u, l))
        if l > 0:
            GWd = GWd + torch.einsum("spo,spi->soi", deltas[l], zd[l - 1] * (zs[l - 1] > 0))
        quad = []
        for G, gm, gr, rho, sd, e, h in ((GWd, gmw, grw, rw, sw, ew, hw),
                                         (Gbd, gmb, grb, rb, sb, eb, hb)):
            sg = torch.sigmoid(rho)
            quad.append(G.sum(0) + gm / sp2)
            quad.append(sg * (1.0 - sg) * gr * h
                        + sg * ((G * e).sum(0) + (1.0 / (sd * sd) + 1.0 / sp2) * sg * gr))
        hv.append((quad[0], quad[1], quad[2], quad[3]))
    return (pbar + _pack4(hv), cfg.b1 * mbar_t, cfg.b2 * nbar_t, ubar, cwbar,
            _zbar(dd[-1], cfg))


def _cw_vjp(cwbar, cw, v, alpha, cfg: FusedCfg):
    """c̄w → (v̄ (M,), ᾱ (1,)) through cw = N·[exp(α)·] f(v)."""
    scale = cfg.N * (torch.exp(alpha[0]) if cfg.use_alpha else 1.0)
    if cfg.parameterised:
        e = torch.exp(v - torch.max(v))
        f = e / torch.sum(e)
        fbar = scale * cwbar
        g_v = f * (fbar - torch.sum(f * fbar))
    else:
        g_v = scale * cwbar
    if cfg.use_alpha:
        g_a = torch.sum(cwbar * cw).reshape(1)
    else:
        g_a = torch.zeros(1, dtype=cw.dtype, device=cw.device)
    return g_v, g_a


def nested_rev_torch(hist, pbar, ubar, cwbar, zbar, u, y, cw, v, alpha, eps_in,
                     lr: float, cfg: FusedCfg):
    """Reverse sweep t = T..1 from the outer step's cotangents. Returns
    ``(g_u (M, D), g_v (M,), g_alpha (1,), g_z (M,))``."""
    Y = _targets(y, cfg)
    mbar, nbar = torch.zeros_like(pbar), torch.zeros_like(pbar)
    for t in range(cfg.T, 0, -1):
        pbar, mbar, nbar, du, dcw, dz = rev_iter_torch(
            t, hist[t - 1, 0], hist[t, 1], hist[t, 2], pbar, mbar, nbar,
            u, Y, cw, eps_in[t - 1], lr, cfg)
        ubar = ubar + du
        cwbar = cwbar + dcw
        zbar = zbar + dz
    g_v, g_a = _cw_vjp(cwbar, cw, v, alpha, cfg)
    return ubar, g_v, g_a, zbar


# ---------------------------------------------------------------------------
# CUDA kernels (psvi_torch/ops/csrc/fused_nested.cu)
# ---------------------------------------------------------------------------

#: Launch count of each kernel and likelihood branch (``<kernel>`` for the
#: categorical head, ``<kernel>_gaussian`` for the Gaussian one): its
#: wrapper adds one where it launches it.
LAUNCHES = {f"{k}{b}": 0 for k in ("nested_fwd", "nested_outer", "nested_rev")
            for b in ("", "_gaussian")}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_P = ctypes.c_void_p
_SIGNATURES = {
    # p0 u y v alpha eps | losses hist cw | theta z delta xg lpart bcs
    "psvi_nested_fwd": [_P] * 15,
    # pT u y cw xb yb eps | loss pbar ubar cwbar zbar | theta z delta xg
    "psvi_nested_outer": [_P] * 16,
    # hist pbar ubar cwbar zbar u y cw v alpha eps | g_u g_v g_alpha g_z |
    # theta thetad z delta zd deltad nlld h gbar pbar mbar nbar cwbar xg bcs
    "psvi_nested_rev": [_P] * 30,
}


def _lib():
    from psvi_torch.ops._build import load_library

    lib = load_library("fused_nested")
    if not getattr(lib, "_psvi_typed", False):
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            # then the plan (_nested_plan), dims, hyper, stream
            fn.argtypes = args + [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_double), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib._psvi_typed = True
    return lib


def _dims(cfg: FusedCfg):
    vals = [cfg.L, cfg.S, cfg.T, cfg.M, cfg.B, int(cfg.parameterised),
            int(cfg.use_alpha), int(cfg.gaussian), *cfg.widths]
    return (ctypes.c_int * len(vals))(*vals)


def _hyper(cfg: FusedCfg, lr: float):
    vals = [cfg.N, cfg.prior_sd, cfg.b1, cfg.b2, cfg.adam_eps, float(lr), cfg.tau]
    return (ctypes.c_double * len(vals))(*vals)


def _check(args):
    """Validate ``(name, tensor, dtype, shape)`` before the pointers reach the
    kernel, which reads exactly these extents: shape, dtype, contiguity, and
    one CUDA device for all."""
    dev = args[0][1].device
    for name, t, dt, shape in args:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
        if t.dtype != dt:
            raise ValueError(f"{name}: expected {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes contiguous tensors")
    for name, t, _, _ in args:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: the CUDA kernel takes tensors on one CUDA device")
    return dev


def _launch(name, dev, args, cfg, lr, plan):
    """Launch ``psvi_<name>`` on ``args`` (tensors, or addresses as ints)
    with its ``plan``."""
    fn = getattr(_lib(), "psvi_" + name)
    ptrs = [_P(a if isinstance(a, int) else a.data_ptr()) for a in args]
    ptrs.append((ctypes.c_int * 4)(plan.blocks, plan.samples_per_block, int(plan.shared),
                                   plan.smem_bytes))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*ptrs, _dims(cfg), _hyper(cfg, lr), _P(stream))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
    LAUNCHES[name + ("_gaussian" if cfg.gaussian else "")] += 1


_F, _I = torch.float32, torch.int32


def _empty(dev, *shape):
    return torch.empty(shape, dtype=_F, device=dev)


def _ydt(cfg):
    """The kernels' target dtype: float32 reals (Gaussian) or int32 labels."""
    return _F if cfg.gaussian else _I


def _inner_args(cfg, u, y, v, alpha, eps_in):
    M = cfg.M
    return [("u", u, _F, (M, cfg.D)), ("y", y, _ydt(cfg), (M,)), ("v", v, _F, (M,)),
            ("alpha", alpha, _F, (1,)), ("eps_in", eps_in, _F, (cfg.T, cfg.n_eps))]


@dataclasses.dataclass(frozen=True)
class NestedPlan:
    """How a dense kernel runs: one cluster of ``blocks``
    blocks, block r holding samples [r·S/C, (r+1)·S/C), at most
    ``samples_per_block``; their θ, maps and per-sample sums in shared
    memory (``shared``) or in the global scratch; ``smem_bytes`` of dynamic
    shared memory a block."""

    blocks: int
    samples_per_block: int
    shared: bool
    smem_bytes: int


def _plan_floats(cfg: FusedCfg, kernel: str):
    """The kernel's shared-memory layout (csrc: nested_fwd_kernel,
    nested_outer_kernel, nested_rev_kernel): floats a block, and floats for
    each sample it holds where the maps live there. nE = E / S elements a
    sample, U units a point."""
    nE, MU = cfg.n_eps // cfg.S, cfg.M * cfg.n_units
    if kernel == "nested_fwd":  # cw; θ, z, δ, G with G·ε
        return (cfg.M + 3) // 4 * 4, 3 * nE + 2 * MU
    if kernel == "nested_outer":  # θ, z and δ over M + B points, p̄ partials, ū_s, NLLs, sums
        return 0, 3 * nE + 2 * (cfg.M + cfg.B) * cfg.n_units + cfg.M * cfg.D + cfg.M + 4
    if kernel == "nested_rev":  # θ, θ̇, z, δ, ż, δ̇, G and Ġ with ·ε, ū_s, the tangent NLL
        return 0, 6 * nE + 4 * MU + cfg.M * cfg.D + cfg.M
    raise ValueError(f"unknown kernel {kernel!r}")


def _nested_plan(cfg: FusedCfg, kernel: str, blocks=None, shared=None) -> NestedPlan:
    """The launch plan of ``nested_fwd``, ``nested_outer`` or ``nested_rev``
    at ``cfg``, from the config alone: as many blocks as the portable
    cluster holds, up to one a sample (min(8, S); at S = 10 two blocks hold
    two samples, and all ran as fast as five blocks of two or faster, the
    owners' slices being smaller), and the maps in shared memory where
    ⌈S/C⌉ samples' fit in SMEM_CAP bytes, else in global scratch. ``blocks``
    and ``shared`` override the choice (to measure other plans)."""
    S = cfg.S
    if blocks is None:
        blocks = min(MAX_CLUSTER, S)
    if not 1 <= blocks <= min(MAX_CLUSTER, S):
        raise ValueError(f"a cluster of {blocks} blocks for S={S}: 1..{min(MAX_CLUSTER, S)}")
    spb = -(-S // blocks)
    fixed, per = _plan_floats(cfg, kernel)
    fits = 4 * (fixed + spb * per) <= SMEM_CAP
    if shared is None:
        shared = fits
    elif shared and not fits:
        raise ValueError(f"{spb} samples' maps of {kernel} do not fit {SMEM_CAP} bytes")
    return NestedPlan(blocks, spb, shared, 4 * (fixed + (spb * per if shared else 0)))


def _scratch(dev, sizes):
    """One float32 workspace holding arrays of ``sizes`` floats end to end:
    the tensor (keep it until the launch is queued) and each array's
    address. An array of size 0 is never touched by the kernel."""
    ws = torch.empty(max(sum(sizes), 1), dtype=_F, device=dev)
    addr, out = ws.data_ptr(), []
    for n in sizes:
        out.append(addr)
        addr += 4 * n
    return ws, out


def _nested_fwd_cuda(p0, u, y, v, alpha, eps_in, lr, cfg):
    dev = _check([("p0", p0, _F, (cfg.n_params,))] + _inner_args(cfg, u, y, v, alpha, eps_in))
    T, P, M, S = cfg.T, cfg.n_params, cfg.M, cfg.S
    plan = _nested_plan(cfg, "nested_fwd")
    out = (_empty(dev, T), _empty(dev, T + 1, 3, P), _empty(dev, M))
    g = 0 if plan.shared else 1  # the maps' global copies, used only outside shared memory
    MU = M * cfg.n_units
    # theta z delta xg lpart bcs
    ws, scratch = _scratch(dev, (g * cfg.n_eps, g * S * MU, g * S * MU, g * 2 * cfg.n_eps,
                                 T * plan.blocks * NWARPS, 2 * T * plan.blocks))
    _launch("nested_fwd", dev, (p0, u, y, v, alpha, eps_in) + out + tuple(scratch), cfg, lr,
            plan)
    return out


def _nested_outer_cuda(pT, u, y, cw, xb, yb, eps_out, cfg):
    M, B, D = cfg.M, cfg.B, cfg.D
    yt = _ydt(cfg)
    dev = _check([("pT", pT, _F, (cfg.n_params,)), ("u", u, _F, (M, D)), ("y", y, yt, (M,)),
                  ("cw", cw, _F, (M,)), ("xb", xb, _F, (B, D)), ("yb", yb, yt, (B,)),
                  ("eps_out", eps_out, _F, (cfg.n_eps,))])
    S, E = cfg.S, cfg.n_eps
    plan = _nested_plan(cfg, "nested_outer")
    out = (_empty(dev), _empty(dev, cfg.n_params), _empty(dev, M, D), _empty(dev, M),
           _empty(dev, M))
    g = 0 if plan.shared else 1  # the maps' global copies, used only outside shared memory
    Z = g * S * (M + B) * cfg.n_units
    # theta z delta | xg: the p̄ partials, ū_s, the pseudo NLLs and the sums
    ws, scratch = _scratch(dev, (g * E, Z, Z, g * (2 * E + S * M * D + S * M + 4 * S)))
    _launch("nested_outer", dev, (pT, u, y, cw, xb, yb, eps_out) + out + tuple(scratch), cfg, 0.0,
            plan)
    return out


def _nested_rev_cuda(hist, pbar, ubar, cwbar, zbar, u, y, cw, v, alpha, eps_in, lr, cfg):
    S, M, P, E = cfg.S, cfg.M, cfg.n_params, cfg.n_eps
    dev = _check([("hist", hist, _F, (cfg.T + 1, 3, P)), ("pbar", pbar, _F, (P,)),
                  ("ubar", ubar, _F, (M, cfg.D)), ("cwbar", cwbar, _F, (M,)),
                  ("zbar", zbar, _F, (M,)), ("cw", cw, _F, (M,))]
                 + _inner_args(cfg, u, y, v, alpha, eps_in))
    plan = _nested_plan(cfg, "nested_rev")
    out = (_empty(dev, M, cfg.D), _empty(dev, M), _empty(dev, 1), _empty(dev, M))
    g = 0 if plan.shared else 1  # the maps' global copies, used only outside shared memory
    Z = g * S * M * cfg.n_units
    # theta thetad z delta zd deltad nlld | h gbar pbar mbar nbar cwbar | xg bcs
    ws, scratch = _scratch(dev, (g * E, g * E, Z, Z, Z, Z, g * S * M, P, P, P, P, P, M,
                                 g * (4 * E + S * M * cfg.D), 2 * cfg.T * plan.blocks))
    _launch("nested_rev", dev,
            (hist, pbar, ubar, cwbar, zbar, u, y, cw, v, alpha, eps_in) + out + tuple(scratch),
            cfg, lr, plan)
    return out


def _labels(y):
    return y if y.dtype == _I else y.to(_I)


def _kernel_targets(y, cfg):
    """The targets as the kernels read them: int32 class labels, or the
    Gaussian targets as a flat row."""
    return y.reshape(-1) if cfg.gaussian else _labels(y)


def nested_fwd(p0, u, y, v, alpha, eps_in, lr: float, cfg: FusedCfg):
    """Kernel 1 wrapper: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if p0.is_cuda:
        return _nested_fwd_cuda(p0, u, _kernel_targets(y, cfg), v, alpha, eps_in, lr, cfg)
    return nested_fwd_torch(p0, u, y, v, alpha, eps_in, lr, cfg)


def nested_outer(pT, u, y, cw, xb, yb, eps_out, cfg: FusedCfg):
    """Kernel 2 wrapper (CUDA kernel for CUDA tensors, plain version on CPU)."""
    if pT.is_cuda:
        return _nested_outer_cuda(pT, u, _kernel_targets(y, cfg), cw, xb,
                                  _kernel_targets(yb, cfg), eps_out, cfg)
    return nested_outer_torch(pT, u, y, cw, xb, yb, eps_out, cfg)


def nested_rev(hist, pbar, ubar, cwbar, zbar, u, y, cw, v, alpha, eps_in, lr: float,
               cfg: FusedCfg):
    """Kernel 3 wrapper (CUDA kernel for CUDA tensors, plain version on CPU)."""
    if hist.is_cuda:
        return _nested_rev_cuda(hist, pbar, ubar, cwbar, zbar, u, _kernel_targets(y, cfg), cw,
                                v, alpha, eps_in, lr, cfg)
    return nested_rev_torch(hist, pbar, ubar, cwbar, zbar, u, y, cw, v, alpha, eps_in, lr,
                            cfg)


# ---------------------------------------------------------------------------
# the composed step
# ---------------------------------------------------------------------------


def _autograd_flat(p0, u, y, v, alpha, xb, yb, eps_in, eps_out, lr, cfg):
    """The oracle: ``_nested_core`` through torch.autograd (create_graph),
    differentiated w.r.t. the Gaussian targets too."""
    net = make_dense(cfg.widths, prior_sd=cfg.prior_sd).to(p0.device)
    didx = [i for i, l in enumerate(net.layers) if isinstance(l, VILinear)]

    def full(dense):
        tree = [{} for _ in net.layers]
        for k, i in enumerate(didx):
            tree[i] = dense[k]
        return tuple(tree)

    def eps_tree(flat):
        return full([{"w": w, "b": b} for w, b in unpack_eps(flat, cfg)])

    gauss = cfg.gaussian
    lik = dict(likelihood=cfg.likelihood, nc=cfg.nc, tau=cfg.tau)
    with torch.enable_grad():
        u_ = u.detach().clone().requires_grad_(True)
        v_ = v.detach().clone().requires_grad_(True)
        a_ = alpha.detach().clone().requires_grad_(True)
        y_ = y.detach().reshape(-1).clone().requires_grad_(gauss)
        cw = core_weights(v_, a_, cfg)
        p = p0.detach().clone().requires_grad_(True)
        m, n = torch.zeros_like(p), torch.zeros_like(p)
        losses = []
        for t in range(1, cfg.T + 1):
            params = full(unpack_params(p, cfg))
            loss_t = elbo.inner_elbo(net, params, eps_tree(eps_in[t - 1]), u_, y_, cw, **lik)
            (g,) = torch.autograd.grad(loss_t, p, create_graph=True)
            p, m, n = _adam(p, m, n, g, t, lr, cfg)
            losses.append(loss_t.detach())
        loss = elbo.psvi_elbo(net, full(unpack_params(p, cfg)), eps_tree(eps_out),
                              u_, y_, cw, xb, yb, cfg.N, **lik)
        wrt = [u_, v_, a_] + ([y_] if gauss else [])
        g_u, g_v, g_a, *g_z = torch.autograd.grad(loss, wrt, allow_unused=True)
    if g_a is None:
        g_a = torch.zeros_like(alpha)
    g_z = g_z[0] if gauss else torch.zeros_like(v)
    return loss.detach(), torch.stack(losses), p.detach(), g_u, g_v, g_a, g_z


def fused_nested_flat(p0, u, v, alpha, z, xb, yb, eps_in, eps_out, lr: float,
                      cfg: FusedCfg, backend=None):
    """The fused step on flat parameters ``p0 (P,)`` and flat noise
    ``eps_in (T, E)``, ``eps_out (E,)``. ``z``/``yb`` are the targets
    (M,)/(B,): class labels, or reals for a Gaussian likelihood. Returns
    ``(loss, inner_losses (T,), pT (P,), g_u (M, D), g_v (M,), g_alpha (1,),
    g_z (M,))``; g_z is zero unless ``cfg.learn_z``, as in the JAX step."""
    if backend is None:
        backend = "cuda" if p0.is_cuda else "torch"
    if backend == "autograd":
        out = _autograd_flat(p0, u, z, v, alpha, xb, yb, eps_in, eps_out, lr, cfg)
        return out[:-1] + (out[-1] if cfg.learn_z else torch.zeros_like(out[-1]),)
    if backend == "torch":
        fwd, outer, rev = nested_fwd_torch, nested_outer_torch, nested_rev_torch
    elif backend == "cuda":
        if not p0.is_cuda:
            raise ValueError("backend='cuda' needs CUDA tensors")
        fwd, outer, rev = nested_fwd, nested_outer, nested_rev
    else:
        raise ValueError(f"unknown backend {backend!r}")
    with torch.no_grad():
        losses, hist, cw = fwd(p0, u, z, v, alpha, eps_in, lr, cfg)
        pT = hist[cfg.T, 0]
        loss, pbar, ubar, cwbar, zbar = outer(pT, u, z, cw, xb, yb, eps_out, cfg)
        g_u, g_v, g_a, g_z = rev(hist, pbar, ubar, cwbar, zbar, u, z, cw, v, alpha, eps_in,
                                 lr, cfg)
    if not cfg.learn_z:
        g_z = torch.zeros_like(g_z)
    return loss, losses, pT, g_u, g_v, g_a, g_z


def fused_nested_outer(params0, u, v, alpha, z, xb, yb, eps_inner, eps_outer, lr: float,
                       cfg: FusedCfg, backend=None):
    """Run the fused nested outer step on the engine's natural layouts.

    params0: L dicts ``mu_w, rho_w (out, in), mu_b, rho_b (out,)``;
    eps_inner: L dicts ``w (T, S, out, in), b (T, S, out)``; eps_outer: L
    dicts ``w (S, out, in), b (S, out)``; z (M,), yb (B,) integer labels;
    v (M,), alpha (1,). ``backend``: ``None`` (CUDA kernels for CUDA
    tensors, the plain versions for CPU tensors), ``"cuda"``, ``"torch"``
    or ``"autograd"``. Returns ``(loss, inner_losses (T,), paramsT (L
    dicts), g_u (M, D), g_v (M,), g_alpha (1,), g_z (M,))``.
    """
    p0 = pack_params(params0)
    e_in = pack_eps(eps_inner, lead=(cfg.T,))
    e_out = pack_eps(eps_outer)
    loss, losses, pT, g_u, g_v, g_a, g_z = fused_nested_flat(
        p0, u, v, alpha, z, xb, yb, e_in, e_out, lr, cfg, backend=backend)
    return loss, losses, unpack_params(pT, cfg), g_u, g_v, g_a, g_z


def supports(engine) -> bool:
    """True when the engine's nested step can run as the fused kernels: an
    all-dense ``VILinear (ReLU VILinear)*`` net with biases, KL counted and
    one prior_sd, float32 compute; a categorical likelihood with hard
    labels, or a Gaussian one with one output, its targets learned or not;
    the plain nested trainer (not truncated, ablated or evaluate-only) with
    inner Adam; and the CUDA design's caps (L ≤ 8, 2 ≤ S ≤ 32,
    S·max(width) ≤ 2048, M + B ≤ 2048). A packed net is not a
    ``Sequential`` and is refused, as in JAX; so are a step under the trial
    runner's vmap, ``shard_mc`` and a sharded batch (JAX
    ``fused_nested.py:553,573-574``)."""
    if engine._in_trial_vmap or engine.shard_mc or engine.data_shard is not None:
        return False
    if engine.state.u.dtype != torch.float32:
        return False
    net = engine.net
    if not isinstance(net, Sequential) or not len(net.layers):
        return False
    layers = list(net.layers)
    for k, layer in enumerate(layers):  # VILinear (ReLU VILinear)*
        if type(layer) is not (VILinear if k % 2 == 0 else ReLU):
            return False
    if type(layers[-1]) is not VILinear:
        return False
    dense = layers[0::2]
    if not all(l.use_bias and l.count_kl and l.compute_dtype == "float32" for l in dense):
        return False
    if not all(l.prior_sd == dense[0].prior_sd for l in dense):
        return False
    widths = [dense[0].in_dim] + [l.out_dim for l in dense]
    S = engine.mc_samples
    return (
        len(dense) <= MAX_LAYERS
        and 2 <= S <= MAX_SAMPLES
        and max(widths) * S <= MAX_WIDTH_X_S
        and engine.num_pseudo + engine.data_minibatch <= MAX_POINTS
        and engine.num_pseudo > 0
        and engine.inner_it >= 1
        and engine.trainer == "nested"
        and not engine.truncated
        and engine.inner_optimizer == "adam"
        and engine.likelihood in ("categorical", "gaussian")
        and (engine.likelihood == "categorical" or widths[-1] == 1)
        # learned Gaussian targets are a plain hypergradient g_z; the
        # categorical soft labels (KLDiv) are not fused
        and not (engine.spec.learn_z and engine.likelihood == "categorical")
        and not engine.spec.ablated
        and not engine.spec.evaluate_only
    )
