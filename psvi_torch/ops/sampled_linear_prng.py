"""Kernel B4: the S-sample variational dense op with its noise drawn inside
the kernels (forward, dx, dparam and the per-sample NKL).

Port of ``psvi_tpu/ops/pallas_vi.py``'s in-kernel-PRNG variant:
``sampled_linear_prng`` (:263; ``_prng_fwd_kernel`` :178, called at :285),
its backward rule ``_prng_bwd_rule`` (:307; ``_prng_dx_kernel`` :194, called
at :317, and ``_prng_dparam_kernel`` :207, called at :330) and
``vi_linear_nkl_prng`` (:362; ``_prng_nkl_kernel`` :240, called at :369).
For every sample s, with ε_s drawn from (seed, s)::

    W_s = μ_w + softplus(ρ_w)·ε_w[s],  b_s = μ_b + softplus(ρ_b)·ε_b[s]
    y_s = x_s·W_sᵀ + b_s
    nkl_s = Σ_layer log N(θ_s; 0, σ_p²) − log N(θ_s; μ, softplus(ρ)²)

The CUDA kernels (``csrc/sampled_linear_prng.cu``) draw ε themselves: it is
never read from or written to device memory. The forward builds each
block's tile of W_s once in shared memory over a split of N
(:func:`_fwd_plan`), with B3's 3xTF32 product loop; dx builds each block's
columns of W_s once over a split of N (:func:`_dx_plan`); dparam
runs as two kernels, ``k_prng_dparam_partial`` (g_sᵀx_s over splits of N,
:func:`_dparam_plan`) and ``k_prng_dparam_reduce`` (the sum over splits in a
fixed order, ε, σ(ρ)), counted as one launch; so does the NKL,
``k_prng_nkl`` (the terms of a tile of 256 elements for a group of samples,
summed over the tile; :func:`_nkl_plan`) and ``k_prng_nkl_reduce`` (each
sample's tiles added in order).

**The noise.** The TPU kernels seed the TPU's own generator with (seed,
sample); those bits cannot be had off the TPU. Here ε is a pure function of
(seed, s, e), where e is the flat index of the parameter in the layer
(o·Din + i for a weight, Dout·Din + o for a bias): Philox4x32-10 keyed with
the seed's 64 bits (low word first; an int32 seed, negative ones included,
maps by two's complement) at the counter (e, s, 0, 0). Philox word 0 gives k1
and word 1 gives k2 (the top 23 bits of each); Box–Muller takes JAX's form
(``pallas_vi.py:163-175``): u1 = k1·2⁻²³ + 2⁻²⁴, u2 = k2·2⁻²³,
ε = √(−2 ln u1)·cos(2π u2). As in JAX, the key carries no layer index: the
caller gives each layer its own seed. :func:`prng_normal` is the plain
generator in torch integer arithmetic; the kernels hold to its words
exactly and to its ε within a few ulps.

:class:`SampledLinearPrng` is the ``torch.autograd.Function`` in place of
JAX's ``custom_vjp``: its forward runs B4a, its backward B4b for dx and B4c
for dμ and dρ; the seed gets no gradient, and it is ``once_differentiable``,
as the ``custom_vjp`` allows one order. :func:`vi_linear_nkl_prng` returns a
value outside the autograd graph on both devices: JAX's NKL function defines
no VJP and no engine needs one. For CUDA tensors the wrappers launch the
kernels; for CPU tensors they run the plain versions.

No engine path calls B4, in JAX or here: ``VILinear.apply`` reaches only B3
(``ops/sampled_linear.py``), so this op's public functions are its path.
"""

from __future__ import annotations

import ctypes
import math
import operator

import torch
from torch.autograd.function import once_differentiable

from psvi_torch.models.layers import softplus
from psvi_torch.ops.elbo import HALF_LOG_2PI
from psvi_torch.ops.fused_nested import _F, _P, _check
from psvi_torch.ops.sampled_linear import (SMS, _cdiv, _fwd_plan, _n_splits,
                                           sampled_linear_reference)
from psvi_torch.utils.resource import launch_counter

#: Launch count of each kernel: its wrapper adds one where it launches it.
LAUNCHES = launch_counter({"prng_fwd": 0, "prng_dx": 0, "prng_dparam": 0, "prng_nkl": 0})

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)  # round multipliers
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)  # Weyl constants that bump the key


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def philox_key(seed):
    """The Philox key (low word, high word) of a seed: an int, a NumPy
    integer or a one-element integer tensor, taken as 64 bits (negative
    seeds by two's complement)."""
    if isinstance(seed, torch.Tensor):
        if seed.numel() != 1 or seed.is_floating_point() or seed.is_complex():
            raise ValueError(f"seed: expected one integer, got a {seed.dtype} tensor "
                             f"of shape {tuple(seed.shape)}")
        seed = seed.item()
    s = operator.index(seed)
    if not -2**63 <= s < 2**64:
        raise ValueError(f"seed {s} does not fit in 64 bits")
    s &= 2**64 - 1
    return s & _M32, s >> 32


def _mulhilo(a: int, b):
    """(high, low) 32-bit words of a·b for a constant a < 2³² and an int64
    tensor b of uint32 values. a·b can reach 2⁶⁴, past int64, so b is split
    into 16-bit halves and each partial product (< 2⁴⁸) is exact."""
    ph, pl = a * (b >> 16), a * (b & 0xFFFF)
    mid = pl + ((ph & 0xFFFF) << 16)
    return (ph >> 16) + (mid >> 32), mid & _M32


def philox4x32(counter, key):
    """Philox4x32-10 on int64 tensors that hold uint32 words: counter
    (..., 4), key (lo, hi) ints → the (..., 4) output words."""
    c0, c1, c2, c3 = counter.unbind(-1)
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack((c0, c1, c2, c3), -1)


def box_muller(w0, w1):
    """Standard normals from two uint32 words (int64 tensors), JAX's form:
    the top 23 bits of each, u1 = k1·2⁻²³ + 2⁻²⁴ (never 0), u2 = k2·2⁻²³."""
    u1 = (w0 >> 9).to(_F) * 2.0**-23 + 2.0**-24
    u2 = (w1 >> 9).to(_F) * 2.0**-23
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)


def prng_normal(seed, S, n, device):
    """The plain generator: ε[s, e] for s < S, e < n as an (S, n) float32
    tensor on ``device``, the same draws as the kernels."""
    e = torch.arange(n, dtype=torch.int64, device=device)
    s = torch.arange(S, dtype=torch.int64, device=device)
    zero = torch.zeros((S, n), dtype=torch.int64, device=device)
    ctr = torch.stack((e.expand(S, n), s[:, None].expand(S, n), zero, zero), -1)
    w = philox4x32(ctr, philox_key(seed))
    return box_muller(w[..., 0], w[..., 1])


def prng_eps(seed, S, Dout, Din, device):
    """The layer's noise as the kernels draw it: ε_w (S, Dout, Din), ε_b (S, Dout)."""
    eps = prng_normal(seed, S, Dout * Din + Dout, device)
    return eps[:, :Dout * Din].reshape(S, Dout, Din), eps[:, Dout * Din:]


# ----------------------------------------------------------------------
# The plain versions, on ε from prng_normal.


def sampled_linear_prng_reference(x, mu_w, rho_w, mu_b, rho_b, seed):
    """B4a's plain version: B3's plain forward on this seed's ε."""
    Dout, Din = mu_w.shape
    eps_w, eps_b = prng_eps(seed, x.shape[0], Dout, Din, x.device)
    return sampled_linear_reference(x, mu_w, rho_w, mu_b, rho_b, eps_w, eps_b)


def prng_dx_reference(g, mu_w, rho_w, seed):
    """B4b's plain version: dx_s = g_s·W_s."""
    Dout, Din = mu_w.shape
    eps_w, _ = prng_eps(seed, g.shape[0], Dout, Din, g.device)
    return torch.bmm(g, mu_w[None] + softplus(rho_w)[None] * eps_w)


def prng_dparam_reference(g, x, rho_w, rho_b, seed):
    """B4c's plain version, JAX's rule (``pallas_vi.py:218-237, 354-355``):
    dμ_w = Σ_s g_sᵀx_s, dρ_w = Σ_s (g_sᵀx_s)·ε_s·σ(ρ_w), and the bias terms
    with Σ_n g in place of g_sᵀx_s."""
    Dout, Din = rho_w.shape
    eps_w, eps_b = prng_eps(seed, g.shape[0], Dout, Din, g.device)
    dw, db = torch.bmm(g.transpose(1, 2), x), g.sum(1)
    return (dw.sum(0), (dw * eps_w).sum(0) * torch.sigmoid(rho_w),
            db.sum(0), (db * eps_b).sum(0) * torch.sigmoid(rho_b))


def vi_linear_nkl_prng_reference(mu_w, rho_w, mu_b, rho_b, seed, mc_samples, prior_sd=1.0):
    """B4d's plain version: per sample, Σ over the layer of lp − lq with
    θ = μ + sd·ε, as ``pallas_vi.py:249-254`` writes the two densities."""
    Dout, Din = mu_w.shape
    eps = prng_normal(seed, mc_samples, Dout * Din + Dout, mu_w.device)
    mu = torch.cat((mu_w.reshape(-1), mu_b))
    sd = softplus(torch.cat((rho_w.reshape(-1), rho_b)))
    sp = torch.tensor(prior_sd, dtype=_F, device=mu.device)
    lp = -0.5 * torch.square((mu + sd * eps) / sp) - torch.log(sp) - HALF_LOG_2PI
    lq = -0.5 * torch.square(eps) - torch.log(sd) - HALF_LOG_2PI
    return (lp - lq).sum(1)


# ----------------------------------------------------------------------
# The launch plans of B4b, B4c and B4d: plain functions of the shape, so that
# a rerun launches the same grid and gives the same bits (B4a's, _fwd_plan,
# is B3's, in ops/sampled_linear.py).

#: Output tile of dparam's pass 1 (both sides) and input columns of a dx block.
DPARAM_TILE = DX_TILE = 64
#: Fewest points a split of N keeps (dx: one 64-point tile).
DPARAM_MIN_POINTS, DX_MIN_POINTS = 32, 64
#: Most points a split of dparam's pass 1 walks: a sweep of its split count
#: on an H100 found longer splits slower at fc1 and at N = 1024 (PERF.md).
DPARAM_MAX_POINTS = 256
#: Blocks each plan's grid reaches where N allows: dparam one wave; dx one
#: and a half, where the same sweep found its time lowest at fc1 and at
#: N = 1024.
DPARAM_BLOCKS, DX_BLOCKS = SMS, 3 * SMS // 2
#: Most splits of dx: they form one thread block cluster, at most 8 blocks.
DX_MAX_SPLITS = 8
#: Elements of an NKL tile (a thread each), and the blocks the NKL's grid
#: reaches where S allows: one wave of eight 256-thread blocks an SM.
NKL_TILE, NKL_BLOCKS = 256, 8 * SMS


def _dparam_plan(S, N, Din, Dout):
    """Splits of N for ``k_prng_dparam_partial``, whose grid is
    (Din + 1) / 64 × Dout / 64 × S·n_splits."""
    return _n_splits(_cdiv(Din + 1, DPARAM_TILE) * _cdiv(Dout, DPARAM_TILE) * S, N,
                     DPARAM_MIN_POINTS, DPARAM_BLOCKS, max_points=DPARAM_MAX_POINTS)


def _dx_plan(S, N, Din, Dout):
    """Splits of N for ``k_prng_dx``, whose grid is Din / 64 × n_splits × S
    in clusters of n_splits blocks."""
    return _n_splits(_cdiv(Din, DX_TILE) * S, N, DX_MIN_POINTS, DX_BLOCKS, DX_MAX_SPLITS)


def _nkl_plan(S, Din, Dout):
    """``k_prng_nkl``'s grid, tiles × groups: (tiles, groups, samples a
    group). A tile is NKL_TILE of the Dout·(Din + 1) elements; the groups are
    the fewest (at most S) whose grid reaches NKL_BLOCKS blocks, the samples
    dealt evenly, group g holding [g·spg, min(S, (g + 1)·spg))."""
    tiles = _cdiv(Dout * (Din + 1), NKL_TILE)
    spg = _cdiv(S, min(S, _cdiv(NKL_BLOCKS, tiles)))
    return tiles, _cdiv(S, spg), spg


def _nkl_scratch_shape(S, Din, Dout):
    """Pass 1's partial sums part[s][tile]."""
    return (S, _nkl_plan(S, Din, Dout)[0])


def _split_bounds(N, n_splits, unit=1):
    """[n0, n1) of each split as the kernels cut N: dparam's as evenly as
    points allow (``unit`` 1), dx's in whole 64-point tiles (``unit`` 64)."""
    units = _cdiv(N, unit)
    return [(min(N, unit * (k * units // n_splits)), min(N, unit * ((k + 1) * units // n_splits)))
            for k in range(n_splits)]


def _dparam_scratch_shape(S, N, Din, Dout):
    """Pass 1's partial products part[s][k][o][i], i ≤ Din (the bias column)."""
    return (S, _dparam_plan(S, N, Din, Dout), Dout, Din + 1)


# ----------------------------------------------------------------------
# The CUDA wrappers.


def _lib():
    from psvi_torch.ops._build import load_library

    lib = load_library("sampled_linear_prng")
    if not getattr(lib, "_psvi_typed", False):
        i, u = ctypes.c_int, ctypes.c_uint32
        key = [u, u]
        # tensors | S N Din Dout (fwd, dx, dparam: and n_splits; nkl: S Din
        # Dout spg, prior_sd; bits: n) | key | stream
        lib.psvi_philox_bits.argtypes = [_P, _P, i, u, u, _P]
        lib.psvi_prng_fwd.argtypes = [_P] * 6 + [i] * 5 + key + [_P]
        lib.psvi_prng_dx.argtypes = [_P] * 4 + [i] * 5 + key + [_P]
        lib.psvi_prng_dparam.argtypes = [_P] * 9 + [i] * 5 + key + [_P]
        lib.psvi_prng_nkl.argtypes = [_P] * 6 + [i] * 4 + [ctypes.c_float] + key + [_P]
        for fn in ("psvi_philox_bits", "psvi_prng_fwd", "psvi_prng_dx", "psvi_prng_dparam",
                   "psvi_prng_nkl"):
            getattr(lib, fn).restype = ctypes.c_int
        lib._psvi_typed = True
    return lib


def _layer_key(seed, Dout, Din):
    """The seed's key, once the layer's flat indices e fit the 32-bit counter."""
    if Dout * Din + Dout > _M32:
        raise ValueError(f"a {Dout}x{Din} layer has more parameters than the 32-bit "
                         "counter word indexes")
    return philox_key(seed)


def _launch(name, dev, tensors, scalars, key):
    """Launch ``psvi_<name>`` on ``dev``'s current stream with the tensors'
    pointers, the scalars and the key (the tensors checked by the caller);
    raise on a launch error."""
    fn = getattr(_lib(), "psvi_" + name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*[_P(t.data_ptr()) for t in tensors], *scalars, *key, _P(stream))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
    if name in LAUNCHES:
        LAUNCHES[name] += 1


def _philox_bits_cuda(counter, key):
    """Raw Philox4x32-10 words of the kernels' generator for an (n, 4) int32
    counter tensor (uint32 words, two's complement) and a key (lo, hi) →
    (n, 4) int32. For holding the generator to :func:`philox4x32` bit for
    bit."""
    n = counter.shape[0]
    dev = _check([("counter", counter, torch.int32, (n, 4))])
    out = torch.empty((n, 4), dtype=torch.int32, device=dev)
    _launch("philox_bits", dev, [counter, out], (n,), key)
    return out


def _prng_fwd_cuda(x, mu_w, rho_w, mu_b, rho_b, seed):
    """B4a: y (S, N, Dout), over :func:`_fwd_plan`'s splits of N."""
    S, N, Din = x.shape
    Dout = mu_w.shape[0]
    key = _layer_key(seed, Dout, Din)
    dev = _check([("x", x, _F, (S, N, Din)), ("mu_w", mu_w, _F, (Dout, Din)),
                  ("rho_w", rho_w, _F, (Dout, Din)), ("mu_b", mu_b, _F, (Dout,)),
                  ("rho_b", rho_b, _F, (Dout,))])
    y = torch.empty((S, N, Dout), dtype=_F, device=dev)
    _launch("prng_fwd", dev, [x, mu_w, rho_w, mu_b, rho_b, y],
            (S, N, Din, Dout, _fwd_plan(S, N, Din, Dout)), key)
    return y


def _prng_dx_cuda(g, mu_w, rho_w, seed):
    """B4b: dx (S, N, Din), over :func:`_dx_plan`'s splits of N."""
    S, N, Dout = g.shape
    Din = mu_w.shape[1]
    key = _layer_key(seed, Dout, Din)
    dev = _check([("g", g, _F, (S, N, Dout)), ("mu_w", mu_w, _F, (Dout, Din)),
                  ("rho_w", rho_w, _F, (Dout, Din))])
    dx = torch.empty((S, N, Din), dtype=_F, device=dev)
    _launch("prng_dx", dev, [g, mu_w, rho_w, dx],
            (S, N, Din, Dout, _dx_plan(S, N, Din, Dout)), key)
    return dx


def _prng_dparam_cuda(g, x, rho_w, rho_b, seed):
    """B4c: dμ_w, dρ_w (Dout, Din), dμ_b, dρ_b (Dout,), σ(ρ) applied. One
    call is two kernels, ``k_prng_dparam_partial`` (P over
    :func:`_dparam_plan`'s splits of N, into a scratch of
    :func:`_dparam_scratch_shape`) and ``k_prng_dparam_reduce``; it counts
    as one launch of ``prng_dparam``."""
    S, N, Dout = g.shape
    Din = x.shape[2]
    key = _layer_key(seed, Dout, Din)
    dev = _check([("g", g, _F, (S, N, Dout)), ("x", x, _F, (S, N, Din)),
                  ("rho_w", rho_w, _F, (Dout, Din)), ("rho_b", rho_b, _F, (Dout,))])
    outs = [torch.empty(shape, dtype=_F, device=dev)
            for shape in ((Dout, Din), (Dout, Din), (Dout,), (Dout,))]
    part_shape = _dparam_scratch_shape(S, N, Din, Dout)
    part = torch.empty(part_shape, dtype=_F, device=dev)
    _launch("prng_dparam", dev, [g, x, rho_w, rho_b, *outs, part],
            (S, N, Din, Dout, part_shape[1]), key)
    return tuple(outs)


def _prng_nkl_cuda(mu_w, rho_w, mu_b, rho_b, seed, mc_samples, prior_sd=1.0):
    """B4d: nkl (mc_samples,). One call is two kernels, ``k_prng_nkl`` (over
    :func:`_nkl_plan`'s tiles × groups, into a scratch of
    :func:`_nkl_scratch_shape`) and ``k_prng_nkl_reduce``; it counts as one
    launch of ``prng_nkl``."""
    Dout, Din = mu_w.shape
    key = _layer_key(seed, Dout, Din)
    dev = _check([("mu_w", mu_w, _F, (Dout, Din)), ("rho_w", rho_w, _F, (Dout, Din)),
                  ("mu_b", mu_b, _F, (Dout,)), ("rho_b", rho_b, _F, (Dout,))])
    out = torch.empty((mc_samples,), dtype=_F, device=dev)
    if mc_samples <= 0:
        return out
    part = torch.empty(_nkl_scratch_shape(mc_samples, Din, Dout), dtype=_F, device=dev)
    _launch("prng_nkl", dev, [mu_w, rho_w, mu_b, rho_b, out, part],
            (mc_samples, Din, Dout, _nkl_plan(mc_samples, Din, Dout)[2], float(prior_sd)), key)
    return out


# ----------------------------------------------------------------------
# The op.


class SampledLinearPrng(torch.autograd.Function):
    """``(x, μ_w, ρ_w, μ_b, ρ_b, seed) → y``: B4a forward; B4b (dx) and B4c
    (dμ, dρ) backward; the plain versions for CPU tensors."""

    @staticmethod
    def forward(ctx, x, mu_w, rho_w, mu_b, rho_b, seed):
        ctx.save_for_backward(x, mu_w, rho_w, rho_b)
        ctx.seed = seed
        if x.is_cuda:
            return _prng_fwd_cuda(x, mu_w, rho_w, mu_b, rho_b, seed)
        return sampled_linear_prng_reference(x, mu_w, rho_w, mu_b, rho_b, seed)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, mu_w, rho_w, rho_b = ctx.saved_tensors
        g, needs = g.contiguous(), ctx.needs_input_grad
        dx, dparams = None, (None,) * 4
        if needs[0]:
            dx = (_prng_dx_cuda if g.is_cuda else prng_dx_reference)(g, mu_w, rho_w, ctx.seed)
        if any(needs[1:5]):
            dparams = (_prng_dparam_cuda if g.is_cuda else prng_dparam_reference)(
                g, x, rho_w, rho_b, ctx.seed)
        return (dx, *(d if need else None for d, need in zip(dparams, needs[1:5])), None)


def sampled_linear_prng(x, mu_w, rho_w, mu_b, rho_b, seed, tile_n: int = 512):
    """Forward with the noise drawn in the kernel, with JAX's signature:
    y_s = x_s·(μ_w + softplus(ρ_w)·ε_w(seed, s))ᵀ + μ_b + softplus(ρ_b)·ε_b(seed, s).
    x (S, N, Din), μ_w/ρ_w (Dout, Din), μ_b/ρ_b (Dout,) → (S, N, Dout).

    ``seed`` is an integer (or a one-element integer tensor); use
    :func:`vi_linear_nkl_prng` with the same seed for the matching
    log p(θ) − log q(θ). ``tile_n`` is JAX's N tile, kept for the
    signature: ε does not depend on it, and the CUDA kernels use their own
    tiles."""
    return SampledLinearPrng.apply(x.contiguous(), mu_w.contiguous(), rho_w.contiguous(),
                                   mu_b.contiguous(), rho_b.contiguous(), seed)


def vi_linear_nkl_prng(mu_w, rho_w, mu_b, rho_b, seed, mc_samples, prior_sd: float = 1.0):
    """Per-sample log p(θ_s) − log q(θ_s) with the ε that
    :func:`sampled_linear_prng` draws for the same seed → (mc_samples,). A
    value outside the autograd graph (no gradient), as JAX's defines no VJP."""
    with torch.no_grad():
        args = (mu_w.contiguous(), rho_w.contiguous(), mu_b.contiguous(), rho_b.contiguous(),
                seed, mc_samples, prior_sd)
        if mu_w.is_cuda:
            return _prng_nkl_cuda(*args)
        return vi_linear_nkl_prng_reference(*args)
