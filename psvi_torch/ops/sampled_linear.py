"""Kernel B3: the fused S-sample variational dense forward.

Port of ``psvi_tpu/ops/pallas_vi.py``'s ``sampled_linear`` (the forward
kernel ``_fwd_kernel`` :57, called at :84) and its plain reference
``sampled_linear_reference`` (:119-123). For every sample s::

    W_s = μ_w + softplus(ρ_w)·ε_w[s],  b_s = μ_b + softplus(ρ_b)·ε_b[s]
    y_s = x_s·W_sᵀ + b_s

x (S, N, Din), μ_w/ρ_w (Dout, Din), μ_b/ρ_b (Dout,), ε_w (S, Dout, Din),
ε_b (S, Dout) → y (S, N, Dout), all float32. The CUDA kernel
(``csrc/sampled_linear.cu``, on the block and 3xTF32 product loop of
``csrc/sampled_linear_gemm.cuh`` that B4a shares) builds each block's W_s
tile once in shared memory over a split of N (:func:`_fwd_plan`) and never
writes the (S, Dout, Din) sampled weights to device memory, as the TPU
kernel keeps them in VMEM.

:class:`SampledLinear` is the ``torch.autograd.Function`` in place of the
JAX ``custom_vjp``: the forward launches the kernel for CUDA tensors and
runs the plain version for CPU tensors; the backward is JAX's ``_bwd``
(:131-142) written out in torch products, as JAX computes it in XLA outside
any kernel. ε gets no gradient. The backward is ``once_differentiable``: a
double backward raises, as the ``custom_vjp`` refuses one, so the layer
serves the first-order paths only (the joint and alternating trainers, the
retrain loop, evaluation). The in-kernel-PRNG variant, B4, which draws ε
inside its kernels, is ``ops/sampled_linear_prng.py``
(``csrc/sampled_linear_prng.cu``).
"""

from __future__ import annotations

import collections
import ctypes

import torch
from torch.autograd.function import once_differentiable

from psvi_torch.models.layers import softplus
from psvi_torch.ops.fused_nested import _F, _P, _check
from psvi_torch.utils.resource import launch_counter

#: Launch count of the kernel: its wrapper adds one where it launches it,
#: and one to ``LAUNCH_SHAPES[(S, N, Din, Dout)]``, so a run shows which
#: layers went through it.
LAUNCHES = launch_counter({"sampled_linear": 0})
LAUNCH_SHAPES: collections.Counter = launch_counter(collections.Counter())


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCH_SHAPES.clear()


# ----------------------------------------------------------------------
# Launch plans: plain functions of the shape, so that a rerun launches the
# same grid and gives the same bits. The forward's is here, where B3 and
# B4a (``ops/sampled_linear_prng.py``, which imports this module) both
# reach it; B4's backward plans are beside their kernels.

#: SMs of an H100 SXM: a wave of blocks, one on each.
SMS = 132
#: Outputs of a forward block.
FWD_OUT_TILE = 32
#: Fewest points a split of the forward keeps: one 64-point tile.
FWD_MIN_POINTS = 64
#: Blocks the forward's grid reaches where N allows, before the splits are
#: evened out: two and a half waves of two blocks a SM. A sweep of the split
#: count on an H100 (``scripts/torch_b4_backward_sweep.py``, PERF.md) found
#: the forward's time set by the most 64-point tiles a split walks; B4a's
#: clusters of 6 or 7 blocks slower than of 8 at N = 1024 (the cap binds
#: there); and at S = 64, N = 2048, where this target binds, its 2 splits
#: faster than 8 (5 % for B3, 10 % for B4a): more splits than fill the card
#: only build each W_s tile again.
FWD_BLOCKS = 5 * SMS // 2
#: Most splits of the forward: B4a's form one thread block cluster, at most 8.
FWD_MAX_SPLITS = 8


def _cdiv(a, b):
    return -(-a // b)


def _n_splits(blocks_per_split, N, min_points, blocks, most=None, max_points=None):
    """The fewest splits of N whose grid, ``blocks_per_split`` blocks a
    split, reaches ``blocks`` and whose splits hold at most ``max_points``
    points, with at least ``min_points`` points in every split (one split
    where N has fewer) and at most ``most`` splits."""
    cap = max(1, min(most or N, N // min_points))
    want = _cdiv(blocks, max(1, blocks_per_split))
    if max_points is not None:
        want = max(want, _cdiv(N, max_points))
    return max(1, min(cap, want))


def _fwd_plan(S, N, Din, Dout):
    """Splits of N for the forward kernels (B3's ``k_sampled_linear`` and
    B4a's ``k_prng_fwd``), whose grid is Dout / 32 × n_splits × S; B4a's
    n_splits blocks of one (output tile, sample) form a cluster. The splits
    that reach ``FWD_BLOCKS``, then the fewest that keep their most 64-point
    tiles a split: a block walks its split's tiles one after another, so a
    split with one tile more than the others sets the time (6 tiles over 5
    splits take as long as over 3)."""
    ns = _n_splits(_cdiv(Dout, FWD_OUT_TILE) * S, N, FWD_MIN_POINTS, FWD_BLOCKS,
                   FWD_MAX_SPLITS)
    tiles = _cdiv(N, FWD_MIN_POINTS)
    return _cdiv(tiles, _cdiv(tiles, ns))


def sampled_linear_reference(x, mu_w, rho_w, mu_b, rho_b, eps_w, eps_b):
    """The plain version (JAX ``sampled_linear_reference``): the sampled
    weights materialised, one batched product."""
    w = mu_w[None] + softplus(rho_w)[None] * eps_w
    b = mu_b[None] + softplus(rho_b)[None] * eps_b
    return torch.matmul(x, w.transpose(1, 2)) + b[:, None, :]


def _lib():
    from psvi_torch.ops._build import load_library

    lib = load_library("sampled_linear")
    if not getattr(lib, "_psvi_typed", False):
        # x mu_w rho_w mu_b rho_b eps_w eps_b | y | S N Din Dout n_splits | stream
        lib.psvi_sampled_linear.argtypes = [_P] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.psvi_sampled_linear.restype = ctypes.c_int
        lib._psvi_typed = True
    return lib


def _sampled_linear_cuda(x, mu_w, rho_w, mu_b, rho_b, eps_w, eps_b):
    """Launch the kernel on the current stream over :func:`_fwd_plan`'s
    splits of N. x usually arrives as a non-contiguous view (``torch.cat``
    rows, ``Flatten``), so every input is made contiguous first; any dtype
    other than float32 raises."""
    S, N, Din = x.shape
    Dout = mu_w.shape[0]
    args = [(name, t.contiguous(), _F, shape) for name, t, shape in (
        ("x", x, (S, N, Din)), ("mu_w", mu_w, (Dout, Din)), ("rho_w", rho_w, (Dout, Din)),
        ("mu_b", mu_b, (Dout,)), ("rho_b", rho_b, (Dout,)), ("eps_w", eps_w, (S, Dout, Din)),
        ("eps_b", eps_b, (S, Dout)))]
    dev = _check(args)
    y = torch.empty((S, N, Dout), dtype=_F, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.psvi_sampled_linear(*[_P(a[1].data_ptr()) for a in args], _P(y.data_ptr()),
                                     S, N, Din, Dout, _fwd_plan(S, N, Din, Dout), _P(stream))
    if rc != 0:
        raise RuntimeError(f"sampled_linear kernel launch failed with CUDA error {rc}")
    LAUNCHES["sampled_linear"] += 1
    LAUNCH_SHAPES[(S, N, Din, Dout)] += 1
    return y


def _bwd(g, x, mu_w, rho_w, mu_b, rho_b, eps_w, eps_b, needs):
    """JAX ``_bwd`` (pallas_vi.py:131-142) for the inputs in ``needs``:
    dx = g·W_s, dμ_w = Σ_s gᵀx, dρ_w = Σ_s (gᵀx)·ε_w·σ(ρ_w), and the bias
    terms; None for ε."""
    dx = dmu_w = drho_w = dmu_b = drho_b = None
    if needs[0]:
        w = mu_w[None] + softplus(rho_w)[None] * eps_w
        dx = torch.bmm(g, w)
    if needs[1] or needs[2]:
        dw = torch.bmm(g.transpose(1, 2), x)  # per-sample weight gradients (S, Dout, Din)
        dmu_w = dw.sum(0) if needs[1] else None
        drho_w = (dw * eps_w).sum(0) * torch.sigmoid(rho_w) if needs[2] else None
    if needs[3] or needs[4]:
        db = g.sum(1)  # (S, Dout)
        dmu_b = db.sum(0) if needs[3] else None
        drho_b = (db * eps_b).sum(0) * torch.sigmoid(rho_b) if needs[4] else None
    return dx, dmu_w, drho_w, dmu_b, drho_b, None, None


class SampledLinear(torch.autograd.Function):
    """``(x, μ_w, ρ_w, μ_b, ρ_b, ε_w, ε_b) → y``: the kernel (CUDA tensors)
    or the plain version (CPU tensors) forward, JAX's ``_bwd`` backward."""

    @staticmethod
    def forward(ctx, x, mu_w, rho_w, mu_b, rho_b, eps_w, eps_b):
        ctx.save_for_backward(x, mu_w, rho_w, mu_b, rho_b, eps_w, eps_b)
        if x.is_cuda:
            return _sampled_linear_cuda(x, mu_w, rho_w, mu_b, rho_b, eps_w, eps_b)
        return sampled_linear_reference(x, mu_w, rho_w, mu_b, rho_b, eps_w, eps_b)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _bwd(g.contiguous(), *ctx.saved_tensors, ctx.needs_input_grad)


def sampled_linear(x, mu_w, rho_w, mu_b, rho_b, eps_w, eps_b):
    """Fused S-sample variational dense forward, with JAX's signature:
    x (S, N, Din), μ_w/ρ_w (Dout, Din), μ_b/ρ_b (Dout,), ε_w (S, Dout, Din),
    ε_b (S, Dout) → (S, N, Dout)."""
    return SampledLinear.apply(x, mu_w, rho_w, mu_b, rho_b, eps_w, eps_b)
