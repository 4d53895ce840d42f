"""Kernel B3's module (``psvi_torch/ops/sampled_linear.py``) and the dense
backend against the JAX package, on the CPU.

- The plain forward matches JAX's ``sampled_linear`` (off the TPU its
  reference forward under the ``custom_vjp``) at ``tests/test_pallas.py``'s
  ``_args`` shapes and at ragged LeNet-like shapes;
- the Function's backward matches ``jax.grad`` through the ``custom_vjp``
  (JAX's ``_bwd``) on dx, dμ_w, dρ_w, dμ_b and dρ_b; ε gets no gradient; a
  double backward raises;
- ``VILinear(backend="pallas")`` matches ``backend="xla"`` and JAX's
  ``VILinear(backend="pallas")``; a 2-D input never enters the Function;
- ``with_dense_backend`` returns a copy, leaves convolutions alone and
  refuses an unknown backend;
- the CUDA wrapper checks what it is given before any pointer is passed.

The kernel itself runs only on the card: ``chip_smoke.py`` holds it against
the plain version there.
"""

import torch_threads  # noqa: F401  (torch on this worker's share of the cores)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psvi_torch.models.layers import (VIConv2d, VIConvPool2d, VILinear, fuse_conv_pool,
                                      with_dense_backend)
from psvi_torch.models.networks import make_lenet, set_up_model
from psvi_torch.ops import sampled_linear as SL
from psvi_tpu.models.layers import VILinear as JVILinear
from psvi_tpu.ops import pallas_vi as PV

RHO0 = float(np.log(np.expm1(1e-3)))  # softplus⁻¹(1e-3), the engine's init_sd

# (S, N, Din, Dout): tests/test_pallas.py:21's _args, then ragged LeNet-like
# shapes (fc1 400→120 and fc3 84→10 at N = 19)
SHAPES = [(6, 64, 32, 16), (3, 19, 400, 120), (3, 19, 84, 10)]


def _args(S, N, Din, Dout, seed=0):
    """x, μ_w, ρ_w, μ_b, ρ_b, ε_w, ε_b as float32 numpy, ρ near softplus⁻¹(1e-3)
    with a jitter."""
    rng = np.random.default_rng(seed)
    b = 1.0 / np.sqrt(Din)
    a = (rng.standard_normal((S, N, Din)), rng.uniform(-b, b, (Dout, Din)),
         RHO0 + 0.3 * rng.standard_normal((Dout, Din)), rng.uniform(-b, b, Dout),
         RHO0 + 0.3 * rng.standard_normal(Dout), rng.standard_normal((S, Dout, Din)),
         rng.standard_normal((S, Dout)))
    return [x.astype(np.float32) for x in a]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_matches_jax(shape):
    a = _args(*shape)
    y_j = np.asarray(PV.sampled_linear(*map(jnp.asarray, a)))
    y_t = SL.sampled_linear(*map(torch.from_numpy, a)).numpy()
    assert y_t.shape == (shape[0], shape[1], shape[3])
    np.testing.assert_allclose(y_t, y_j, rtol=1e-5, atol=2e-5)
    y_r = SL.sampled_linear_reference(*map(torch.from_numpy, a)).numpy()
    np.testing.assert_array_equal(y_t, y_r)


def _port_grads(a):
    """dx, dμ_w, dρ_w, dμ_b, dρ_b of Σ sin(y) through the Function, and the
    gradients of ε (None: ε gets none)."""
    t = [torch.from_numpy(x).requires_grad_(True) for x in a]
    loss = torch.sin(SL.sampled_linear(*t)).sum()
    return torch.autograd.grad(loss, t, allow_unused=True)


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_matches_jax_bwd(shape):
    a = _args(*shape, seed=1)
    g_j = jax.grad(lambda *x: jnp.sum(jnp.sin(PV.sampled_linear(*x))),
                   argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, a))
    g_t = _port_grads(a)
    # rtol 1e-4, and atol 1e-6 of the gradient's largest entry: each entry
    # sums S·N (dμ, dρ) or Dout (dx) fp32 products of that scale in another
    # order, so an entry that cancels to near zero keeps an absolute error
    for name, x, y in zip(("dx", "dmu_w", "drho_w", "dmu_b", "drho_b"), g_t, g_j):
        y = np.asarray(y)
        np.testing.assert_allclose(x.numpy(), y, rtol=1e-4, atol=1e-6 * np.abs(y).max(),
                                   err_msg=name)
    assert g_t[5] is None and g_t[6] is None


def test_backward_computes_only_what_is_asked():
    a = [torch.from_numpy(x) for x in _args(2, 5, 6, 3)]
    x = a[0].clone().requires_grad_(True)
    (gx,) = torch.autograd.grad(SL.sampled_linear(x, *a[1:]).sum(), [x])
    w = a[1][None] + SL.softplus(a[2])[None] * a[5]
    torch.testing.assert_close(gx, w.sum(1)[:, None, :].expand_as(x), rtol=1e-5, atol=1e-6)


def test_double_backward_raises():
    a = [torch.from_numpy(x).requires_grad_(True) for x in _args(2, 5, 6, 3)]
    loss = torch.sin(SL.sampled_linear(*a)).sum()
    (gx,) = torch.autograd.grad(loss, [a[0]], create_graph=True)
    with pytest.raises(RuntimeError, match="twice"):
        gx.sum().backward()


def test_vilinear_pallas_matches_xla_and_jax():
    """tests/test_pallas.py:128-141 at the port: the same layer, params,
    noise and input through both backends, and through JAX's layer."""
    rng = np.random.default_rng(2)
    layer = JVILinear(12, 8, init_sd=0.05, backend="pallas")
    params = jax.tree_util.tree_map(np.array, layer.init(jax.random.PRNGKey(0)))
    eps = {"w": rng.standard_normal((5, 8, 12)).astype(np.float32),
           "b": rng.standard_normal((5, 8)).astype(np.float32)}
    x = rng.standard_normal((5, 32, 12)).astype(np.float32)
    y_j = np.asarray(layer.apply(params, eps, jnp.asarray(x)))
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    te = {k: torch.from_numpy(v) for k, v in eps.items()}
    y = {b: VILinear(12, 8, init_sd=0.05, backend=b).apply(tp, te, torch.from_numpy(x)).numpy()
         for b in ("xla", "pallas")}
    np.testing.assert_allclose(y["pallas"], y["xla"], rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(y["pallas"], y_j, rtol=1e-5, atol=2e-5)


def test_2d_input_does_not_enter_the_function(monkeypatch):
    calls = []
    apply = SL.SampledLinear.apply
    monkeypatch.setattr(SL.SampledLinear, "apply",
                        lambda *a: calls.append(a[0].shape) or apply(*a))
    layer = VILinear(4, 3, backend="pallas")
    gen = torch.Generator().manual_seed(0)
    p, e = layer.init(gen), layer.sample_eps(gen, 2)
    assert layer.apply(p, e, torch.randn(7, 4)).shape == (2, 7, 3)
    assert calls == []
    assert layer.apply(p, e, torch.randn(2, 7, 4)).shape == (2, 7, 3)
    assert calls == [(2, 7, 4)]
    # no bias: the plain product, as JAX's condition (layers.py:154-157)
    nobias = VILinear(4, 3, backend="pallas", use_bias=False)
    nobias.apply(nobias.init(gen), nobias.sample_eps(gen, 2), torch.randn(2, 7, 4))
    assert calls == [(2, 7, 4)]


def test_with_dense_backend():
    """tests/test_round2_features.py:27-41 at the port."""
    net = set_up_model("fn", 2, 8, 2, 1e-3)
    net2 = with_dense_backend(net, "pallas")
    dense = [l for l in net2.layers if isinstance(l, VILinear)]
    assert dense and all(l.backend == "pallas" for l in dense)
    assert all(l.backend == "xla" for l in net.layers if isinstance(l, VILinear))
    assert net2 is not net and all(a is not b for a, b in zip(net.layers, net2.layers))
    with pytest.raises(ValueError, match="backend"):
        with_dense_backend(net, "cuda")
    lenet = with_dense_backend(fuse_conv_pool(make_lenet()), "pallas")
    convs = [l for l in lenet.layers if isinstance(l, VIConv2d)]
    assert len(convs) == 2 and all(type(l) is VIConvPool2d for l in convs)
    assert not any(hasattr(l, "backend") for l in convs)
    assert [l.backend for l in lenet.layers if isinstance(l, VILinear)] == ["pallas"] * 3


@pytest.mark.parametrize("bad,match", [
    (None, "one CUDA device"),
    ("dtype", "x: expected torch.float32"),
    ("shape", "eps_w: expected shape"),
])
def test_cuda_wrapper_validates(bad, match):
    """The wrapper checks shapes, dtypes and the device before any pointer
    reaches the kernel; a correct CPU call gets as far as the device check."""
    a = [torch.from_numpy(x) for x in _args(2, 5, 6, 3)]
    if bad == "dtype":
        a[0] = a[0].double()
    elif bad == "shape":
        a[5] = a[5][:, :2]
    with pytest.raises(ValueError, match=match):
        SL._sampled_linear_cuda(*a)
    assert SL.LAUNCHES["sampled_linear"] == 0


# ----------------------------------------------------------------------
# The forward kernels' product (B3's k_sampled_linear and B4a's k_prng_fwd,
# csrc/sampled_linear_gemm.cuh) runs as 3xTF32 on the tensor cores. Its
# arithmetic, emulated here on the CPU (nowhere else: no path runs it),
# against float64.

def _tf32(a):
    """cvt.rna.tf32.f32 on a float32 tensor: round to 10 stored mantissa
    bits, ties away from zero (add half of the dropped bits' range to the
    magnitude, then clear the low 13 bits)."""
    return ((a.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _emulated_product(x, w, passes):
    """y = x·wᵀ as the kernel forms it, x (S, N, Din), w (S, Dout, Din) float32:
    each operand split a = hi + lo (hi = tf32(a), lo = tf32(a − hi)); for
    each 8 columns of Din, one m16n8k8 step a pass, its 8 products summed
    exactly and added to an fp32 accumulator with one rounding (small gets
    hi·lo and lo·hi, big hi·hi); then big + small. ``passes`` 1 is one plain
    TF32 pass (big alone)."""
    xh, wh = _tf32(x), _tf32(w)
    xl, wl = _tf32(x - xh), _tf32(w - wh)
    big = torch.zeros(x.shape[0], x.shape[1], w.shape[1], dtype=torch.float32)
    small = torch.zeros_like(big)

    def step(acc, a, b, k):
        part = torch.bmm(a[..., k:k + 8].double(), b[..., k:k + 8].double().transpose(1, 2))
        return (acc.double() + part).float()

    for k in range(0, x.shape[2], 8):
        if passes == 3:
            small = step(small, xh, wl, k)
            small = step(small, xl, wh, k)
        big = step(big, xh, wh, k)
    return big + small


@pytest.mark.parametrize("shape", [(10, 356, 400, 120), (10, 356, 120, 84), (10, 356, 84, 10),
                                   (10, 1024, 400, 120)], ids=["fc1", "fc2", "fc3", "N=1024"])
def test_3xtf32_product_keeps_fp32_accuracy(shape):
    """At the LeNet fc shapes and 400→120 at N = 1024, on inputs built as
    chip_smoke.py's sl_inputs builds them (post-ReLU x, ρ spread by 3 around
    softplus⁻¹(1e-3), N(0, 1) noise), the 3xTF32 product is within
    2e-6·max|ref| of float64; the dropped lo·lo term and the rounding of lo
    are each about 2⁻²² of a product. One TF32 pass is outside the kernels'
    gate of 1e-5·max|ref|. This is an error-budget model of the kernels'
    arithmetic, emulated here: it calls no kernel, and holds whatever the
    kernels do. Their own accuracy is checked only on the card, by
    chip_smoke.py's gate of 1e-5·max|ref| against the plain fp32 version."""
    S, N, Din, Dout = shape
    rng = np.random.default_rng(7)
    bnd = 1.0 / np.sqrt(Din)
    x = torch.from_numpy(np.maximum(rng.standard_normal((S, N, Din)), 0.0).astype(np.float32))
    mu = torch.from_numpy(rng.uniform(-bnd, bnd, (Dout, Din)).astype(np.float32))
    rho = torch.from_numpy((RHO0 + 3.0 * rng.standard_normal((Dout, Din))).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal((S, Dout, Din)).astype(np.float32))
    w = mu[None] + SL.softplus(rho)[None] * eps  # W_s as the kernels build it, in fp32
    ref = torch.bmm(x.double(), w.double().transpose(1, 2))
    scale = float(ref.abs().max())
    err3 = float((_emulated_product(x, w, 3).double() - ref).abs().max()) / scale
    err1 = float((_emulated_product(x, w, 1).double() - ref).abs().max()) / scale
    assert err3 <= 2e-6, err3
    assert err1 > 1e-5, err1
