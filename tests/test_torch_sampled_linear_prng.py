"""Kernel B4's module (``psvi_torch/ops/sampled_linear_prng.py``) against the
JAX package, on the CPU.

JAX's B4 draws ε from the TPU's own generator, which exists nowhere else,
so the port is held to JAX in two ways:

- on the same ε: the port's plain generator (``prng_normal``) gives ε, and
  that ε, as NumPy, goes through JAX's ``sampled_linear`` (off the TPU its
  reference forward under the ``custom_vjp`` and ``_bwd``), ``VILinear.nkl``
  and ``VILinear.kl``;
- by distribution: the statistical tests of ``tests/test_pallas.py:60-124``
  (determinism, cross-tile consistency, E[−nkl] ≈ KL, dx against the
  recovered weights), ported.

The generator itself meets the Philox4x32-10 known-answer vectors of
Random123 and a float64 evaluation of its Box–Muller form. The kernels run
only on the card: ``chip_smoke.py`` holds them to these plain versions
there, their Philox words bit for bit.
"""

import torch_threads  # noqa: F401  (torch on this worker's share of the cores)

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psvi_torch.models.layers import VILinear
from psvi_torch.ops import sampled_linear as SL
from psvi_torch.ops import sampled_linear_prng as SLP
from psvi_tpu.models.layers import VILinear as JVILinear
from psvi_tpu.ops import pallas_vi as PV

RHO0 = float(np.log(np.expm1(1e-3)))  # softplus⁻¹(1e-3), the engine's init_sd
M32 = 0xFFFFFFFF

# (S, N, Din, Dout): tests/test_pallas.py:21's _args, then ragged LeNet-like
# shapes (fc1 400→120 and fc3 84→10 at N = 19)
SHAPES = [(6, 64, 32, 16), (3, 19, 400, 120), (3, 19, 84, 10)]


def _params(S, N, Din, Dout, seed=0):
    """x, μ_w, ρ_w, μ_b, ρ_b as float32 NumPy, ρ near softplus⁻¹(1e-3) with a
    jitter."""
    rng = np.random.default_rng(seed)
    b = 1.0 / np.sqrt(Din)
    a = (rng.standard_normal((S, N, Din)), rng.uniform(-b, b, (Dout, Din)),
         RHO0 + 0.3 * rng.standard_normal((Dout, Din)), rng.uniform(-b, b, Dout),
         RHO0 + 0.3 * rng.standard_normal(Dout))
    return [x.astype(np.float32) for x in a]


def _eps_np(seed, S, Dout, Din):
    return [e.numpy() for e in SLP.prng_eps(seed, S, Dout, Din, "cpu")]


# ----------------------------------------------------------------------
# The generator


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((M32,) * 4, (M32, M32), (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344), (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's Philox4x32-10 known-answer vectors."""
    got = SLP.philox4x32(torch.tensor([ctr], dtype=torch.int64), key)[0]
    assert [int(w) for w in got] == list(want)


def test_box_muller_matches_float64():
    """JAX's Box–Muller form on the generator's words, against the same
    formula in float64. Tolerance 5e-6: fp32 rounds 2π·u2 to a relative 6e-8
    of up to 2π, which |ε| ≤ 5.8 scales to about 2e-6, plus a few ulps of
    log, sqrt and cos."""
    S, n = 7, 3000
    w = SLP.philox4x32(torch.stack(torch.broadcast_tensors(
        torch.arange(n)[None], torch.arange(S)[:, None], torch.tensor(0), torch.tensor(0)),
        -1), SLP.philox_key(123))
    k1, k2 = (w[..., j].numpy() >> 9 for j in (0, 1))
    u1, u2 = k1 * 2.0**-23 + 2.0**-24, k2 * 2.0**-23
    want = np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)
    got = SLP.prng_normal(123, S, n, "cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)
    # the extreme words: u1 runs from 2⁻²⁴ (never 0, so ε stays finite) to
    # 1 − 2⁻²⁴
    edge = SLP.box_muller(torch.tensor([0, M32]), torch.tensor([0, 0])).numpy()
    np.testing.assert_allclose(edge, [math.sqrt(48 * math.log(2)), 2.0**-11.5], rtol=1e-6)


def test_normal_moments():
    """Mean, variance and the share beyond 2σ of 200 000 draws, each within
    five standard errors of N(0, 1)'s."""
    e = SLP.prng_normal(2024, 40, 5000, "cpu").double().flatten()
    n = e.numel()
    assert abs(float(e.mean())) < 5 / math.sqrt(n)
    assert abs(float(e.var()) - 1.0) < 5 * math.sqrt(2.0 / n)
    tail = 2 * 0.5 * math.erfc(2 / math.sqrt(2))  # P(|ε| > 2) ≈ 0.0455
    share = float((e.abs() > 2).double().mean())
    assert abs(share - tail) < 5 * math.sqrt(tail * (1 - tail) / n)


def test_eps_depends_only_on_seed_sample_and_index():
    """ε[s, e] does not depend on how many samples or elements are drawn;
    seeds differ; an int32 seed maps to 64 bits by two's complement."""
    small = SLP.prng_normal(9, 3, 50, "cpu")
    big = SLP.prng_normal(9, 5, 80, "cpu")
    assert torch.equal(small, big[:3, :50])
    assert not torch.equal(small, SLP.prng_normal(10, 3, 50, "cpu"))
    assert torch.equal(SLP.prng_normal(-1, 2, 9, "cpu"), SLP.prng_normal(2**64 - 1, 2, 9, "cpu"))
    assert torch.equal(SLP.prng_normal(torch.tensor(-7, dtype=torch.int32), 2, 9, "cpu"),
                       SLP.prng_normal(-7, 2, 9, "cpu"))
    # a layer's weights take e < Dout·Din, its biases the next Dout
    eps_w, eps_b = SLP.prng_eps(9, 3, 4, 10, "cpu")
    assert torch.equal(eps_w.reshape(3, -1), small[:, :40])
    assert torch.equal(eps_b, small[:, 40:44])


@pytest.mark.parametrize("seed", [1.5, torch.tensor(2.0), torch.tensor([1, 2]), 2**64,
                                  -2**63 - 1])
def test_seed_must_be_one_64_bit_integer(seed):
    with pytest.raises((TypeError, ValueError)):
        SLP.philox_key(seed)


# ----------------------------------------------------------------------
# The op against JAX on the same ε


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_jax_on_the_same_eps(shape):
    S, N, Din, Dout = shape
    a = _params(*shape)
    eps = _eps_np(31, S, Dout, Din)
    y_j = np.asarray(PV.sampled_linear(*map(jnp.asarray, a + eps)))
    y_t = SLP.sampled_linear_prng(*map(torch.from_numpy, a), 31).numpy()
    assert y_t.shape == (S, N, Dout)
    np.testing.assert_allclose(y_t, y_j, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_matches_jax_bwd(shape):
    S, N, Din, Dout = shape
    a = _params(*shape, seed=1)
    eps = [jnp.asarray(e) for e in _eps_np(-4, S, Dout, Din)]
    g_j = jax.grad(lambda *p: jnp.sum(jnp.sin(PV.sampled_linear(*p, *eps))),
                   argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, a))
    t = [torch.from_numpy(x).requires_grad_(True) for x in a]
    g_t = torch.autograd.grad(torch.sin(SLP.sampled_linear_prng(*t, -4)).sum(), t)
    # as tests/test_torch_sampled_linear.py holds B3's: rtol 1e-4, and atol
    # 1e-6 of the gradient's largest entry, since each entry sums S·N (dμ,
    # dρ) or Dout (dx) fp32 products in another order
    for name, x, y in zip(("dx", "dmu_w", "drho_w", "dmu_b", "drho_b"), g_t, g_j):
        y = np.asarray(y)
        np.testing.assert_allclose(x.numpy(), y, rtol=1e-4, atol=1e-6 * np.abs(y).max(),
                                   err_msg=name)


def test_backward_computes_only_what_is_asked(monkeypatch):
    a = [torch.from_numpy(x) for x in _params(2, 5, 6, 3)]
    calls = []
    monkeypatch.setattr(SLP, "prng_dparam_reference", lambda *p: calls.append(p))
    x = a[0].clone().requires_grad_(True)
    (gx,) = torch.autograd.grad(SLP.sampled_linear_prng(x, *a[1:], 3).sum(), [x])
    eps_w, _ = SLP.prng_eps(3, 2, 3, 6, "cpu")
    w = a[1][None] + SLP.softplus(a[2])[None] * eps_w
    torch.testing.assert_close(gx, w.sum(1)[:, None, :].expand_as(x), rtol=1e-5, atol=1e-6)
    assert calls == []


def test_seed_gets_no_gradient_and_double_backward_raises():
    a = [torch.from_numpy(x).requires_grad_(True) for x in _params(2, 5, 6, 3)]
    seed = torch.tensor(5, dtype=torch.int32)
    y = SLP.sampled_linear_prng(*a, seed)
    grads = y.grad_fn.apply(torch.ones_like(y))
    assert len(grads) == 6 and grads[5] is None
    assert all(g is not None for g in grads[:5])
    torch.testing.assert_close(y, SLP.sampled_linear_prng(*a, 5), rtol=0, atol=0)
    loss = torch.sin(SLP.sampled_linear_prng(*a, seed)).sum()
    (gx,) = torch.autograd.grad(loss, [a[0]], create_graph=True)
    with pytest.raises(RuntimeError, match="twice"):
        gx.sum().backward()


@pytest.mark.parametrize("Din,Dout,prior_sd", [(400, 120, 1.0), (84, 10, 0.5)])
def test_nkl_matches_jax_on_the_same_eps(Din, Dout, prior_sd):
    """Each output sums Dout·(Din + 1) fp32 terms of size ~7 (ρ near
    softplus⁻¹(1e-3): −ln sd ≈ 6.9), 48 120 at 400→120, so the tolerance is
    an atol of 1e-6 of Σ|terms|; JAX sums lp and lq apart and forms θ − μ,
    the port sums lp − lq on ε."""
    S = 3
    _, mu_w, rho_w, mu_b, rho_b = _params(1, 1, Din, Dout, seed=5)
    eps_w, eps_b = _eps_np(77, S, Dout, Din)
    layer = JVILinear(Din, Dout, prior_sd=prior_sd)
    p = {"mu_w": mu_w, "rho_w": rho_w, "mu_b": mu_b, "rho_b": rho_b}
    want = np.asarray(layer.nkl({k: jnp.asarray(v) for k, v in p.items()},
                                {"w": jnp.asarray(eps_w), "b": jnp.asarray(eps_b)}))
    got = SLP.vi_linear_nkl_prng(*(torch.from_numpy(v) for v in p.values()), 77, S,
                                 prior_sd).numpy()
    assert got.shape == (S,)
    mu = np.concatenate([mu_w.ravel(), mu_b]).astype(np.float64)
    sd = np.log1p(np.exp(np.concatenate([rho_w.ravel(), rho_b]).astype(np.float64)))
    eps = np.concatenate([eps_w.reshape(S, -1), eps_b], 1).astype(np.float64)
    terms = (-0.5 * ((mu + sd * eps) / prior_sd) ** 2 - np.log(prior_sd)
             + 0.5 * eps**2 + np.log(sd))
    scale = np.abs(terms).sum(1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale.max())
    np.testing.assert_allclose(got, terms.sum(1), rtol=0, atol=1e-6 * scale.max())
    # the port's own layer on the same ε agrees as well
    tl = VILinear(Din, Dout, prior_sd=prior_sd)
    port = tl.nkl({k: torch.from_numpy(v) for k, v in p.items()},
                  {"w": torch.from_numpy(eps_w), "b": torch.from_numpy(eps_b)}).numpy()
    np.testing.assert_allclose(got, port, rtol=0, atol=1e-6 * scale.max())


def test_nkl_is_outside_the_autograd_graph():
    p = [torch.from_numpy(v).requires_grad_(True) for v in _params(1, 1, 6, 3)[1:]]
    out = SLP.vi_linear_nkl_prng(*p, 1, 4)
    assert out.shape == (4,) and not out.requires_grad and out.grad_fn is None


# ----------------------------------------------------------------------
# tests/test_pallas.py:60-124, on the plain versions


def _pallas_args(S=6, N=64, Din=32, Dout=16, seed=0):
    """tests/test_pallas.py:21's scales: x ~ N(0, 1), μ ~ 0.1·N(0, 1), ρ ~
    0.1·N(0, 1) − 3."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((S, N, Din)), 0.1 * rng.standard_normal((Dout, Din)),
         0.1 * rng.standard_normal((Dout, Din)) - 3, 0.1 * rng.standard_normal(Dout),
         0.1 * rng.standard_normal(Dout) - 3)
    return [torch.as_tensor(x, dtype=torch.float32) for x in a]


def test_deterministic_and_distinct():
    a = _pallas_args()
    y1 = SLP.sampled_linear_prng(*a, 7)
    assert torch.equal(y1, SLP.sampled_linear_prng(*a, 7))
    assert torch.equal(y1, SLP.sampled_linear_prng(*a, 7, tile_n=8))  # ε ignores the tile
    assert float((y1[0] - y1[1]).abs().max()) > 1e-3  # samples differ
    assert float((y1 - SLP.sampled_linear_prng(*a, 8)).abs().max()) > 1e-3  # seeds differ


def test_cross_tile_consistency():
    """The same input row anywhere in N sees the same sampled weights."""
    x, *p = _pallas_args(4, 1024, 400, 120)
    x[:, 512] = x[:, 0]
    y = SLP.sampled_linear_prng(x, *p, 3)
    np.testing.assert_allclose(y[:, 512].numpy(), y[:, 0].numpy(), atol=1e-6)


def test_nkl_mean_matches_analytic_kl():
    """E_s[−nkl_s] over 4000 samples ≈ KL(q‖p) of JAX's VILinear.kl: within
    five standard errors plus 1e-3 of |KL| (tests/test_pallas.py:86-99)."""
    _, mu_w, rho_w, mu_b, rho_b = _pallas_args(Din=64, Dout=32)
    p = {"mu_w": mu_w, "rho_w": rho_w, "mu_b": mu_b, "rho_b": rho_b}
    kl = float(JVILinear(64, 32).kl({k: jnp.asarray(v.numpy()) for k, v in p.items()}))
    assert kl == pytest.approx(float(VILinear(64, 32).kl(p)), rel=1e-5)
    nkl = SLP.vi_linear_nkl_prng(mu_w, rho_w, mu_b, rho_b, 11, 4000).double()
    se = float(nkl.std()) / math.sqrt(4000)
    assert abs(-float(nkl.mean()) - kl) < 5 * se + 1e-3 * abs(kl)


def test_dx_matches_recovered_weights():
    """dx through the Function against cos(y)·W_s, with W_s and b_s
    recovered from the forward at x = I and x = 0 (tests/test_pallas.py:
    102-124, same tolerance)."""
    S, N, Din, Dout = 4, 256, 128, 64
    x, *p = _pallas_args(S, N, Din, Dout)
    b_rec = SLP.sampled_linear_prng(torch.zeros(S, 8, Din), *p, 5)[:, 0]
    eye = torch.eye(Din).expand(S, Din, Din)
    w_rec = (SLP.sampled_linear_prng(eye, *p, 5) - b_rec[:, None, :]).transpose(1, 2)
    x = x.requires_grad_(True)
    y = SLP.sampled_linear_prng(x, *p, 5)
    (gx,) = torch.autograd.grad(torch.sin(y).sum(), [x])
    want = torch.einsum("sno,soi->sni", torch.cos(y.detach()), w_rec)
    np.testing.assert_allclose(gx.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)
    # and the recovered weights are this seed's ε
    eps_w, eps_b = SLP.prng_eps(5, S, Dout, Din, "cpu")
    torch.testing.assert_close(w_rec, p[0] + SLP.softplus(p[1]) * eps_w, rtol=0, atol=1e-6)
    torch.testing.assert_close(b_rec, p[2] + SLP.softplus(p[3]) * eps_b, rtol=0, atol=1e-6)


# ----------------------------------------------------------------------
# The slice as a whole: a dense stack with one seed per layer


def test_composed_stack_matches_jax_on_the_same_eps():
    """A 20-12-8-3 stack with ReLU between layers, S = 3, N = 9: the
    categorical NLL scaled to the data minus the mean NKL (a value only),
    through the port's B4 op against JAX's sampled_linear and VILinear.nkl
    fed the same ε, layer by layer; loss at rtol 1e-5, gradients of x, μ and
    ρ as the backward test above."""
    S, N, widths, seeds, n_data = 3, 9, (20, 12, 8, 3), (101, -202, 303), 600.0
    rng = np.random.default_rng(8)
    x = rng.standard_normal((S, N, widths[0])).astype(np.float32)
    labels = rng.integers(0, widths[-1], N)
    layers = []
    for i, o in zip(widths[:-1], widths[1:]):
        _, mu_w, rho_w, mu_b, rho_b = _params(1, 1, i, o, seed=len(layers) + 20)
        layers.append([mu_w, rho_w, mu_b, rho_b])
    eps = [_eps_np(sd, S, o, i) for sd, i, o in zip(seeds, widths[:-1], widths[1:])]

    def loss_j(x, layers):
        h, nkl = x, 0.0
        for k, ((mu_w, rho_w, mu_b, rho_b), (e_w, e_b)) in enumerate(zip(layers, eps)):
            h = PV.sampled_linear(h, mu_w, rho_w, mu_b, rho_b, e_w, e_b)
            if k < len(layers) - 1:
                h = jax.nn.relu(h)
            p = {"mu_w": mu_w, "rho_w": rho_w, "mu_b": mu_b, "rho_b": rho_b}
            nkl = nkl + jax.lax.stop_gradient(
                JVILinear(mu_w.shape[1], mu_w.shape[0]).nkl(p, {"w": e_w, "b": e_b}))
        nll = -jnp.take_along_axis(jax.nn.log_softmax(h), labels[None, :, None], -1)[..., 0]
        return n_data / N * nll.sum(1).mean() - nkl.mean()

    def loss_t(x, layers):
        h, nkl = x, 0.0
        for k, ((mu_w, rho_w, mu_b, rho_b), sd) in enumerate(zip(layers, seeds)):
            h = SLP.sampled_linear_prng(h, mu_w, rho_w, mu_b, rho_b, sd)
            if k < len(layers) - 1:
                h = torch.relu(h)
            nkl = nkl + SLP.vi_linear_nkl_prng(mu_w, rho_w, mu_b, rho_b, sd, S)
        nll = -torch.log_softmax(h, -1).gather(
            -1, torch.as_tensor(labels)[None, :, None].expand(S, N, 1))[..., 0]
        return n_data / N * nll.sum(1).mean() - nkl.mean()

    lj, gj = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1)))(
        jnp.asarray(x), [[jnp.asarray(a) for a in lay] for lay in layers])
    leaves = [torch.from_numpy(x).requires_grad_(True)] + [
        torch.from_numpy(a).requires_grad_(True) for lay in layers for a in lay]
    tl = [leaves[1 + 4 * k:5 + 4 * k] for k in range(len(layers))]
    lt = loss_t(leaves[0], tl)
    gt = torch.autograd.grad(lt, leaves)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    want = [gj[0]] + [g for lay in gj[1] for g in lay]
    for k, (x_, y_) in enumerate(zip(gt, want)):
        y_ = np.asarray(y_)
        np.testing.assert_allclose(x_.numpy(), y_, rtol=1e-4, atol=1e-6 * np.abs(y_).max(),
                                   err_msg=f"leaf {k}")


# ----------------------------------------------------------------------
# The launch plans of B4a and B3 (the forward), B4b (dx) and B4c (dparam):
# functions of the shape only

# (S, N, Din, Dout): the LeNet fc layers at N = 356, 400→120 at N = 104 and
# 1024, the ragged and edge shapes, a Dout past dx's 384 resident rows and a
# Din past the forward's 512 resident columns
PLAN_SHAPES = [(10, 356, 400, 120), (10, 356, 120, 84), (10, 356, 84, 10), (10, 104, 400, 120),
               (10, 1024, 400, 120), (10, 1, 400, 120), (10, 7, 84, 10), (10, 356, 40, 1),
               (1, 356, 120, 84), (64, 2048, 400, 120), (2, 64, 64, 2048), (2, 64, 2048, 64)]
# plan, the grid's blocks a split, the split unit, the fewest points a
# split, the blocks the grid reaches where N allows, the most splits, the
# most points a split
PLANS = {
    "dparam": (SLP._dparam_plan, lambda S, Din, Dout: -(-(Din + 1) // 64) * -(-Dout // 64) * S,
               1, 32, 132, None, 256),
    "dx": (SLP._dx_plan, lambda S, Din, Dout: -(-Din // 64) * S, 64, 64, 198, 8, None),
    "fwd": (SLP._fwd_plan, lambda S, Din, Dout: -(-Dout // 32) * S, 64, 64, 330, 8, None),
}


def _unevened(kind, S, N, Din, Dout):
    """The split count a plan picks before the forward evens out its tiles
    (dx's and dparam's plans pick it as it is)."""
    if kind != "fwd":
        return PLANS[kind][0](S, N, Din, Dout)
    return SLP._n_splits(-(-Dout // 32) * S, N, 64, SL.FWD_BLOCKS, 8)


@pytest.mark.parametrize("kind", PLANS)
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_puts_every_point_in_one_split(shape, kind):
    """The kernels' grid runs z = s·n_splits + k (dparam) or (k, s) (dx):
    each (s, n) falls in exactly one split."""
    S, N, Din, Dout = shape
    plan, _, unit, *_ = PLANS[kind]
    ns = plan(*shape)
    seen = np.zeros((S, N), int)
    for z in range(S * ns):
        s, k = divmod(z, ns)
        n0, n1 = SLP._split_bounds(N, ns, unit)[k]
        seen[s, n0:n1] += 1
    assert (seen == 1).all()


def test_plans_depend_only_on_the_shape(monkeypatch):
    """Nothing of the card or the run enters a plan: with every CUDA query
    broken, the plans give what they gave, call after call."""
    want = [(SLP._dparam_plan(*sh), SLP._dx_plan(*sh), SLP._fwd_plan(*sh)) for sh in PLAN_SHAPES]

    def broken(*a, **k):
        raise AssertionError("a plan asked the device")

    for name in ("is_available", "device_count", "get_device_properties", "current_device"):
        monkeypatch.setattr(torch.cuda, name, broken)
    for _ in range(2):
        assert [(SLP._dparam_plan(*sh), SLP._dx_plan(*sh), SLP._fwd_plan(*sh))
                for sh in PLAN_SHAPES] == want


@pytest.mark.parametrize("kind", PLANS)
def test_splits_keep_the_fewest_points(kind):
    """Every split holds at least the plan's minimum (all of N when N is
    smaller), for every N up to 3000 at the narrowest layer (the most
    splits) and at fc1, and for every split count the cap allows."""
    plan, _, unit, least, *_ = PLANS[kind]
    for N in range(1, 3001):
        counts = {plan(1, N, 84, 10), plan(10, N, 400, 120)} | set(range(1, max(1, N // least) + 1))
        for ns in counts:
            sizes = [n1 - n0 for n0, n1 in SLP._split_bounds(N, ns, unit)]
            assert min(sizes) >= min(least, N), (N, ns, sizes)


@pytest.mark.parametrize("kind,want", [("dparam", (2, 4, 7, 4)), ("dx", (3, 5, 5, 3)),
                                       ("fwd", (3, 3, 3, 8))])
def test_grids_cover_the_sms_where_n_allows(kind, want):
    """At fc1–fc3 (N = 356) and 400→120 at N = 1024 the grid reaches its
    target (dparam one wave of 132 SMs with at most 256 points a split, dx
    one and a half waves, the forward two and a half waves of two blocks a
    SM), or the split count stops at the fewest points a split or at a
    cluster of 8; and no smaller count would do. Every grid has at least 132
    blocks where N allows. The forward then takes the fewest splits whose
    largest holds no more 64-point tiles (6 tiles: 3 splits, not 5)."""
    plan, blocks, _, least, target, most, widest = PLANS[kind]
    assert (SLP.DPARAM_BLOCKS, SLP.DX_BLOCKS, SLP.DX_MAX_SPLITS, SLP.DPARAM_MAX_POINTS,
            SL.FWD_BLOCKS, SL.FWD_MAX_SPLITS) == (132, 198, 8, 256, 330, 8)
    shapes = [PLAN_SHAPES[i] for i in (0, 1, 2, 4)]
    assert tuple(plan(*sh) for sh in shapes) == want
    for S, N, Din, Dout in PLAN_SHAPES:
        ns, per = _unevened(kind, S, N, Din, Dout), blocks(S, Din, Dout)
        cap = min(max(1, N // least), most or N)
        assert (per * ns >= target and -(-N // ns) <= (widest or N)) or ns == cap
        assert per * ns >= SLP.SMS or ns == cap
        assert ns == 1 or per * (ns - 1) < target or -(-N // (ns - 1)) > (widest or N)
        evened = plan(S, N, Din, Dout)
        if kind == "fwd":
            tiles = -(-N // 64)
            assert -(-tiles // evened) == -(-tiles // ns) and evened <= ns
            assert evened == 1 or -(-tiles // (evened - 1)) > -(-tiles // ns)
        else:
            assert evened == ns


@pytest.mark.parametrize("shape,mb", [((10, 356, 400, 120), 3.8496), ((10, 356, 120, 84), 1.62624),
                                      ((10, 356, 84, 10), 0.238), ((10, 1024, 400, 120), 7.6992)])
def test_dparam_scratch_matches_its_formula(shape, mb):
    """S·n_splits·Dout·(Din + 1) floats: 3.8 MB at fc1, 1.6 MB at fc2, 0.24
    MB at fc3, 7.7 MB at N = 1024, all inside the 50 MB L2."""
    S, N, Din, Dout = shape
    sh = SLP._dparam_scratch_shape(*shape)
    assert sh == (S, SLP._dparam_plan(*shape), Dout, Din + 1)
    assert 4 * math.prod(sh) == 4 * S * sh[1] * Dout * (Din + 1)
    assert 4 * math.prod(sh) / 1e6 == pytest.approx(mb)


# ----------------------------------------------------------------------
# The CUDA wrappers check what they are given before any pointer is passed


def _wrapper_calls(bad):
    """Each wrapper's arguments at a small shape (S=2, N=5, 6→3), float32 on
    the CPU, with ``bad`` ("dtype" or "shape") spoiling the first tensor."""
    x, mu_w, rho_w, mu_b, rho_b = (torch.from_numpy(v) for v in _params(2, 5, 6, 3))
    g = torch.zeros(2, 5, 3)

    def spoil(t):
        return t.double() if bad == "dtype" else t[..., :1].contiguous() if bad == "shape" else t

    return {
        SLP._prng_fwd_cuda: (x, spoil(mu_w), rho_w, mu_b, rho_b, 1),
        SLP._prng_dx_cuda: (g, spoil(mu_w), rho_w, 1),
        SLP._prng_dparam_cuda: (g, x, spoil(rho_w), rho_b, 1),
        SLP._prng_nkl_cuda: (mu_w, spoil(rho_w), mu_b, rho_b, 1, 4),
    }


@pytest.mark.parametrize("bad,match", [
    (None, "one CUDA device"),
    ("dtype", "expected torch.float32"),
    ("shape", "expected shape"),
])
def test_cuda_wrappers_validate(bad, match):
    SLP.reset_launches()
    for fn, args in _wrapper_calls(bad).items():
        with pytest.raises(ValueError, match=match):
            fn(*args)
    with pytest.raises(ValueError, match="counter: expected torch.int32" if bad else "CUDA"):
        SLP._philox_bits_cuda(torch.zeros((3, 4), dtype=torch.int64 if bad else torch.int32),
                              (0, 0))
    assert all(n == 0 for n in SLP.LAUNCHES.values())


# ----------------------------------------------------------------------
# The NKL's plan (B4d: element tiles × sample groups) and its summation order

# (S, Din, Dout): the LeNet fc layers at S = 10, the KL check's S = 4000 at
# 64→32, a ragged E (760 elements: three tiles, the last of 248), S = 1, and
# an S past the grid's target
NKL_PLAN_SHAPES = [(10, 400, 120), (10, 120, 84), (10, 84, 10), (4000, 64, 32), (10, 37, 20),
                   (1, 400, 120), (2, 1, 1), (100_000, 64, 32)]


@pytest.mark.parametrize("shape", NKL_PLAN_SHAPES)
def test_nkl_plan_covers_every_element_and_sample(shape):
    """The grid is tiles × groups: block (b, g) sums elements [256·b,
    256·(b+1)) for samples [g·spg, (g+1)·spg) (csrc: k_prng_nkl), so every
    element falls in exactly one tile and every sample in exactly one group,
    and no tile or group is empty."""
    S, Din, Dout = shape
    tiles, groups, spg = SLP._nkl_plan(S, Din, Dout)
    E = Dout * (Din + 1)
    assert SLP.NKL_TILE == 256 and (tiles - 1) * 256 < E <= tiles * 256
    owners = [g for g in range(groups) for _ in range(max(0, min(S, (g + 1) * spg) - g * spg))]
    assert owners == [s // spg for s in range(S)]
    assert all(g * spg < S for g in range(groups)) and groups <= 65535


def test_nkl_plan_depends_only_on_the_shape(monkeypatch):
    """Nothing of the card or the run enters the NKL's plan: with every CUDA
    query broken, it gives what it gave, call after call."""
    want = [SLP._nkl_plan(*sh) for sh in NKL_PLAN_SHAPES]

    def broken(*a, **k):
        raise AssertionError("a plan asked the device")

    for name in ("is_available", "device_count", "get_device_properties", "current_device"):
        monkeypatch.setattr(torch.cuda, name, broken)
    for _ in range(2):
        assert [SLP._nkl_plan(*sh) for sh in NKL_PLAN_SHAPES] == want


@pytest.mark.parametrize("shape,want", [((10, 400, 120), (188, 5, 2)), ((10, 120, 84), (40, 10, 1)),
                                        ((10, 84, 10), (4, 10, 1)), ((4000, 64, 32), (9, 118, 34))])
def test_nkl_grid_covers_the_sms(shape, want):
    """At fc1–fc3 (S = 10) and at S = 4000, 64→32: the samples a group are
    those of the fewest groups whose tiles × groups reach NKL_BLOCKS = 8·132
    blocks (one wave of eight 256-thread blocks an SM), or of a group a
    sample, dealt evenly (which may leave fewer groups: 6 at fc1 become 5 of
    two samples); at fc1 the grid covers the 132 SMs seven times over (the
    first design ran ten blocks there)."""
    S, Din, Dout = shape
    tiles, groups, spg = SLP._nkl_plan(*shape)
    assert (tiles, groups, spg) == want and SLP.NKL_BLOCKS == 8 * SLP.SMS == 1056
    fewest = min(g for g in range(1, S + 1) if tiles * g >= SLP.NKL_BLOCKS or g == S)
    assert spg == -(-S // fewest) and groups == -(-S // spg) <= fewest
    assert tiles * groups >= SLP.SMS or groups == S  # fc3: 4 tiles, a group a sample


@pytest.mark.parametrize("shape,mb", [((10, 400, 120), 0.00752), ((4000, 64, 32), 0.144),
                                      ((10, 37, 20), 0.00012), ((1, 400, 120), 0.000752)])
def test_nkl_scratch_matches_its_formula(shape, mb):
    """S·tiles floats of tile partials, part[s][tile]: 7.5 KB at fc1, 144 KB
    at S = 4000."""
    S, Din, Dout = shape
    sh = SLP._nkl_scratch_shape(*shape)
    assert sh == (S, SLP._nkl_plan(*shape)[0]) == (S, -(-Dout * (Din + 1) // 256))
    assert 4 * math.prod(sh) / 1e6 == pytest.approx(mb)


def _nkl_kernel_order(mu_w, rho_w, mu_b, rho_b, seed, S, prior_sd):
    """k_prng_nkl's sums in fp32 on the CPU: each element's term as the
    kernel forms it from the plain generator's ε; a tile's 256 terms added
    by the warp butterfly (xor 16, 8, 4, 2, 1, as warp_sum) and its 8 warps
    in order; each sample's tiles in order (k_prng_nkl_reduce)."""
    Dout, Din = mu_w.shape
    tiles = SLP._nkl_plan(S, Din, Dout)[0]
    eps = SLP.prng_normal(seed, S, Dout * (Din + 1), "cpu")
    mu = torch.cat((mu_w.reshape(-1), mu_b))
    sd = torch.nn.functional.softplus(torch.cat((rho_w.reshape(-1), rho_b)))
    hl, lp0 = np.float32(0.5 * math.log(2 * math.pi)), np.float32(math.log(prior_sd))
    x = (mu + sd * eps) / prior_sd
    t = (-0.5 * x * x - lp0 - hl) - (-0.5 * eps * eps - torch.log(sd) - hl)
    t = torch.nn.functional.pad(t, (0, tiles * 256 - t.shape[1])).reshape(S, tiles, 8, 32)
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        t = t + t[..., lane ^ o]
    acc = torch.zeros((S, tiles), dtype=torch.float32)
    for w in range(8):
        acc = acc + t[:, :, w, 0]
    out = torch.zeros(S, dtype=torch.float32)
    for b in range(tiles):
        out = out + acc[:, b]
    return out


@pytest.mark.parametrize("S,Din,Dout,prior_sd", [(10, 400, 120, 1.0), (10, 37, 20, 0.5),
                                                 (1, 84, 10, 1.0)])
def test_nkl_tile_partials_keep_fp32_accuracy(S, Din, Dout, prior_sd):
    """The redesigned NKL's summation order (a tree in each 256-element
    tile, then the tiles in order) in fp32 meets the plain version run in
    float64 on the same ε within chip_smoke.py's gate of B4 against its
    plain version: max |Δ| <= 1e-5·max |ref|. An error-budget model: no
    kernel runs here."""
    _, mu_w, rho_w, mu_b, rho_b = (torch.from_numpy(v) for v in _params(1, 1, Din, Dout, seed=9))
    got = _nkl_kernel_order(mu_w, rho_w, mu_b, rho_b, 2**40 + 1, S, prior_sd).double()
    ref = SLP.vi_linear_nkl_prng_reference(mu_w.double(), rho_w.double(), mu_b.double(),
                                           rho_b.double(), 2**40 + 1, S, prior_sd)
    assert ref.dtype == torch.float64 and got.shape == (S,)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
