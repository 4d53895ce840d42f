"""The port's Bayesian logistic regression and its NUTS building blocks
against the JAX package's.

- ``logreg_forward``, ``bernoulli_ll``/``_multi``, ``log_prior``: rtol 1e-6;
- ``laplace_precision``, diagonal and full: rtol 1e-5;
- ``run_laplace_from`` on a given θ0 and ε (1000 Adam steps): θ within
  2e-5 of JAX's, the samples within 1e-4; ``evaluate_coreset_laplace`` on
  JAX's noise: the same correct count, the NLL within rtol 1e-5;
- NUTS: ``_popcount``/``_trailing_ones`` for 0..4095, ``_uturn`` on
  straight and turning segments in both directions, ``_da_update`` over
  50 updates (rtol 1e-5: JAX in float32, the port in float64), and one
  leapfrog step (rtol 1e-6).
"""

import torch_threads  # noqa: F401  (torch on this worker's share of the cores)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psvi_torch.models import logreg as PLR
from psvi_torch.ops import nuts as PN
from psvi_torch.utils.convert import tensor_from_jax
from psvi_tpu.models import logreg as JLR
from psvi_tpu.ops import nuts as JN
from torch_jax_tape import feed, record


def problem(N=120, D=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    y = (rng.random(N) < 1 / (1 + np.exp(-x @ np.array([1.5, -2.0, 0.5])[:D]))).astype(
        np.float32)
    w = (N / 40.0 * rng.random(N)).astype(np.float32)
    theta = rng.standard_normal(D).astype(np.float32)
    return x, y, w, theta


T = torch.tensor


def test_likelihoods_and_prior_match_jax():
    x, y, _, theta = problem()
    thetas = np.random.default_rng(1).standard_normal((5, 3)).astype(np.float32)
    for p, j in ((PLR.logreg_forward(T(thetas), T(x)), JLR.logreg_forward(thetas, x)),
                 (PLR.bernoulli_ll(T(theta), T(x), T(y)), JLR.bernoulli_ll(theta, x, y)),
                 (PLR.bernoulli_ll_multi(T(thetas), T(x), T(y)),
                  JLR.bernoulli_ll_multi(thetas, x, y)),
                 (PLR.log_prior(T(theta)), JLR.log_prior(theta)),
                 (PLR.log_prior(T(theta), 0.5, 2.0), JLR.log_prior(theta, 0.5, 2.0))):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("diagonal", [True, False])
def test_laplace_precision_matches_jax(diagonal):
    x, _, w, theta = problem()
    w[:5] = -1.0  # negative weights count as 0
    np.testing.assert_allclose(PLR.laplace_precision(T(x), T(theta), T(w), diagonal).numpy(),
                               np.asarray(JLR.laplace_precision(x, theta, w, diagonal)),
                               rtol=1e-5)


@pytest.mark.parametrize("diagonal", [True, False])
def test_run_laplace_from_matches_jax(diagonal):
    x, y, w, theta0 = problem()
    key = jax.random.PRNGKey(4)
    js, jt = JLR.run_laplace_from(key, theta0, x, y, w, inner_it=1000, mc_samples=6,
                                  diagonal=diagonal, lr0net=1e-2)
    eps = np.asarray(jax.random.normal(key, (6, 3)))

    class Fed:  # hands the port JAX's ε
        device = torch.device("cpu")

    orig = PLR.draws.normal
    PLR.draws.normal = lambda gen, shape: T(eps)
    try:
        ps, pt = PLR.run_laplace_from(Fed(), T(theta0), T(x), T(y), T(w), inner_it=1000,
                                      mc_samples=6, diagonal=diagonal, lr0net=1e-2)
    finally:
        PLR.draws.normal = orig
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-4, atol=1e-4)
    # JAX's θ carried across (float32, bit for bit) gives JAX's precision
    th = tensor_from_jax(jt, "cpu")
    assert th.dtype == torch.float32
    np.testing.assert_allclose(PLR.laplace_precision(T(x), th, T(w), diagonal).numpy(),
                               np.asarray(JLR.laplace_precision(x, jt, w, diagonal)), rtol=1e-5)


def test_evaluate_coreset_laplace_on_jax_noise(monkeypatch):
    x, y, w, _ = problem()
    xa = np.concatenate([x, np.ones((len(x), 1), np.float32)], 1)
    with monkeypatch.context() as mp:
        tape = record(mp)
        ja, jn = JLR.evaluate_coreset_laplace(jax.random.PRNGKey(0), xa[:60], y[:60], w[:60],
                                              xa, y, inner_it=500, mc_samples=8)
    with monkeypatch.context() as mp:
        feed(mp, tape)
        pa, pn = PLR.evaluate_coreset_laplace(torch.Generator(), T(xa[:60]), T(y[:60]),
                                              T(w[:60]), T(xa), T(y), inner_it=500,
                                              mc_samples=8)
    assert tape.sizes()["normal"] == 0
    np.testing.assert_allclose(float(pa), float(ja), rtol=1e-6)  # the same 97 of 120
    np.testing.assert_allclose(float(pn), float(jn), rtol=1e-5)


def test_bit_tricks_match_jax():
    n = jnp.arange(4096)
    np.testing.assert_array_equal([PN._popcount(i) for i in range(4096)],
                                  np.asarray(JN._popcount(n)))
    np.testing.assert_array_equal([PN._trailing_ones(i) for i in range(4096)],
                                  np.asarray(JN._trailing_ones(n)))


@pytest.mark.parametrize("direction", [1.0, -1.0])
def test_uturn_matches_jax(direction):
    rng = np.random.default_rng(3)
    inv_m = np.abs(rng.standard_normal(4)).astype(np.float32) + 0.5
    p = rng.standard_normal(4).astype(np.float32)
    q0 = rng.standard_normal(4).astype(np.float32)
    h = 0.1 * direction
    cases = [(q0 + h * p * inv_m, p, q0 + 2 * h * p * inv_m, p),   # straight
             (q0 + h * p * inv_m, -p, q0 + 2 * h * p * inv_m, -p),  # turned
             (q0, p, q0 + h * p * inv_m, -p)]                       # turning at the end
    for ql, pl, qr, pr in cases:
        j = bool(JN._uturn(ql, pl, qr, pr, inv_m, direction=direction))
        assert bool(PN._uturn(T(ql), T(pl), T(qr), T(pr), T(inv_m), direction)) == j
    # a straight backward segment is no U-turn
    assert not bool(PN._uturn(T(q0 - 0.1 * p), T(p), T(q0 - 0.2 * p), T(p), torch.ones(4), -1.0))


def test_dual_averaging_matches_jax():
    js, ps = JN._da_init(jnp.float32(0.1)), PN._da_init(0.1)
    accs = np.random.default_rng(0).random(50)
    for a in accs:
        js, ps = JN._da_update(js, jnp.float32(a), 0.8), PN._da_update(ps, float(a), 0.8)
        for f in ("log_eps", "log_eps_avg", "h_avg", "mu", "t"):
            np.testing.assert_allclose(getattr(ps, f), float(getattr(js, f)), rtol=1e-5,
                                       atol=1e-6, err_msg=f)


def test_leapfrog_matches_jax():
    x, y, w, theta = problem()
    inv_m = np.array([0.5, 1.0, 2.0], np.float32)
    p = np.array([0.3, -0.2, 0.7], np.float32)

    def jlogd(t):
        return jnp.dot(w, JLR.bernoulli_ll(t, x, y)) + JLR.log_prior(t)

    def plogd(t):
        return torch.dot(T(w), PLR.bernoulli_ll(t, T(x), T(y))) + PLR.log_prior(t)

    def pvg(q):
        q = q.detach().requires_grad_(True)
        v = plogd(q)
        return v.detach(), torch.autograd.grad(v, q)[0]

    eps = 0.05
    g0 = jax.grad(jlogd)(theta)
    p_half = p + 0.5 * eps * g0
    jq = theta + eps * p_half * inv_m
    jl, jg = jax.value_and_grad(jlogd)(jq)
    jp = p_half + 0.5 * eps * jg
    _, pg0 = pvg(T(theta))
    pq, pp, pl, pg = PN._leapfrog(pvg, T(theta), T(p), pg0, eps, T(inv_m))
    for a, b in ((pq, jq), (pp, jp), (pl, jl), (pg, jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
