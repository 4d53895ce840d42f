"""The port's implicit-differentiation solvers (``psvi_torch/ops/hypergrad.py``)
against the JAX package's, both in float64, and against the closed form.

The problem is the quadratic bilevel one of ``tests/test_hypergrad.py``:
  inner:  w*(λ) = argmin_w ½ wᵀA w − λᵀw   ⇒  w* = A⁻¹λ
  outer:  L(w, λ) = ½‖w − b‖² + ½γ‖λ‖²
  exact hypergradient: dL/dλ = A⁻¹(w* − b) + γλ
with the fixed-point map Φ(w, λ) = w − η(Aw − λ), which draws no noise, so
the solvers' noise tags (the port) and keys (JAX) change nothing.
"""

import torch_threads  # noqa: F401  (torch on this worker's share of the cores)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psvi_torch.ops import hypergrad as H
from psvi_tpu.ops import hypergrad as JH

ETA, GAMMA = 0.1, 0.3
# each solver's iterations, as in tests/test_hypergrad.py
K = {"cg_normaleq": 40, "fixed_point": 60, "neumann": 150}
REL64 = 1e-8  # port against JAX, both float64: max |Δ| ≤ REL64·max |ref|


def _problem(seed=0, d=6):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((d, d))
    A = M @ M.T / d + np.eye(d)  # SPD, well-conditioned
    return A, rng.standard_normal(d), rng.standard_normal(d)


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def _close64(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.abs(got - ref).max() <= REL64 * np.abs(ref).max()


def _closed_form(A, b, lam):
    w_star = np.linalg.solve(A, lam)
    return w_star, np.linalg.solve(A, w_star - b) + GAMMA * lam


def test_tree_helpers():
    a = {"x": _t([1.0, 2.0]), "y": (_t([3.0]),)}
    b = {"x": _t([0.5, -1.0]), "y": (_t([2.0]),)}
    assert float(H.tree_dot(a, b)) == 0.5 - 2.0 + 6.0
    np.testing.assert_array_equal(H.tree_add(a, b, 2.0)["x"].numpy(), [2.0, 0.0])
    np.testing.assert_array_equal(H.tree_scale(a, -1.0)["y"][0].numpy(), [-3.0])


@pytest.mark.parametrize("tree", [False, True])
def test_cg_solve_matches_jax_and_linear_solve(tree):
    A, b, _ = _problem()
    tA = _t(A)
    if tree:
        b_p, b_j = {"a": _t(b[:3]), "z": _t(b[3:])}, {"a": b[:3], "z": b[3:]}

        def mv(x, cat, A_):
            out = A_ @ cat([x["a"], x["z"]])
            return {"a": out[:3], "z": out[3:]}

        x = H.cg_solve(lambda x, i: mv(x, torch.cat, tA), b_p, K=30)
        with jax.enable_x64(True):
            xj = JH.cg_solve(lambda x, i: mv(x, jnp.concatenate, jnp.asarray(A)),
                             {k: jnp.asarray(v) for k, v in b_j.items()}, K=30)
            xj = np.concatenate([np.asarray(xj["a"]), np.asarray(xj["z"])])
        got = torch.cat([x["a"], x["z"]]).numpy()
    else:
        got = H.cg_solve(lambda x, i: tA @ x, _t(b), K=30).numpy()
        with jax.enable_x64(True):
            xj = np.asarray(JH.cg_solve(lambda x, i: jnp.asarray(A) @ x, jnp.asarray(b), K=30))
    _close64(got, xj)
    np.testing.assert_allclose(got, np.linalg.solve(A, b), rtol=1e-4)


def test_cg_solve_guards_zero_denominators():
    """A zero right-hand side gives p = r = 0: every pAp and rᵀr is 0, and
    the guarded divisions keep x at 0, as JAX's do."""
    x = H.cg_solve(lambda x, i: 2.0 * x, torch.zeros(3, dtype=torch.float64), K=4)
    assert torch.equal(x, torch.zeros(3, dtype=torch.float64))


@pytest.mark.parametrize("solver", ["cg_normaleq", "fixed_point", "neumann"])
def test_ift_solver_matches_jax_and_closed_form(solver):
    A, b, lam = _problem()
    w_star, expect = _closed_form(A, b, lam)
    tA, tb = _t(A), _t(b)
    tags = []

    def fp_map(w, h, tag):
        tags.append(tag)
        return w - ETA * (tA @ w - h["lam"])

    def outer(w, h):
        return 0.5 * torch.sum((w - tb) ** 2) + 0.5 * GAMMA * torch.sum(h["lam"] ** 2)

    hg = getattr(H, solver)(fp_map, outer, _t(w_star), {"lam": _t(lam)}, K[solver])
    got = hg.hyper_grads["lam"].numpy()
    with jax.enable_x64(True):
        jA, jb = jnp.asarray(A), jnp.asarray(b)
        jhg = getattr(JH, solver)(
            lambda w, h, key: w - ETA * (jA @ w - h["lam"]),
            lambda w, h: 0.5 * jnp.sum((w - jb) ** 2) + 0.5 * GAMMA * jnp.sum(h["lam"] ** 2),
            jnp.asarray(w_star), {"lam": jnp.asarray(lam)}, K[solver], jax.random.PRNGKey(0))
        ref, ref_loss = np.asarray(jhg.hyper_grads["lam"]), float(jhg.outer_loss)
    _close64(got, ref)
    np.testing.assert_allclose(float(hg.outer_loss), ref_loss, rtol=1e-12)
    np.testing.assert_allclose(got, expect, rtol=2e-3, atol=1e-4)
    # the noise tags of JAX's key pattern (module docstring)
    k = K[solver]
    want = {"cg_normaleq": {"vjp"} | {("jvp", i) for i in range(-1, k)},
            "fixed_point": set(range(k + 1)), "neumann": {"vjp"}}[solver]
    assert set(tags) == want


def test_exact_matches_jax_and_closed_form():
    A, b, lam = _problem()
    _, expect = _closed_form(A, b, lam)
    tA, tb = _t(A), _t(b)
    hg = H.exact(lambda h: torch.linalg.solve(tA, h["lam"]),
                 lambda w, h: 0.5 * torch.sum((w - tb) ** 2)
                 + 0.5 * GAMMA * torch.sum(h["lam"] ** 2), {"lam": _t(lam)})
    with jax.enable_x64(True):
        jA, jb = jnp.asarray(A), jnp.asarray(b)
        ref = np.asarray(JH.exact(
            lambda h: jnp.linalg.solve(jA, h["lam"]),
            lambda w, h: 0.5 * jnp.sum((w - jb) ** 2) + 0.5 * GAMMA * jnp.sum(h["lam"] ** 2),
            {"lam": jnp.asarray(lam)}).hyper_grads["lam"])
    _close64(hg.hyper_grads["lam"].numpy(), ref)
    np.testing.assert_allclose(hg.hyper_grads["lam"].numpy(), expect, rtol=1e-4, atol=1e-5)


def test_reverse_unroll_matches_jax_and_closed_form():
    """Reverse mode through 300 unrolled GD steps converges to the exact
    hypergradient (ref hypergradients.py:14-80)."""
    A, b, lam = _problem()
    _, expect = _closed_form(A, b, lam)
    tA, tb = _t(A), _t(b)

    def inner(h):
        w = torch.zeros_like(tb)
        for _ in range(300):
            w = w - ETA * (tA @ w - h["lam"])
        return w

    hg = H.reverse_unroll(inner, lambda w, h: 0.5 * torch.sum((w - tb) ** 2)
                          + 0.5 * GAMMA * torch.sum(h["lam"] ** 2), {"lam": _t(lam)})
    with jax.enable_x64(True):
        jA, jb = jnp.asarray(A), jnp.asarray(b)

        def jinner(h):
            def body(w, _):
                return w - ETA * (jA @ w - h["lam"]), None
            return jax.lax.scan(body, jnp.zeros_like(jb), None, length=300)[0]

        ref = np.asarray(JH.reverse_unroll(
            jinner,
            lambda w, h: 0.5 * jnp.sum((w - jb) ** 2) + 0.5 * GAMMA * jnp.sum(h["lam"] ** 2),
            {"lam": jnp.asarray(lam)}).hyper_grads["lam"])
    _close64(hg.hyper_grads["lam"].numpy(), ref)
    np.testing.assert_allclose(hg.hyper_grads["lam"].numpy(), expect, rtol=2e-3, atol=1e-4)


def test_unread_hyperparameter_gets_a_zero_gradient():
    """A leaf the outer loss and Φ do not read gets zeros, as JAX's grad
    gives (the ablated objective reads no v)."""
    w = _t([1.0, 2.0])
    hg = H.neumann(lambda p, h, tag: p - 0.1 * (p - h["a"]),
                   lambda p, h: torch.sum(p ** 2), w, {"a": _t([0.0, 1.0]), "b": _t([3.0])}, 3)
    assert torch.equal(hg.hyper_grads["b"], torch.zeros(1, dtype=torch.float64))
