"""The port's differentiable Adam against ``psvi_tpu.ops.optim``: values over
three steps and the gradient of a loss after three steps w.r.t. a
hyperparameter that shapes every inner gradient (grad-of-grad)."""

import torch_threads  # noqa: F401  (torch on this worker's share of the cores)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psvi_torch.ops import optim as O
from psvi_tpu.ops import optim as JO

# fp32 on both sides, the same formulas in another op order: 1e-6 relative
RTOL = 1e-6


def _tree(rng):
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}


def test_adam_three_steps_match_jax():
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    grads[1]["b"][2] = 0.0  # a zero gradient exercises the √0 branch
    jopt, topt = JO.adam(1e-2), O.adam(1e-2)
    jp, js = p0, jopt.init(jax.tree_util.tree_map(jnp.asarray, p0))
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    ts = topt.init(tp)
    for g in grads:
        jp, js = jopt.step(jp, jax.tree_util.tree_map(jnp.asarray, g), js)
        tp, ts = topt.step(tp, {k: torch.tensor(v) for k, v in g.items()}, ts)
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=RTOL, atol=1e-7)
            np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(js.nu[k]), rtol=RTOL)
    assert ts.count == int(js.count) == 3


def test_adam_grad_of_grad_matches_jax():
    """d/dc Σ p₃² where p_{t+1} = Adam(p_t, ∇_p f(p_t; c)), f = Σ c·sin(p)·p²."""
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal(6).astype(np.float32)
    c0 = rng.standard_normal(6).astype(np.float32)
    lr = 0.05

    def jloss(c):
        opt = JO.adam(lr)
        p, s = jnp.asarray(p0), opt.init(jnp.asarray(p0))
        for _ in range(3):
            g = jax.grad(lambda q: jnp.sum(c * jnp.sin(q) * q * q))(p)
            p, s = opt.step(p, g, s)
        return jnp.sum(p * p)

    jval, jg = jax.value_and_grad(jloss)(jnp.asarray(c0))

    c = torch.tensor(c0, requires_grad=True)
    opt = O.adam(lr)
    p = torch.tensor(p0, requires_grad=True)
    s = opt.init(p)
    for _ in range(3):
        (g,) = torch.autograd.grad(torch.sum(c * torch.sin(p) * p * p), p, create_graph=True)
        p, s = opt.step(p, g, s)
    val = torch.sum(p * p)
    (tg,) = torch.autograd.grad(val, c)
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    # second-order through three steps: 1e-4 relative
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-6)


def test_sqrt_safe_zero_subgradient():
    x = torch.tensor([0.0, 4.0, 0.25], requires_grad=True)
    y = O._sqrt_safe(x)
    np.testing.assert_array_equal(y.detach().numpy(), [0.0, 2.0, 0.5])
    (g,) = torch.autograd.grad(y.sum(), x, create_graph=True)
    np.testing.assert_allclose(g.detach().numpy(), [0.0, 0.25, 1.0])
    (h,) = torch.autograd.grad(g.sum(), x)
    assert torch.isfinite(h).all() and float(h[0]) == 0.0


@pytest.mark.parametrize("t", [0, 1, 49, 50, 51, 130])
def test_step_lr_matches_jax(t):
    j = JO.step_lr(1e-3, 50, 0.5)
    assert O.step_lr(1e-3, 50, 0.5)(t) == float(j(jnp.int32(t)))


def test_clip_nonnegative():
    x = {"v": torch.tensor([-1.0, 0.0, 2.0])}
    np.testing.assert_array_equal(O.clip_nonnegative(x)["v"].numpy(), [0.0, 0.0, 2.0])
