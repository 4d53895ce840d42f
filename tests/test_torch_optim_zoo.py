"""The port's optimizer zoo against ``psvi_tpu.ops.optim``: every optimizer
of the registry other than Adam (``tests/test_torch_optim.py``) over three
steps, values and state, and the gradient of a loss after three steps
w.r.t. a hyperparameter that shapes every inner gradient (grad-of-grad),
at Adam's tolerances; ``make`` and the registry's error."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psvi_torch.ops import optim as O
from psvi_tpu.ops import optim as JO

# each optimizer with options that reach its every branch; the momentum,
# centred and weight-decay variants are separate cases
CASES = {
    "sgd": ("sgd", 0.05, {}),
    "sgd_momentum": ("sgd", 0.05, {"momentum": 0.9}),
    "heavy_ball": ("heavy_ball", 0.05, {}),
    "adamw": ("adamw", 0.05, {}),
    "rmsprop": ("rmsprop", 0.01, {}),
    "rmsprop_centered_momentum": ("rmsprop", 0.01, {"centered": True, "momentum": 0.5}),
    "adagrad": ("adagrad", 0.05, {"lr_decay": 0.1}),
    "adadelta": ("adadelta", 1.0, {}),
    "adamax": ("adamax", 0.05, {}),
    "asgd": ("asgd", 0.05, {"weight_decay": 0.01}),
    "asgd_tail": ("asgd", 0.05, {"t0": 1.0}),  # the tail average from t = 2
    "rprop": ("rprop", 0.05, {}),
}


def _tree(rng):
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}


def _leaves(state):
    """The tensor leaves of an optimizer state, None and counts skipped."""
    out = []
    for x in state:
        if x is None or isinstance(x, (int, float, np.integer, np.floating)):
            continue
        if hasattr(x, "shape") and not isinstance(x, dict) and getattr(x, "ndim", 1) == 0:
            continue
        out += [x[k] for k in sorted(x)] if isinstance(x, dict) else [x]
    return out


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("lr_now", [None, 0.02])
def test_optimizer_three_steps_match_jax(case, lr_now):
    name, lr, kw = CASES[case]
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    grads[1]["b"][2] = 0.0  # a zero gradient exercises the √0 branch
    grads[2]["a"][0] = -grads[1]["a"][0]  # a sign flip (Rprop)
    jopt, topt = JO.make(name, lr, **kw), O.make(name, lr, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = jopt.init(jp)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    ts = topt.init(tp)
    jlr = None if lr_now is None else jnp.float32(lr_now)
    for g in grads:
        jp, js = jopt.step(jp, jax.tree_util.tree_map(jnp.asarray, g), js, jlr)
        tp, ts = topt.step(tp, {k: torch.tensor(v) for k, v in g.items()}, ts, lr_now)
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        for t_leaf, j_leaf in zip(_leaves(ts), _leaves(js)):
            np.testing.assert_allclose(np.asarray(t_leaf), np.asarray(j_leaf), rtol=1e-6,
                                       atol=1e-7)
    assert ts.count == int(js.count) == 3
    if name == "asgd":
        np.testing.assert_allclose(ts.eta, float(js.eta), rtol=1e-6)
        np.testing.assert_allclose(ts.mu_t, float(js.mu_t), rtol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_grad_of_grad_matches_jax(case):
    """d/dc Σ p₃² where p_{t+1} = opt(p_t, ∇_p f(p_t; c)), f = Σ c·sin(p)·p²."""
    name, lr, kw = CASES[case]
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal(6).astype(np.float32)
    c0 = rng.standard_normal(6).astype(np.float32)

    def jloss(c):
        opt = JO.make(name, lr, **kw)
        p, s = jnp.asarray(p0), opt.init(jnp.asarray(p0))
        for _ in range(3):
            g = jax.grad(lambda q: jnp.sum(c * jnp.sin(q) * q * q))(p)
            p, s = opt.step(p, g, s)
        return jnp.sum(p * p)

    jval, jg = jax.value_and_grad(jloss)(jnp.asarray(c0))

    c = torch.tensor(c0, requires_grad=True)
    opt = O.make(name, lr, **kw)
    p = torch.tensor(p0, requires_grad=True)
    s = opt.init(p)
    for _ in range(3):
        (g,) = torch.autograd.grad(torch.sum(c * torch.sin(p) * p * p), p, create_graph=True)
        p, s = opt.step(p, g, s)
    val = torch.sum(p * p)
    (tg,) = torch.autograd.grad(val, c, allow_unused=True)
    tg = torch.zeros_like(c) if tg is None else tg
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    assert torch.isfinite(tg).all()
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-6)


def test_grad_of_grad_finite_at_zero_gradient():
    """A parameter whose inner gradient is exactly 0 keeps every
    optimizer's outer gradient finite (the √0 denominators)."""
    for name in sorted(O.REGISTRY):
        c = torch.tensor([0.0, 1.5], requires_grad=True)
        opt = O.make(name, 0.05)
        p = torch.tensor([0.3, -0.7], requires_grad=True)
        s = opt.init(p)
        for _ in range(3):
            (g,) = torch.autograd.grad(torch.sum(c * p * p), p, create_graph=True)
            p, s = opt.step(p, g, s)
        (tg,) = torch.autograd.grad(torch.sum(p * p), c, allow_unused=True)
        assert tg is None or torch.isfinite(tg).all(), name


def test_registry_and_make():
    assert sorted(O.REGISTRY) == sorted(JO.REGISTRY)
    assert O.make("RMSprop", 1e-3).init is not None
    with pytest.raises(ValueError, match="unknown optimizer 'lbfgs'; available: "):
        O.make("lbfgs", 1e-3)
    with pytest.raises(ValueError) as jerr:
        JO.make("lbfgs", 1e-3)
    with pytest.raises(ValueError) as terr:
        O.make("lbfgs", 1e-3)
    assert str(terr.value) == str(jerr.value)
