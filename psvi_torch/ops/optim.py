"""Pure, differentiable optimizers for the bilevel unroll.

Counterpart of ``psvi_tpu/ops/optim.py``: the reference's
DifferentiableOptimizer zoo (``adam``, ``adamw``, ``sgd``, ``heavy_ball``,
``rmsprop``, ``adagrad``, ``adadelta``, ``adamax``, ``asgd``, ``rprop``,
looked up by name through ``REGISTRY``/``make``), ``step_lr`` and
``clip_nonnegative``. Steps are functional — they build new tensors and
never update in place — so ``torch.autograd`` differentiates the outer loss
through every inner step (``create_graph=True``), as the reference's
``robust_higher`` DifferentiableOptimizer did.

Update rules match their ``torch.optim`` namesakes, as the JAX package's
do; Adam's is ``denom = √v/√(1−β₂ᵗ) + eps`` on bias-corrected moments.
Every term that depends only on the step count (bias corrections, decayed
rates) is a Python float rounded to float32 as the JAX step computes it
for a traced float32 count; step counts are Python ints. Every square root
in a denominator is :func:`_sqrt_safe`, so grad-of-grad stays finite at a
zero gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from psvi_torch.utils.tree import tree_map


def _sqrt_safe(v):
    """sqrt with a zero derivative at exactly 0.

    The outer gradient differentiates through the Adam denominator; at
    ``v == 0`` (a parameter whose inner gradient is exactly zero, such as a
    dead ReLU path) ``d√v/dv = inf`` and the chain rule gives 0·inf = NaN.
    The value equals ``torch.sqrt`` (√0 = 0); the derivative at 0 is 0, the
    dead-path subgradient. The double ``where`` keeps every order of
    derivative finite.
    """
    pos = v > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, v, torch.ones_like(v))), 0.0)


def bias_corrections(t: int, b1: float, b2: float):
    """``(1 − β₁ᵗ, √(1 − β₂ᵗ))`` rounded to float32, as the JAX step computes
    them for a traced float32 step count."""
    t32 = np.float32(t)
    bc1 = np.float32(1.0) - np.power(np.float32(b1), t32)
    bc2 = np.float32(1.0) - np.power(np.float32(b2), t32)
    return float(bc1), float(np.sqrt(bc2))


class AdamState(NamedTuple):
    count: int
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    step: Callable


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """torch.optim.Adam-equivalent, as a pure tree-to-tree step."""

    def init(params):
        zeros = lambda x: torch.zeros_like(x)  # noqa: E731
        return AdamState(0, tree_map(zeros, params), tree_map(zeros, params))

    def step(params, grads, state: AdamState, lr_now: Optional[float] = None):
        lr_t = lr if lr_now is None else lr_now
        count = state.count + 1
        bc1, bc2s = bias_corrections(count, b1, b2)
        mu = tree_map(lambda m, g: b1 * m + (1.0 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1.0 - b2) * torch.square(g), state.nu, grads)
        new_params = tree_map(
            lambda p, m, v: p - lr_t * (m / bc1) / (_sqrt_safe(v) / bc2s + eps),
            params, mu, nu,
        )
        return new_params, AdamState(count, mu, nu)

    return Optimizer(init, step)


def _f32(x) -> np.float32:
    return np.float32(x)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-2) -> Optimizer:
    """torch.optim.AdamW: decoupled weight decay applied multiplicatively
    before the Adam update."""
    base = adam(lr, b1, b2, eps)

    def step(params, grads, state: AdamState, lr_now: Optional[float] = None):
        # a given lr_now is a float32 value, as JAX's traced schedule gives
        # it; JAX takes the default lr's factor in double precision
        decay = (1.0 - lr * weight_decay if lr_now is None
                 else float(_f32(1.0) - _f32(lr_now) * _f32(weight_decay)))
        return base.step(tree_map(lambda p: p * decay, params), grads, state, lr_now)

    return Optimizer(base.init, step)


class SGDState(NamedTuple):
    count: int
    momentum: Any  # None for plain SGD; the previous params for heavy_ball


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    """Plain (optionally momentum) SGD (ref ``hypergrad/diff_optimizers.py``
    GradientDescent, Momentum)."""

    def init(params):
        return SGDState(0, None if momentum == 0.0 else tree_map(torch.zeros_like, params))

    def step(params, grads, state: SGDState, lr_now: Optional[float] = None):
        lr_t = lr if lr_now is None else lr_now
        if momentum == 0.0:
            return tree_map(lambda p, g: p - lr_t * g, params, grads), SGDState(state.count + 1,
                                                                                None)
        mom = tree_map(lambda m, g: momentum * m + g, state.momentum, grads)
        return tree_map(lambda p, m: p - lr_t * m, params, mom), SGDState(state.count + 1, mom)

    return Optimizer(init, step)


def heavy_ball(lr: float, momentum: float = 0.9) -> Optimizer:
    """Heavy ball: p' = p − lr·g + momentum·(p − p_prev); the state holds
    p_prev, which starts at the initial params."""

    def init(params):
        return SGDState(0, params)

    def step(params, grads, state: SGDState, lr_now: Optional[float] = None):
        lr_t = lr if lr_now is None else lr_now
        new = tree_map(lambda p, g, prev: p - lr_t * g + momentum * (p - prev),
                       params, grads, state.momentum)
        return new, SGDState(state.count + 1, params)

    return Optimizer(init, step)


class RMSpropState(NamedTuple):
    count: int
    sq_avg: Any
    momentum: Any  # None unless momentum > 0
    grad_avg: Any  # None unless centered


def rmsprop(lr: float, alpha: float = 0.99, eps: float = 1e-8, momentum: float = 0.0,
            centered: bool = False) -> Optimizer:
    """torch.optim.RMSprop: sq ← α·sq + (1−α)g²; ``centered`` subtracts the
    squared running mean; an optional momentum buffer on the
    preconditioned step."""

    def init(params):
        zeros = lambda: tree_map(torch.zeros_like, params)  # noqa: E731
        return RMSpropState(0, zeros(), zeros() if momentum > 0 else None,
                            zeros() if centered else None)

    def step(params, grads, state: RMSpropState, lr_now: Optional[float] = None):
        lr_t = lr if lr_now is None else lr_now
        sq = tree_map(lambda s, g: alpha * s + (1.0 - alpha) * torch.square(g),
                      state.sq_avg, grads)
        gavg = None
        if centered:
            gavg = tree_map(lambda a, g: alpha * a + (1.0 - alpha) * g, state.grad_avg, grads)
            denom = tree_map(lambda s, a: _sqrt_safe(s - torch.square(a)) + eps, sq, gavg)
        else:
            denom = tree_map(lambda s: _sqrt_safe(s) + eps, sq)
        buf = None
        if momentum > 0:
            buf = tree_map(lambda b, g, d: momentum * b + g / d, state.momentum, grads, denom)
            new = tree_map(lambda p, b: p - lr_t * b, params, buf)
        else:
            new = tree_map(lambda p, g, d: p - lr_t * g / d, params, grads, denom)
        return new, RMSpropState(state.count + 1, sq, buf, gavg)

    return Optimizer(init, step)


class AdagradState(NamedTuple):
    count: int
    sum_sq: Any


def adagrad(lr: float, lr_decay: float = 0.0, eps: float = 1e-10,
            initial_accumulator_value: float = 0.0) -> Optimizer:
    """torch.optim.Adagrad: clr = lr / (1 + (t−1)·lr_decay);
    p ← p − clr·g/(√Σg² + eps)."""

    def init(params):
        return AdagradState(0, tree_map(
            lambda p: torch.full_like(p, initial_accumulator_value), params))

    def step(params, grads, state: AdagradState, lr_now: Optional[float] = None):
        lr_t = lr if lr_now is None else lr_now
        count = state.count + 1
        clr = float(_f32(lr_t) / (_f32(1.0) + (_f32(count) - _f32(1.0)) * _f32(lr_decay)))
        sum_sq = tree_map(lambda s, g: s + torch.square(g), state.sum_sq, grads)
        new = tree_map(lambda p, g, s: p - clr * g / (_sqrt_safe(s) + eps),
                       params, grads, sum_sq)
        return new, AdagradState(count, sum_sq)

    return Optimizer(init, step)


class AdadeltaState(NamedTuple):
    count: int
    sq_avg: Any
    acc_delta: Any


def adadelta(lr: float = 1.0, rho: float = 0.9, eps: float = 1e-6) -> Optimizer:
    """torch.optim.Adadelta."""

    def init(params):
        return AdadeltaState(0, tree_map(torch.zeros_like, params),
                             tree_map(torch.zeros_like, params))

    def step(params, grads, state: AdadeltaState, lr_now: Optional[float] = None):
        lr_t = lr if lr_now is None else lr_now
        sq = tree_map(lambda s, g: rho * s + (1.0 - rho) * torch.square(g), state.sq_avg, grads)
        delta = tree_map(lambda g, s, a: g * torch.sqrt(a + eps) / _sqrt_safe(s + eps),
                         grads, sq, state.acc_delta)
        acc = tree_map(lambda a, d: rho * a + (1.0 - rho) * torch.square(d),
                       state.acc_delta, delta)
        new = tree_map(lambda p, d: p - lr_t * d, params, delta)
        return new, AdadeltaState(state.count + 1, sq, acc)

    return Optimizer(init, step)


def adamax(lr: float = 2e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """torch.optim.Adamax: the infinity-norm second moment
    u ← max(β₂·u, |g| + eps)."""

    def init(params):
        return AdamState(0, tree_map(torch.zeros_like, params), tree_map(torch.zeros_like, params))

    def step(params, grads, state: AdamState, lr_now: Optional[float] = None):
        lr_t = lr if lr_now is None else lr_now
        count = state.count + 1
        bc1 = _f32(1.0) - np.power(_f32(b1), _f32(count))
        rate = float(_f32(lr_t) / bc1)
        mu = tree_map(lambda m, g: b1 * m + (1.0 - b1) * g, state.mu, grads)
        nu = tree_map(lambda u, g: torch.maximum(b2 * u, torch.abs(g) + eps), state.nu, grads)
        new = tree_map(lambda p, m, u: p - rate * m / u, params, mu, nu)
        return new, AdamState(count, mu, nu)

    return Optimizer(init, step)


class ASGDState(NamedTuple):
    count: int
    eta: float  # float32 values held as Python floats
    mu_t: float
    ax: Any


def asgd(lr: float = 1e-2, lambd: float = 1e-4, alpha: float = 0.75, t0: float = 1e6,
         weight_decay: float = 0.0) -> Optimizer:
    """torch.optim.ASGD: the decayed step η_t = lr/(1 + λ·lr·t)^α, with the
    tail average in ``ax``."""

    def init(params):
        return ASGDState(0, float(_f32(lr)), 1.0, params)

    def step(params, grads, state: ASGDState, lr_now: Optional[float] = None):
        # a given lr_now is a float32 value, as JAX's traced schedule gives
        # it; the default lr is a Python float, whose product with λ JAX
        # takes in double precision
        lam_lr = _f32(lambd * lr) if lr_now is None else _f32(lambd) * _f32(lr_now)
        lr_t = lr if lr_now is None else lr_now
        count = state.count + 1
        t = _f32(count)
        if weight_decay != 0.0:
            grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)
        # torch's order: decay p by the current η, step, then update η
        decay = float(_f32(1.0) - _f32(lambd) * _f32(state.eta))
        new = tree_map(lambda p, g: p * decay - state.eta * g, params, grads)
        if state.mu_t != 1.0:
            ax = tree_map(lambda a, p: a + state.mu_t * (p - a), state.ax, new)
        else:
            ax = new
        eta = float(_f32(lr_t) / np.power(_f32(1.0) + lam_lr * t, _f32(alpha)))
        mu_t = float(_f32(1.0) / np.maximum(_f32(1.0), t - _f32(t0)))
        return new, ASGDState(count, eta, mu_t, ax)

    return Optimizer(init, step)


class RpropState(NamedTuple):
    count: int
    prev_grad: Any
    step_size: Any


def rprop(lr: float = 1e-2, etas: tuple = (0.5, 1.2),
          step_sizes: tuple = (1e-6, 50.0)) -> Optimizer:
    """torch.optim.Rprop: per-parameter steps grown or shrunk by the sign
    agreement of successive gradients, branch-free (``torch.where``); the
    gradient is zeroed where its sign flipped. The update is piecewise
    constant in g, so no gradient flows through the sign logic."""
    etaminus, etaplus = etas
    step_min, step_max = step_sizes

    def init(params):
        return RpropState(0, tree_map(torch.zeros_like, params),
                          tree_map(lambda p: torch.full_like(p, lr), params))

    def step(params, grads, state: RpropState, lr_now: Optional[float] = None):
        del lr_now  # per-parameter steps, no global lr
        sign = tree_map(lambda g, pg: torch.sign(g * pg), grads, state.prev_grad)
        new_step = tree_map(
            lambda st, s: torch.clamp(st * torch.where(
                s > 0, etaplus, torch.where(s < 0, etaminus, 1.0)).to(st.dtype),
                step_min, step_max),
            state.step_size, sign)
        eff = tree_map(lambda g, s: torch.where(s < 0, torch.zeros_like(g), g), grads, sign)
        new = tree_map(lambda p, g, st: p - torch.sign(g) * st, params, eff, new_step)
        return new, RpropState(state.count + 1, eff, new_step)

    return Optimizer(init, step)


#: name → factory, the reference's DifferentiableOptimizer zoo; the engine
#: takes one by name (``PSVI(inner_optimizer="rmsprop")``)
REGISTRY = {
    "adam": adam,
    "adamw": adamw,
    "sgd": sgd,
    "heavy_ball": heavy_ball,
    "rmsprop": rmsprop,
    "adagrad": adagrad,
    "adadelta": adadelta,
    "adamax": adamax,
    "asgd": asgd,
    "rprop": rprop,
}


def make(name: str, lr: float, **kwargs) -> Optimizer:
    """Look up an optimizer by reference name (case-insensitive)."""
    key = name.lower()
    if key not in REGISTRY:
        raise ValueError(f"unknown optimizer {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[key](lr, **kwargs)


def step_lr(lr0: float, step_size: int, gamma: float):
    """StepLR schedule (ref ``psvi_classes.py:864-866``): lr0·γ^⌊t/step⌋,
    rounded to float32 as the JAX schedule returns it."""

    def schedule(t: int) -> float:
        k = np.float32(t // step_size)
        return float(np.float32(lr0) * np.power(np.float32(gamma), k))

    return schedule


def clip_nonnegative(x):
    """Project onto the nonnegative orthant — the v-clamp for unparameterised
    learnable weights (ref ``psvi_classes.py:585-591``)."""
    return tree_map(lambda a: torch.clamp_min(a, 0.0), x)
