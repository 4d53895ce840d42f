"""Pure, differentiable optimizers for the bilevel unroll.

Counterpart of ``psvi_tpu/ops/optim.py`` (``adam``, ``step_lr``,
``clip_nonnegative``). Steps are functional — they build new tensors and
never update in place — so ``torch.autograd`` differentiates the outer loss
through every inner step (``create_graph=True``), as the reference's
``robust_higher`` DifferentiableOptimizer did.

Update rules match ``torch.optim.Adam`` exactly: bias-corrected moments and
``denom = √v/√(1−β₂ᵗ) + eps``.
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
