"""No-U-Turn Sampler (NUTS) with a host loop over device tensors.

Counterpart of ``psvi_tpu/ops/nuts.py``: multinomial NUTS (Betancourt
2017) with the iterative tree doubling of Phan et al. (an O(max_depth)
checkpoint buffer and the bit-trick U-turn schedule, ``_popcount`` and
``_trailing_ones``), Stan's warmup (dual averaging of the step size,
Hoffman & Gelman 2014, in three windows with a diagonal Welford mass
estimate in the middle) and positions that are any tree of tensors.

JAX's ``lax.while_loop`` becomes a Python loop: the position, momentum and
gradient stay on the device, and each leapfrog reads one small tensor back
(the energy error, the leaf's uniform draw and the U-turn checks it
completes) to decide whether the subtree goes on; each doubling reads the
trajectory's own U-turn check. The draws come from a ``torch.Generator``.

U-turn bookkeeping: within a fresh subtree of size 2^d, leaves are
generated left to right at local indices i = 0..2^d−1. Leaf i with e
trailing zero bits is the left endpoint of the aligned sub-subtrees of
sizes 2^1..2^e whose checks happen later, and storing it at checkpoint
slot ``popcount(i)`` overwrites no live endpoint. Odd leaf n with t
trailing one bits completes t aligned sub-subtrees; their left endpoints
live at slots ``popcount(n)−1 .. popcount(n)−t``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from psvi_torch.utils.tree import tree_leaves, tree_unflatten

DIVERGENCE_THRESHOLD = 1000.0


def _popcount(n: int) -> int:
    return bin(int(n) & 0xFFFFFFFF).count("1")


def _trailing_ones(n: int) -> int:
    # the number of trailing 1-bits = popcount(n & ~(n+1))
    n = int(n) & 0xFFFFFFFF
    return _popcount(n & ~(n + 1))


def _log(u: float) -> float:
    return math.log(u) if u > 0.0 else -math.inf


def _uturn(q_l, p_l, q_r, p_r, inv_mass, direction=1.0):
    """U-turn criterion of a segment whose endpoints are given in generation
    order; ``direction`` is the sign of the integration step (for backward
    integration the earlier-generated endpoint lies later in trajectory
    time, so Δq is flipped to trajectory order). A bool tensor."""
    dq = (q_r - q_l) * direction
    return (torch.dot(dq, p_l * inv_mass) < 0.0) | (torch.dot(dq, p_r * inv_mass) < 0.0)


def _leapfrog(value_and_grad, q, p, grad, eps, inv_mass):
    p_half = p + 0.5 * eps * grad
    q_new = q + eps * p_half * inv_mass
    logd, grad_new = value_and_grad(q_new)
    return q_new, p_half + 0.5 * eps * grad_new, logd, grad_new


def _nuts_transition(value_and_grad: Callable, q0, gen, step_size: float, inv_mass,
                     max_depth: int):
    """One NUTS transition. Returns (q_new, accept_stat, diverged)."""
    D = q0.shape[0]
    dev = q0.device
    p0 = torch.randn((D,), generator=gen, device=dev) / torch.sqrt(inv_mass)
    logd0, grad0 = value_and_grad(q0)
    energy0 = -logd0 + 0.5 * torch.sum(p0 * p0 * inv_mass)

    def build_subtree(q, p, grad, depth, eps):
        """2^depth leaves from (q, p) with step eps: (end state, proposal,
        log weight, Σ accept, leaves, diverged, turning)."""
        L = 1 << depth
        ckpt_q, ckpt_p = [None] * (max_depth + 1), [None] * (max_depth + 1)
        q_prop, logw, sum_acc = q, -math.inf, 0.0
        direction = 1.0 if eps > 0 else -1.0
        i, diverged, turning = 0, False, False
        while i < L and not diverged and not turning:
            q, p, logd, grad = _leapfrog(value_and_grad, q, p, grad, eps, inv_mass)
            delta = (-logd + 0.5 * torch.sum(p * p * inv_mass)) - energy0
            u = torch.rand((), generator=gen, device=dev)
            checks = []
            if i % 2 == 0:
                slot = _popcount(i)
                ckpt_q[slot], ckpt_p[slot] = q, p
            else:
                pc = _popcount(i)
                checks = [_uturn(ckpt_q[pc - k], ckpt_p[pc - k], q, p, inv_mass, direction)
                          for k in range(1, _trailing_ones(i) + 1)]
            # the one read of the leaf: its energy error, its uniform, its checks
            read = torch.stack([delta.to(torch.float32), u]
                               + [c.to(torch.float32) for c in checks]).tolist()
            delta_f, u_f = read[0], read[1]
            if math.isnan(delta_f):
                delta_f = math.inf
            diverged = delta_f > DIVERGENCE_THRESHOLD
            logw_leaf = -delta_f
            sum_acc += 1.0 if delta_f <= 0.0 else math.exp(-delta_f)
            # progressive multinomial sampling within the subtree
            logw_new = float(np.logaddexp(logw, logw_leaf))
            if _log(u_f) < logw_leaf - logw_new:
                q_prop = q
            logw = logw_new
            turning = (not diverged) and any(v > 0.5 for v in read[2:])
            i += 1
        return q, p, grad, q_prop, logw, sum_acc, i, diverged, turning

    q_left = q_right = q_prop = q0
    p_left = p_right = p0
    grad_l = grad_r = grad0
    logw, sum_accept, n_leaves = 0.0, 0.0, 0
    diverged = turning = False
    depth = 0
    while depth < max_depth and not diverged and not turning:
        go_right, u_swap = torch.rand((2,), generator=gen, device=dev).tolist()
        go_right = go_right < 0.5
        if go_right:
            q_s, p_s, g_s, eps = q_right, p_right, grad_r, step_size
        else:
            q_s, p_s, g_s, eps = q_left, p_left, grad_l, -step_size
        (q_end, p_end, g_end, q_prop_s, logw_s, sum_acc_s, n_s, diverged_s,
         turning_s) = build_subtree(q_s, p_s, g_s, depth, eps)
        sum_accept += sum_acc_s
        n_leaves += n_s
        bad = diverged_s or turning_s
        # merge only a complete, healthy subtree
        if not bad:
            if go_right:
                q_right, p_right, grad_r = q_end, p_end, g_end
            else:
                q_left, p_left, grad_l = q_end, p_end, g_end
            # biased progressive sampling across subtrees (Betancourt 2017)
            if _log(u_swap) < logw_s - logw:
                q_prop = q_prop_s
            logw = float(np.logaddexp(logw, logw_s))
        turning_traj = (not bad) and bool(_uturn(q_left, p_left, q_right, p_right, inv_mass))
        diverged = diverged or diverged_s
        turning = turning or turning_s or turning_traj
        depth += 1
    return q_prop, sum_accept / max(n_leaves, 1), diverged


class _DAState(NamedTuple):
    log_eps: float
    log_eps_avg: float
    h_avg: float
    mu: float
    t: float


def _da_init(eps0: float) -> _DAState:
    return _DAState(math.log(eps0), math.log(eps0), 0.0, math.log(10.0 * eps0), 0.0)


def _da_update(s: _DAState, accept_stat: float, target: float) -> _DAState:
    # Nesterov dual averaging (Hoffman & Gelman 2014, §3.2)
    gamma, t0, kappa = 0.05, 10.0, 0.75
    t = s.t + 1.0
    h_avg = (1.0 - 1.0 / (t + t0)) * s.h_avg + (target - accept_stat) / (t + t0)
    log_eps = s.mu - math.sqrt(t) / gamma * h_avg
    w = t ** (-kappa)
    log_eps_avg = w * log_eps + (1.0 - w) * s.log_eps_avg
    return _DAState(log_eps, log_eps_avg, h_avg, s.mu, t)


def nuts_sample(logdensity_fn: Callable, init_position, generator, num_samples: int = 1000,
                num_warmup: int = 500, max_depth: int = 8, target_accept: float = 0.8,
                init_step_size: float = 0.1):
    """Adaptive NUTS. Returns (samples, info).

    - ``logdensity_fn(position) -> scalar`` log target density (a tree of
      tensors in);
    - samples: the position's tree with a leading axis ``num_samples``;
    - info: ``accept_stat`` and ``diverging`` per kept draw, the final
      ``step_size`` and ``inv_mass``.

    Warmup as Stan's: 15 % step size only, 60 % step size and the diagonal
    mass (Welford), 25 % step size under the new mass; the dual averaging
    restarts when the mass changes.
    """
    leaves = tree_leaves(init_position)
    shapes = [tuple(x.shape) for x in leaves]
    sizes = [int(np.prod(s)) for s in shapes]
    dev = generator.device
    q = torch.cat([torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(-1)
                   for x in leaves])
    D = q.shape[0]

    def unravel(flat):
        parts = torch.split(flat, sizes, dim=-1)
        lead = tuple(flat.shape[:-1])
        return tree_unflatten(init_position, [p.reshape(lead + s)
                                              for p, s in zip(parts, shapes)])

    def value_and_grad(qf):
        with torch.enable_grad():
            qf = qf.detach().requires_grad_(True)
            v = torch.as_tensor(logdensity_fn(unravel(qf)), dtype=torch.float32)
            (g,) = torch.autograd.grad(v, qf)
        return v.detach(), g

    def transition(q, step_size, inv_mass):
        return _nuts_transition(value_and_grad, q, generator, step_size, inv_mass, max_depth)

    n1 = max(int(0.15 * num_warmup), 1)
    n3 = max(int(0.25 * num_warmup), 1)
    n2 = max(num_warmup - n1 - n3, 1)
    inv_mass = torch.ones((D,), device=dev)
    da = _da_init(init_step_size)
    for _ in range(n1):  # I: step size only
        q, acc, _ = transition(q, math.exp(da.log_eps), inv_mass)
        da = _da_update(da, acc, target_accept)
    mean, m2 = torch.zeros((D,), device=dev), torch.zeros((D,), device=dev)
    for n in range(1, n2 + 1):  # II: step size and the mass
        q, acc, _ = transition(q, math.exp(da.log_eps), inv_mass)
        da = _da_update(da, acc, target_accept)
        delta = q - mean
        mean = mean + delta / n
        m2 = m2 + delta * (q - mean)
    var = m2 / max(n2 - 1.0, 1.0)
    # Stan's shrinkage toward unit variance
    inv_mass = var * (n2 / (n2 + 5.0)) + 1e-3 * (5.0 / (n2 + 5.0))
    da = _da_init(math.exp(da.log_eps_avg))
    for _ in range(n3):  # III: the step size under the new mass
        q, acc, _ = transition(q, math.exp(da.log_eps), inv_mass)
        da = _da_update(da, acc, target_accept)
    step_size = math.exp(da.log_eps_avg)
    qs, accs, divs = [], [], []
    for _ in range(num_samples):
        q, acc, div = transition(q, step_size, inv_mass)
        qs.append(q)
        accs.append(acc)
        divs.append(div)
    info = {"accept_stat": torch.tensor(accs, dtype=torch.float32),
            "diverging": torch.tensor(divs, dtype=torch.bool),
            "step_size": torch.tensor(step_size, dtype=torch.float32),
            "inv_mass": inv_mass}
    return unravel(torch.stack(qs)), info
