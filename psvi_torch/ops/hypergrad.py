"""Implicit-differentiation hypergradient solvers over parameter trees.

Counterpart of ``psvi_tpu/ops/hypergrad.py`` (ref the vendored hypertorch
stack, ``psvi/hypergrad/hypergradients.py``), over the port's trees of
tensors (``utils/tree.py``):

- ``cg_solve``     — conjugate gradient, exactly K iterations, x₀ = 0, zero
  denominators guarded, no early exit (ref ``CG_torch.py:9-45``);
- ``cg_normaleq``  — CG on the normal equations (ref :199-244), the solver
  of every ``hyper_step`` in the reference;
- ``neumann``      — the Neumann series (ref :247-278);
- ``fixed_point``  — fixed-point iteration (ref :83-140);
- ``exact``, ``reverse_unroll`` — plain reverse mode through a closed-form
  or an unrolled, differentiable inner solve (ref :14-80, :281-294).

The fixed-point map ``Φ(w, λ) = w − η ∇_w L_inner(w, λ; ε)`` is one gradient
step on the inner loss. Jacobian products come from ``torch.func.vjp``
(JᵀX) and ``torch.func.jvp`` (JX, forward over reverse), with ∇_w from
``torch.func.grad`` inside ``fp_map``.

Noise: ``fp_map(params, hyper, tag)`` takes a tag that names its noise
draw, and the caller maps each tag to one draw (the same tag, the same
noise). The solvers use JAX's pattern of draws per product:
``cg_normaleq`` one draw (tag ``"vjp"``) for every Jᵀ product and for
∂Φ/∂λ, and a fresh one for each J product (tags ``("jvp", i)``, i = −1 for
the right-hand side, then 0…K−1); ``fixed_point`` a fresh draw per
iteration (tags 0…K−1) and tag K for ∂Φ/∂λ; ``neumann`` one draw (tag
``"vjp"``).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from psvi_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def tree_dot(a, b):
    """Σ over leaves of ⟨a, b⟩, a 0-d tensor."""
    return sum(torch.sum(x * y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def tree_add(a, b, scale=1.0):
    """``a + scale·b`` leafwise."""
    return tree_map(lambda x, y: x + scale * y, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: s * x, a)


def cg_solve(matvec: Callable, b, K: int):
    """Solve A x = b (A symmetric positive definite) with exactly K
    conjugate-gradient iterations from x₀ = 0, in the reference's update
    order. ``matvec(x, i)`` gets the iteration index, for its noise tag."""
    x = tree_map(torch.zeros_like, b)
    r = p = b
    rtr = tree_dot(r, r)
    for i in range(K):
        Ap = matvec(p, i)
        pAp = tree_dot(p, Ap)
        alpha = rtr / torch.where(pAp == 0, torch.ones_like(pAp), pAp)
        x = tree_add(x, p, alpha)
        r = tree_add(r, Ap, -alpha)
        rtr_new = tree_dot(r, r)
        beta = rtr_new / torch.where(rtr == 0, torch.ones_like(rtr), rtr)
        p = tree_add(r, p, beta)
        rtr = rtr_new
    return x


class HyperGrads(NamedTuple):
    hyper_grads: Any
    outer_loss: torch.Tensor


def value_and_grad(fn, tree):
    """``fn(tree)`` and its gradient with respect to every leaf of ``tree``
    (zeros for a leaf ``fn`` does not read), through ``torch.autograd``."""
    with torch.enable_grad():
        leaves = tree_map(lambda x: x.detach().requires_grad_(True), tree)
        loss = fn(leaves)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(flat, grads)]
    return loss.detach(), tree_unflatten(tree, grads)


def _outer_grads(outer_loss_fn, params, hyper):
    loss, g = value_and_grad(lambda t: outer_loss_fn(t[0], t[1]), (params, hyper))
    return loss, g[0], g[1]


def _vjp_hyper(fp_map, params, hyper, tag, cot):
    """(∂Φ/∂λ)ᵀ cot at ``params``."""
    _, vjp_h = torch.func.vjp(lambda h: fp_map(params, h, tag), hyper)
    return vjp_h(cot)[0]


def cg_normaleq(fp_map: Callable, outer_loss_fn: Callable, params, hyper, K: int) -> HyperGrads:
    """CG on the normal equations (ref ``hypergradients.py:199-244``): solve
    (I − J)(I − Jᵀ) v = (I − J) g_w, then the hypergradient is
    (∂Φ/∂λ)ᵀ v + g_λ, with J = ∂Φ/∂w at the inner solution ``params``."""
    loss, g_w, g_h = _outer_grads(outer_loss_fn, params, hyper)
    # the Jᵀ side reuses one draw (ref :213-216); each J product draws anew
    _, vjp_fn = torch.func.vjp(lambda p: fp_map(p, hyper, "vjp"), params)

    def J(x, i):
        return torch.func.jvp(lambda p: fp_map(p, hyper, ("jvp", i)), (params,), (x,))[1]

    def matvec(x, i):
        v1 = tree_add(x, vjp_fn(x)[0], -1.0)  # (I − Jᵀ) x
        return tree_add(v1, J(v1, i), -1.0)  # (I − J)(I − Jᵀ) x

    b = tree_add(g_w, J(g_w, -1), -1.0)  # (I − J) g_w
    vs = cg_solve(matvec, b, K)
    return HyperGrads(tree_add(g_h, _vjp_hyper(fp_map, params, hyper, "vjp", vs)), loss)


def neumann(fp_map: Callable, outer_loss_fn: Callable, params, hyper, K: int) -> HyperGrads:
    """Neumann series (ref ``hypergradients.py:247-278``):
    g = Σ_{k=0..K} (Jᵀ)^k g_w, hypergradient (∂Φ/∂λ)ᵀ g + g_λ; every product
    shares one draw, as the reference reuses one graph (:264-269)."""
    loss, g_w, g_h = _outer_grads(outer_loss_fn, params, hyper)
    _, vjp_fn = torch.func.vjp(lambda p: fp_map(p, hyper, "vjp"), params)
    vs = gs = g_w
    for _ in range(K):
        vs = vjp_fn(vs)[0]
        gs = tree_add(gs, vs)
    return HyperGrads(tree_add(g_h, _vjp_hyper(fp_map, params, hyper, "vjp", gs)), loss)


def fixed_point(fp_map: Callable, outer_loss_fn: Callable, params, hyper, K: int) -> HyperGrads:
    """Fixed-point iteration (ref ``hypergradients.py:83-140``,
    stochastic=True): v ← Jᵀ v + g_w, K times, each with its own draw;
    hypergradient (∂Φ/∂λ)ᵀ v + g_λ."""
    loss, g_w, g_h = _outer_grads(outer_loss_fn, params, hyper)
    vs = tree_map(torch.zeros_like, g_w)
    for i in range(K):
        _, vjp_fn = torch.func.vjp(lambda p, i=i: fp_map(p, hyper, i), params)
        vs = tree_add(vjp_fn(vs)[0], g_w)
    return HyperGrads(tree_add(g_h, _vjp_hyper(fp_map, params, hyper, K, vs)), loss)


def exact(opt_params_f: Callable, outer_loss_fn: Callable, hyper) -> HyperGrads:
    """Reverse mode through a closed-form inner solution
    ``opt_params_f(hyper)`` (ref ``hypergradients.py:281-294``)."""
    loss, grads = value_and_grad(lambda h: outer_loss_fn(opt_params_f(h), h), hyper)
    return HyperGrads(grads, loss)


def reverse_unroll(inner_solver: Callable, outer_loss_fn: Callable, hyper) -> HyperGrads:
    """Reverse mode through a differentiable unrolled inner solve
    ``inner_solver(hyper)`` (ref ``hypergradients.py:14-80``): what the
    engine's nested trainer does; the reference's checkpointed ``reverse``
    corresponds to ``remat_inner=True``."""
    loss, grads = value_and_grad(lambda h: outer_loss_fn(inner_solver(h), h), hyper)
    return HyperGrads(grads, loss)
