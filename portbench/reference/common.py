"""The plain nested PSVI step, written from the method's equations.

This is the yardstick that decides ``correct``: plain PyTorch, autograd
through the unroll, nothing of the program imported. A model (``lenet.py``)
gives its forward over sampled weights and which layers
carry a KL term; this module gives the rest of the bilevel step:

- each variational layer samples θ = μ + softplus(ρ)·ε per MC sample;
- the inner loss on the weighted pseudodata (u, z) is
  ``Σ_s Σ_m cw_m·NLL(u_m, z_m; θ_s) + KL(q‖p)``, cw = N·softmax(v);
- T inner Adam steps (torch.optim.Adam's rule, bias-corrected moments,
  ``denom = √n/√(1−β₂ᵗ) + eps``) from the net's current parameters, kept
  differentiable (``create_graph=True``);
- the outer loss is the self-normalised importance-weighted ELBO on
  (u, minibatch) at the inner solution: with the per-sample log weights
  ``lw_s = −Σ_m cw_m·NLL_sm + Σ_layers (log p(θ_s) − log q(θ_s))`` and
  ``w = softmax_s(lw)``, it is ``Σ_s w_s·(N/B·Σ_b NLL_sb − Σ_m cw_m·NLL_sm)
  − mean_s lw_s``;
- its gradient with respect to u and v through the whole unroll, and one
  hyper-Adam step on each.

Two numerical choices follow the method's definition and not any code:
the square root in Adam's denominator has derivative 0 at 0 (the
subgradient on a parameter whose inner gradient is exactly 0, where √'
is infinite), and the outer sum is taken with the data term centred at
its weighted mean, which has the same value and gradient but keeps the
softmax's cotangents summing to zero in float32.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence

import torch

HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
KEYS = ("mu_w", "rho_w", "mu_b", "rho_b")


class Model(NamedTuple):
    """``forward(thetas, x)``: logits (S, N, nc) for per-layer sampled
    ``(w (S, ...), b (S, out))`` and inputs x (N, ...); ``kl_layers``: the
    indices of the layers whose KL and log-density ratio count."""

    forward: Callable
    kl_layers: Sequence[int]


class Hyper(NamedTuple):
    N: float
    T: int
    lr_net: float
    lr_u: float
    lr_v: float
    prior_sd: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    adam_eps: float = 1e-8


def softplus(x):
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def sqrt0(x):
    """√x with derivative 0 at x = 0 (every order finite)."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))), 0.0)


def normal_logpdf(x, mu, sd):
    return -0.5 * torch.square((x - mu) / sd) - torch.log(sd) - HALF_LOG_2PI


def categorical_nll(logits, labels):
    """(S, N, nc), (N,) → (S, N)."""
    picked = torch.gather(logits, -1, labels.long().view(1, -1, 1).expand(
        logits.shape[0], -1, 1))[..., 0]
    return torch.logsumexp(logits, dim=-1) - picked


def sample(layers, eps):
    """Per layer (w, b) = μ + softplus(ρ)·ε."""
    return [(p["mu_w"] + softplus(p["rho_w"]) * e[0], p["mu_b"] + softplus(p["rho_b"]) * e[1])
            for p, e in zip(layers, eps)]


def kl_term(model: Model, layers, prior_sd: float):
    total = 0.0
    for i in model.kl_layers:
        p = layers[i]
        for mu, rho in ((p["mu_w"], p["rho_w"]), (p["mu_b"], p["rho_b"])):
            sd = softplus(rho)
            total = total + torch.sum(math.log(prior_sd) - torch.log(sd)
                                      + (sd * sd + mu * mu) / (2.0 * prior_sd ** 2) - 0.5)
    return total


def log_ratio(model: Model, layers, thetas, prior_sd: float):
    """Per sample Σ_layers log p(θ_s) − log q(θ_s): (S,)."""
    total = 0.0
    for i in model.kl_layers:
        p, (w, b) = layers[i], thetas[i]
        sp = torch.tensor(prior_sd, dtype=w.dtype, device=w.device)
        for th, mu, rho in ((w, p["mu_w"], p["rho_w"]), (b, p["mu_b"], p["rho_b"])):
            dims = tuple(range(1, th.dim()))
            total = total + torch.sum(normal_logpdf(th, 0.0, sp)
                                      - normal_logpdf(th, mu, softplus(rho)), dim=dims)
    return total


def inner_loss(model: Model, layers, eps, u, z, cw, prior_sd: float):
    nll = categorical_nll(model.forward(sample(layers, eps), u), z)
    return torch.sum(nll @ cw) + kl_term(model, layers, prior_sd)


def outer_loss(model: Model, layers, eps, u, z, cw, xb, yb, N: float, prior_sd: float):
    M, B = u.shape[0], xb.shape[0]
    thetas = sample(layers, eps)
    nll = categorical_nll(model.forward(thetas, torch.cat([u, xb])), torch.cat([z, yb]))
    pseudo = nll[:, :M] @ cw
    data = (N / B) * torch.sum(nll[:, M:], dim=1)
    lw = -pseudo + log_ratio(model, layers, thetas, prior_sd)
    w = torch.softmax(lw, dim=0)
    d = data - pseudo
    d_ref = torch.sum(w * d).detach()
    return d_ref + torch.sum(w * (d - d_ref)) - torch.mean(lw)


def adam(p, m, n, g, t: int, lr: float, hp: Hyper):
    bc1 = 1.0 - hp.b1 ** t
    bc2s = math.sqrt(1.0 - hp.b2 ** t)
    m = hp.b1 * m + (1.0 - hp.b1) * g
    n = hp.b2 * n + (1.0 - hp.b2) * g * g
    return p - lr * (m / bc1) / (sqrt0(n) / bc2s + hp.adam_eps), m, n


def flat(layers):
    return [p[k] for p in layers for k in KEYS]


def nest(leaves, like):
    it = iter(leaves)
    return [{k: next(it) for k in KEYS} for _ in like]


class HyperAdam(NamedTuple):
    t: int
    m: torch.Tensor
    n: torch.Tensor


def hyper_adam(x, g, st: HyperAdam, lr: float, hp: Hyper):
    t = st.t + 1
    x, m, n = adam(x, st.m, st.n, g, t, lr, hp)
    return x, HyperAdam(t, m, n)


def nested_step(model: Model, layers, u, z, v, opt_u: HyperAdam, opt_v: HyperAdam,
                xb, yb, eps_inner, eps_outer, hp: Hyper):
    """One bilevel step. ``eps_inner``: T lists of per-layer (w, b) noise;
    ``eps_outer``: one such list. Returns ``(layers_T, u, v, opt_u, opt_v,
    record)``; ``record`` holds the outer loss, the T inner losses, the
    hypergradients of u and v and the first inner iteration's gradient of
    every net leaf."""
    with torch.enable_grad():
        u_ = u.detach().clone().requires_grad_(True)
        v_ = v.detach().clone().requires_grad_(True)
        cw = hp.N * torch.softmax(v_, dim=0)
        p = [x.detach().clone().requires_grad_(True) for x in flat(layers)]
        m = [torch.zeros_like(x) for x in p]
        n = [torch.zeros_like(x) for x in p]
        inner, g_first = [], None
        for t in range(1, hp.T + 1):
            loss_t = inner_loss(model, nest(p, layers), eps_inner[t - 1], u_, z, cw, hp.prior_sd)
            g = torch.autograd.grad(loss_t, p, create_graph=True)
            if g_first is None:
                g_first = [x.detach() for x in g]
            stepped = [adam(pi, mi, ni, gi, t, hp.lr_net, hp) for pi, mi, ni, gi in zip(p, m, n, g)]
            p, m, n = (list(x) for x in zip(*stepped))
            inner.append(loss_t.detach())
        loss = outer_loss(model, nest(p, layers), eps_outer, u_, z, cw, xb, yb, hp.N,
                          hp.prior_sd)
        g_u, g_v = torch.autograd.grad(loss, [u_, v_])
    u_new, opt_u = hyper_adam(u.detach(), g_u, opt_u, hp.lr_u, hp)
    v_new, opt_v = hyper_adam(v.detach(), g_v, opt_v, hp.lr_v, hp)
    record = {"outer_loss": loss.detach(), "inner_losses": torch.stack(inner),
              "g_u": g_u.detach(), "g_v": g_v.detach(), "g_net": g_first}
    return nest([x.detach() for x in p], layers), u_new, v_new, opt_u, opt_v, record
