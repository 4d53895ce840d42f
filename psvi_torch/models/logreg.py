"""Bayesian logistic regression for the coreset baselines.

Counterpart of ``psvi_tpu/models/logreg.py``:

- ``logreg_forward``  — the MC-mean sigmoid predictive;
- ``bernoulli_ll`` / ``bernoulli_ll_multi`` — per-point log-likelihoods for
  one θ or S of them; ``log_prior`` — the N(μ0, σ0²) prior;
- ``laplace_precision`` — the diagonal or full Hessian of the weighted
  negative log-joint;
- ``run_laplace_from`` — the MAP continued from θ0 by ``inner_it`` Adam
  steps (``ops/optim.py::adam`` on the closed-form gradient, one host loop
  of small launches), then
  samples of the Laplace approximation; ``run_laplace`` from a fresh
  N(0, I) θ0;
- ``evaluate_coreset_laplace`` — accuracy and NLL of a weighted coreset's
  Laplace posterior; ``mcmc_sample`` — NUTS on the same posterior
  (``ops/nuts.py``).

JAX's ``key`` arguments become a ``torch.Generator``; θ0 and the Laplace
noise are drawn through ``utils/draws.normal``, θ0 first, the noise after
the fit, as JAX draws them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from psvi_torch.ops import optim as O
from psvi_torch.utils import draws

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def logreg_forward(thetas, x):
    """MC-mean sigmoid predictive: thetas (S, D), x (N, D) → (N,)."""
    return torch.sigmoid(x @ thetas.T).mean(dim=1)


def bernoulli_ll(theta, x, y):
    """Per-point Bernoulli log-likelihood log p(y | xᵀθ): theta (D,) → (N,)."""
    logits = x @ theta
    return y * F.logsigmoid(logits) + (1.0 - y) * F.logsigmoid(-logits)


def bernoulli_ll_multi(thetas, x, y):
    """(N, S) log-likelihood matrix for S parameter samples."""
    logits = x @ thetas.T
    return y[:, None] * F.logsigmoid(logits) + (1.0 - y)[:, None] * F.logsigmoid(-logits)


def log_prior(theta, mu0=0.0, sigma0=1.0):
    return torch.sum(-0.5 * torch.square((theta - mu0) / sigma0)
                     - math.log(sigma0) - _HALF_LOG_2PI)


def laplace_precision(z_core, theta, w, diagonal=True):
    """Hessian of the weighted negative log-joint at θ (negative weights
    count as 0)."""
    p = torch.sigmoid(z_core @ theta)
    d = p * (1.0 - p) * torch.clamp_min(w, 0.0)
    a = z_core.T * torch.sqrt(d)  # (D, M)
    if diagonal:
        return torch.sum(torch.square(a), dim=1) + 1.0
    return torch.eye(z_core.shape[1], dtype=a.dtype, device=a.device) + a @ a.T


def _neg_log_joint_grad(theta, x, wy, wny):
    """∇θ of −Σ w·ll(θ) − log N(θ; 0, I), term for term as JAX's autodiff
    forms it: ∂/∂l of y·log σ(l) + (1−y)·log σ(−l) is y·σ(−l) − (1−y)·σ(l);
    ``wy`` = w·y and ``wny`` = w·(1−y)."""
    logits = x @ theta
    g_logits = wy * torch.sigmoid(-logits) - wny * torch.sigmoid(logits)
    return theta - x.T @ g_logits


def run_laplace_from(generator, theta0, x_core, y_core, w_core, inner_it: int = 1000,
                     mc_samples: int = 4, diagonal: bool = True, lr0net: float = 1e-3):
    """The MAP continued from ``theta0`` by ``inner_it`` Adam steps on the
    weighted negative log-joint (its gradient in closed form, a few small
    launches a step), then ``mc_samples`` Laplace samples. Returns ((S, D)
    samples, final θ)."""
    D = x_core.shape[1]
    opt = O.adam(lr0net)
    theta = theta0.detach()
    state = opt.init(theta)
    wy, wny = w_core * y_core, w_core * (1.0 - y_core)
    for _ in range(inner_it):
        theta, state = opt.step(theta, _neg_log_joint_grad(theta, x_core, wy, wny), state)
    prec = laplace_precision(x_core, theta, w_core, diagonal=diagonal)
    eps = draws.normal(generator, (mc_samples, D))
    if diagonal:
        samples = theta + eps * prec ** -0.5
    else:
        # Σ = P⁻¹; θ + L ε with L = chol(Σ)
        L = torch.linalg.cholesky(torch.linalg.inv(prec))
        samples = theta + eps @ L.T
    return samples, theta


def run_laplace(generator, x_core, y_core, w_core, inner_it: int = 1000, mc_samples: int = 4,
                diagonal: bool = True, lr0net: float = 1e-3):
    """The MAP from a fresh N(0, I) θ0, then Laplace samples (S, D)."""
    theta0 = draws.normal(generator, (x_core.shape[1],))
    samples, _ = run_laplace_from(generator, theta0, x_core, y_core, w_core,
                                  inner_it=inner_it, mc_samples=mc_samples,
                                  diagonal=diagonal, lr0net=lr0net)
    return samples


def predictive_scores(probs, y_test):
    """Accuracy and mean NLL of the predictive probabilities (tensors)."""
    acc = torch.mean(((probs > 0.5).to(torch.float32) == y_test).to(torch.float32))
    p = torch.clamp_min(torch.where(y_test > 0.5, probs, 1.0 - probs), 1e-38)
    return acc, -torch.mean(torch.log(p))


def evaluate_coreset_laplace(generator, x_core, y_core, w_core, x_test, y_test, inner_it=1000,
                             mc_samples=4, lr0net=1e-3):
    """MAP + Laplace evaluation of a weighted coreset: (accuracy, NLL)."""
    samples = run_laplace(generator, x_core, y_core, w_core, inner_it=inner_it,
                          mc_samples=mc_samples, lr0net=lr0net)
    return predictive_scores(logreg_forward(samples, x_test), y_test)


def mcmc_sample(generator, x_core, y_core, w_core, num_samples: int = 1000,
                num_warmup: int = 500, max_depth: int = 8):
    """NUTS on the weighted logreg coreset posterior (N(0, 1) prior; the
    reference's Stan program, shipped disabled). Returns ((num_samples, D)
    θ draws, info dict)."""
    from psvi_torch.ops.nuts import nuts_sample

    dev = generator.device
    x = torch.as_tensor(x_core, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y_core, dtype=torch.float32, device=dev)
    w = torch.clamp_min(torch.as_tensor(w_core, dtype=torch.float32, device=dev), 0.0)

    def logdensity(theta):
        return torch.dot(w, bernoulli_ll(theta, x, y)) + log_prior(theta)

    theta0 = torch.zeros((x.shape[1],), dtype=torch.float32, device=dev)
    return nuts_sample(logdensity, theta0, generator, num_samples=num_samples,
                       num_warmup=num_warmup, max_depth=max_depth)
