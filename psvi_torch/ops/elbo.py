"""Core PSVI objectives as functional PyTorch.

Counterpart of ``psvi_tpu/ops/elbo.py``, term for term:

- ``inner_elbo``  — negative inner ELBO of q on the weighted pseudodata
  (ref ``psvi_classes.py:488-511``): ``Σ_s Σ_m N·f(v)_m·NLL(u_m, z_m; θ_s)
  + KL(q‖p)`` (a sum, not a mean, over the S samples);
- ``psvi_elbo``   — negative outer PSVI-ELBO, the self-normalized
  importance-sampling estimate over S samples (ref ``:445-486``);
- ``ablated_elbo`` — the PSVI_Ablated objective, a plain multi-sample ELBO
  on the data batch (ref ``:1397-1408``);
- ``soft_label_nll`` — the KLDiv NLL of learned soft labels (learn_z with
  the categorical likelihood, ref ``:464-474,495-505``);
- ``importance_log_weights`` / ``predictive_mixture`` — the evaluation-time
  weighting (ref ``:1031-1108``), including the reference's sign quirk;
- ``iw_diagnostics`` — IW entropy, normalized ESS, v entropy.

Every function takes the sampled noise ``eps`` explicitly, so ``nkl`` uses
the same parameter samples as the forward.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def categorical_nll(logits, labels):
    """``-Categorical(logits).log_prob(y)``: logits (S, N, nc), labels (N,) → (S, N)."""
    logz = torch.logsumexp(logits, dim=-1)
    idx = labels.long().view(1, -1, 1).expand(logits.shape[0], -1, 1)
    picked = torch.gather(logits, -1, idx)[..., 0]
    return logz - picked


def soft_label_nll(logits, soft_targets):
    """KL-divergence loss of learnable soft labels: logits (S, N, nc), raw
    label logits z (N, nc) → (S, N). The target is ``softmax(z)`` over the
    *datapoint* axis, as in the reference; then ``nll[s, n] = Σ_c p[n, c]·
    (log p[n, c] − log_softmax(logits)[s, n, c])`` (torch
    ``KLDivLoss(reduction='none')`` summed over classes)."""
    p = torch.softmax(soft_targets, dim=0)
    logp = torch.log(torch.clamp_min(p, 1e-38))
    log_q = torch.log_softmax(logits, dim=-1)
    plogp = torch.where(p > 0, p * logp, 0.0)
    return torch.sum(plogp[None] - p[None] * log_q, dim=-1)


def gaussian_nll(preds, targets, tau: float):
    """Gaussian NLL with precision tau: preds (S, N), targets (N,) → (S, N)."""
    scale = 1.0 / math.sqrt(float(tau))
    return (
        0.5 * torch.square((targets[None] - preds) / scale)
        + math.log(scale)
        + HALF_LOG_2PI
    )


def nll_fn(likelihood: str, learn_z: bool, nc: int, tau: Optional[float] = None):
    """Returns nll(outputs, labels) → (S, N) for the configured likelihood."""
    if likelihood == "categorical":
        return soft_label_nll if learn_z else categorical_nll
    if likelihood == "gaussian":
        def nll(preds, y):
            preds = preds.squeeze(-1) if preds.dim() == 3 else preds
            y = y.squeeze(-1) if y.dim() == 2 else y
            return gaussian_nll(preds, y, tau)
        return nll
    raise ValueError(f"unknown likelihood {likelihood!r}")


def inner_elbo(net, params, eps, u, z, core_weights, likelihood: str = "categorical",
               learn_z: bool = False, nc: int = 2, tau: Optional[float] = None):
    """Negative inner ELBO: ``Σ_s Σ_m core_weights_m·NLL + KL``."""
    nll = nll_fn(likelihood, learn_z, nc, tau)
    kl = net.kl(params)
    if u.shape[0] == 0:
        return kl
    out = net.apply(params, eps, u)
    pseudo_nll = nll(out, z) @ core_weights  # (S,)
    return torch.sum(pseudo_nll) + kl


def psvi_elbo(net, params, eps, u, z, core_weights, xbatch, ybatch, N: int,
              likelihood: str = "categorical", learn_z: bool = False, nc: int = 2,
              tau: Optional[float] = None):
    """Negative outer PSVI-ELBO; one forward over ``concat(u, xbatch)`` so
    pseudo- and data-NLLs share the θ samples (ref ``:451-463``)."""
    M, B = u.shape[0], xbatch.shape[0]
    all_x = torch.cat([u, xbatch], dim=0)
    if learn_z:
        # ref :455-461: the batch labels become nc·one_hot rows appended to
        # z, so the datapoint softmax of the soft-label NLL runs over M + B
        onehot = torch.nn.functional.one_hot(ybatch.long(), nc).to(z.dtype)
        all_y = torch.cat([z, nc * onehot], dim=0)
    elif likelihood == "gaussian":
        all_y = torch.cat([z.reshape(-1), ybatch.reshape(-1)], dim=0)
    else:
        all_y = torch.cat([z, ybatch], dim=0)
    out = net.apply(params, eps, all_x)
    all_nlls = nll_fn(likelihood, learn_z, nc, tau)(out, all_y)  # (S, M+B)
    if M > 0:
        pseudo_nll = all_nlls[:, :M] @ core_weights
    else:
        pseudo_nll = torch.zeros(all_nlls.shape[0], device=all_nlls.device)
    data_nll = (N / B) * torch.sum(all_nlls[:, M:], dim=-1)
    sampled_nkl = net.nkl(params, eps)  # (S,)
    log_weights = -pseudo_nll + sampled_nkl
    weights = torch.softmax(log_weights, dim=0)
    # Σ_s w_s·d_s, with d centred at its (constant) weighted mean: the same
    # value and gradient, but the softmax VJP then sees d − d̄ instead of
    # d ~ 10², so its coefficients sum to zero in fp32 as they do exactly.
    d = data_nll - pseudo_nll
    d_ref = torch.sum(weights * d).detach()
    return d_ref + torch.sum(weights * (d - d_ref)) - torch.mean(log_weights)


def ablated_elbo(net, params, eps, xbatch, ybatch, N: int, likelihood: str = "categorical",
                 nc: int = 2, tau: Optional[float] = None):
    """PSVI_Ablated objective: the plain multi-sample ELBO on the data batch,
    with no importance weighting (ref ``psvi_classes.py:1397-1408``):
    ``mean_s data_nll_s − mean_s sampled_nkl_s``. Its sums carry no IW
    coefficients, so nothing here needs the centring of ``psvi_elbo``."""
    B = xbatch.shape[0]
    out = net.apply(params, eps, xbatch)
    data_nll = (N / B) * torch.sum(nll_fn(likelihood, False, nc, tau)(out, ybatch), dim=-1)
    return torch.mean(data_nll) - torch.mean(net.nkl(params, eps))


def importance_log_weights(net, params, eps, u, z, core_weights,
                           likelihood: str = "categorical", learn_z: bool = False,
                           nc: int = 2, tau: Optional[float] = None, pseudo_out=None):
    """Evaluation-time importance log-weights (ref ``psvi_classes.py:1045-1070``).

    Reference quirk, kept deliberately: the pseudo term is the *positive*
    log_prob weighted by ``core_weights`` and then negated —
    ``log_weights = −pseudo + sampled_nkl`` — the opposite sign convention
    from the training objective. Under learn_z the KLDiv term is summed over
    S before it is weighted, which gives a scalar (ref ``:1052-1056``).
    """
    if u.shape[0] == 0:
        pseudo = 0.0
    else:
        if pseudo_out is None:
            pseudo_out = net.apply(params, eps, u)
        nll = nll_fn(likelihood, learn_z, nc, tau)
        if learn_z:
            # the (S, M) KLDiv summed over S, then weighted: a scalar
            pseudo = torch.sum(nll(pseudo_out, z), dim=0) @ core_weights
        elif likelihood == "gaussian":
            pseudo = torch.sum(-nll(pseudo_out, z) * core_weights[None, :])
        else:
            pseudo = -nll(pseudo_out, z) @ core_weights  # (S,)
    return -pseudo + net.nkl(params, eps)


def predictive_mixture(test_logits, log_weights, correction: bool = True):
    """Importance-weighted mixture of per-sample predictive distributions.

    test_logits (S, N, nc) → (probs (N, nc), weights (S,)); ``correction=
    False`` gives plain MC averaging (ref ``psvi_classes.py:1072-1080``)."""
    probs_s = torch.softmax(test_logits, dim=-1)
    weights = torch.softmax(log_weights, dim=0)
    if correction:
        probs = torch.einsum("s,snc->nc", weights, probs_s)
    else:
        probs = torch.mean(probs_s, dim=0)
    return probs, weights


def iw_diagnostics(weights, v_weights, num_pseudo: int):
    """IW entropy, normalized ESS and v 'entropy' (ref ``psvi_classes.py:1085-1101``)."""
    w = weights
    iw_entropy = -torch.sum(
        torch.where(w > 0, w * torch.log(torch.clamp_min(w, 1e-38)), 0.0)
    )
    ness = torch.square(torch.sum(w)) / torch.sum(torch.square(w)) / w.shape[0]
    vs = v_weights
    v_entropy = torch.square(torch.sum(vs)) / torch.sum(torch.square(vs)) / num_pseudo
    return iw_entropy, ness, v_entropy
