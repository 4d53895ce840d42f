"""Sparse black-box VI: an incremental coreset under the PSVI ELBO.

Counterpart of ``psvi_tpu/inference/sparsebbvi.py`` (ref
``psvi/inference/sparsebbvi.py:28-198``, ``run_sparsevi_with_bb_elbo``):
grow a coreset greedily by the correlation of per-sample centred
log-likelihoods with the residual, and fit the full-length weight vector
on the generalized (self-normalized IW) PSVI-ELBO, through a net-based
variational posterior rather than a Laplace approximation. The coreset
lives in a buffer of ``num_epochs + 1`` slots with a 0/1 mask, as in JAX.

The three steps of an epoch are functions of their noise (``eps`` lists,
else drawn), so a test can hold each against JAX: ``inner_steps`` (the
ELBO on the coreset, gradients accumulated over the inner loop as the
reference's single ``zero_grad`` an epoch does), ``select_stats`` (the
greedy step's correlations) and ``outer_steps`` (projected Adam on w).
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from psvi_torch.device import resolve_device
from psvi_torch.models.networks import make_fcnet, make_logreg
from psvi_torch.ops import optim as O
from psvi_torch.utils import draws
from psvi_torch.utils.tree import tree_map, value_and_grad


def _bernoulli_ll(logits, y):
    """(S, N) Bernoulli log-likelihood; y broadcast over the samples."""
    return y[None] * F.logsigmoid(logits) + (1.0 - y)[None] * F.logsigmoid(-logits)


class SparseBBVI:
    """The state and the three steps of one ``run_sparsevi_with_bb_elbo``."""

    def __init__(self, x, y, xt, yt, mc_samples=4, data_minibatch=128, num_epochs=100,
                 inner_it=10, outer_it=10, n_layers=1, n_hidden=40, logistic_regression=True,
                 lr0=1e-3, seed=0, device=None):
        dev = self.device = resolve_device(device)
        self.x, self.y, self.xt, self.yt = (torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                                            device=dev) for a in (x, y, xt, yt))
        self.N, D = self.x.shape
        self.S, self.inner_it, self.outer_it = mc_samples, inner_it, outer_it
        self.net = (make_logreg(D, 1, init_sd=0.01) if logistic_regression
                    else make_fcnet(D, n_hidden, 1, n_layers=n_layers, init_sd=0.01)).to(dev)
        self.gen = draws.generator(seed, dev)
        self.params = draws.init_params(self.net, self.gen)
        self.opt_net = O.adam(lr0)
        self.opt_net_state = self.opt_net.init(self.params)
        self.w = torch.zeros(self.N, device=dev)
        self.opt_w = O.adam(lr0)
        self.opt_w_state = self.opt_w.init(self.w)
        self.CAP = num_epochs + 1  # one point at most joins an epoch
        self.core_x = torch.zeros((self.CAP, D), device=dev)
        self.core_y = torch.zeros((self.CAP,), device=dev)
        self.core_mask = torch.zeros((self.CAP,), device=dev)
        self.core_ids = np.full(self.CAP, -1, np.int64)
        self.n_core = 0
        self.B = min(data_minibatch, self.N)
        self.sum_scaling = self.N / self.B

    def _eps(self, eps, i):
        return eps[i] if eps is not None else draws.sample_eps(self.net, self.gen, self.S)

    def core_weights(self):
        ids = torch.as_tensor(np.where(self.core_ids >= 0, self.core_ids, 0), device=self.device)
        return self.w[ids] * self.core_mask

    def inner_steps(self, cw, eps=None):
        """``inner_it`` Adam steps of the net on the coreset ELBO
        (S·Σ pseudo-NLL·w − Σ NKL, the reference's broadcast), the gradient
        accumulated across the steps; returns the losses."""
        g_acc = tree_map(torch.zeros_like, self.params)
        losses = []
        for i in range(self.inner_it):
            e = self._eps(eps, i)

            def loss_fn(p):
                logits = self.net.apply(p, e, self.core_x).squeeze(-1)  # (S, CAP)
                pseudo_nll = (-_bernoulli_ll(logits, self.core_y)) @ cw
                return self.S * torch.sum(pseudo_nll) - torch.sum(self.net.nkl(p, e))

            loss, g = value_and_grad(loss_fn, self.params)
            g_acc = tree_map(torch.add, g_acc, g)
            self.params, self.opt_net_state = self.opt_net.step(self.params, g_acc,
                                                                self.opt_net_state)
            losses.append(loss)
        return torch.stack(losses)

    @torch.no_grad()
    def select_stats(self, cw, xb, yb, eps=None):
        """The greedy step's correlations of the batch points and of the
        coreset slots (empty slots −inf)."""
        e = self._eps(eps, 0)
        logits = self.net.apply(self.params, e, torch.cat([self.core_x, xb])).squeeze(-1)
        all_ll = _bernoulli_ll(logits, torch.cat([self.core_y, yb]))
        core_ll, data_ll = all_ll[:, :self.CAP], all_ll[:, self.CAP:]
        weights = torch.softmax(core_ll @ cw + self.net.nkl(self.params, e), dim=0)
        ll_core, ll_data = core_ll.T, data_ll.T  # (M, S), (B, S)
        cll_data = ll_data - weights[None] * ll_data
        cll_core = ll_core - weights[None] * ll_core
        resid = self.sum_scaling * cll_data.sum(dim=0) - cw @ cll_core
        corrs = (cll_data @ resid) / torch.sqrt(torch.sum(cll_data ** 2, dim=1) + 1e-30) / self.S
        corecorrs = (torch.abs(cll_core @ resid)
                     / torch.sqrt(torch.sum(cll_core ** 2, dim=1) + 1e-30) / self.S)
        return corrs, torch.where(self.core_mask > 0, corecorrs, -torch.inf)

    def outer_steps(self, xb, yb, eps=None):
        """``outer_it`` projected Adam steps on w by the generalized
        PSVI-ELBO; returns the losses."""
        idx = torch.as_tensor(np.where(self.core_ids >= 0, self.core_ids, 0), device=self.device)
        Nu = torch.clamp_min(torch.sum(self.core_mask), 1.0)
        all_x, all_y = torch.cat([self.core_x, xb]), torch.cat([self.core_y, yb])
        losses = []
        for i in range(self.outer_it):
            e = self._eps(eps, i)
            with torch.no_grad():
                all_nll = -_bernoulli_ll(self.net.apply(self.params, e, all_x).squeeze(-1),
                                         all_y)
                nkl = self.net.nkl(self.params, e)

            def loss_fn(w_in):
                cw = w_in[idx] * self.core_mask
                pseudo_nll = (self.N / Nu) * (all_nll[:, :self.CAP] @ cw)
                data_nll = torch.sum(all_nll[:, self.CAP:], dim=-1)
                log_weights = -pseudo_nll + nkl
                weights = torch.softmax(log_weights, dim=0)
                return (torch.sum(weights * (self.sum_scaling * data_nll - pseudo_nll))
                        - torch.mean(log_weights))

            loss, g = value_and_grad(loss_fn, self.w)
            self.w, self.opt_w_state = self.opt_w.step(self.w, g, self.opt_w_state)
            self.w = torch.clamp_min(self.w, 0.0)
            losses.append(loss)
        return torch.stack(losses)

    @torch.no_grad()
    def predict(self, cw, eps=None):
        """The IW-corrected predictive's accuracy and NLL on the test set."""
        e = self._eps(eps, 0)
        logits = self.net.apply(self.params, e, torch.cat([self.xt, self.core_x])).squeeze(-1)
        n_test = self.xt.shape[0]
        pseudo_nll = -_bernoulli_ll(logits[:, n_test:], self.core_y) @ cw
        weights = torch.softmax(-pseudo_nll + self.net.nkl(self.params, e), dim=0)
        probs = torch.clamp(weights @ torch.sigmoid(logits[:, :n_test]), 0.0, 1.0)
        acc = torch.mean(((probs > 0.5).float() == self.yt).float())
        p = torch.clamp_min(torch.where(self.yt > 0.5, probs, 1 - probs), 1e-38)
        return float(acc), float(-torch.mean(torch.log(p)))

    def add_point(self, pt: int):
        if pt not in self.core_ids[:self.n_core]:
            self.core_ids[self.n_core] = pt
            self.core_x[self.n_core], self.core_y[self.n_core] = self.x[pt], self.y[pt]
            self.core_mask[self.n_core] = 1.0
            self.n_core += 1


def run_sparsevi_with_bb_elbo(x=None, y=None, xt=None, yt=None, mc_samples=4,
                              data_minibatch=128, num_epochs=100, inner_it=10, outer_it=10,
                              log_every=10, n_layers=1, n_hidden=40, logistic_regression=True,
                              lr0=1e-3, seed=0, register_elbos=False, device=None,
                              **kwargs) -> Dict[str, Any]:
    rng = np.random.default_rng(seed)
    sb = SparseBBVI(x, y, xt, yt, mc_samples=mc_samples, data_minibatch=data_minibatch,
                    num_epochs=num_epochs, inner_it=inner_it, outer_it=outer_it,
                    n_layers=n_layers, n_hidden=n_hidden,
                    logistic_regression=logistic_regression, lr0=lr0, seed=seed, device=device)
    accs, nlls, csizes, times, elbos = [], [], [], [0.0], []
    t0 = time.time()
    for it in range(num_epochs):
        cw = sb.core_weights()
        if it % log_every == 0:
            acc, nll = sb.predict(cw)
            accs.append(acc), nlls.append(nll)
            csizes.append(sb.n_core)
            times.append(times[-1] + time.time() - t0)
        # 1. fit the coreset posterior
        inner_losses = sb.inner_steps(cw)
        if register_elbos:
            elbos.append((1, -float(inner_losses[-1])))
        # 2-3. greedy selection. The reference takes sub_idcs[argmax(max(corrs))],
        # argmax of a scalar, always 0; JAX and the port take the true argmax
        sub_idcs = rng.integers(0, sb.N, size=sb.B)
        sub = torch.as_tensor(sub_idcs, device=sb.device)
        corrs, corecorrs = sb.select_stats(cw, sb.x[sub], sb.y[sub])
        max_core = float(torch.max(corecorrs)) if sb.n_core > 0 else -np.inf
        if sb.n_core == 0 or float(torch.max(corrs)) > max_core:
            sb.add_point(int(sub_idcs[int(torch.argmax(corrs))]))
        # 4. the weights on the generalized ELBO
        sub = torch.as_tensor(rng.integers(0, sb.N, size=sb.B), device=sb.device)
        outer_losses = sb.outer_steps(sb.x[sub], sb.y[sub])
        if register_elbos:
            elbos.append((0, -float(outer_losses[-1])))
    return {"accs": accs, "nlls": nlls, "csizes": csizes, "times": times[1:], "elbos": elbos}
