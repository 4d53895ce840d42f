"""Classic coreset and VI baselines.

Counterpart of ``psvi_tpu/inference/baselines.py`` (ref
``psvi/inference/baselines.py``), runner for runner, with JAX's signatures
(and ``device=None``: the CUDA card, or raise) and the keys of the dicts
they return:

- ``run_random``, ``run_giga`` (both ``giga_growth`` modes),
  ``run_sparsevi``, ``run_opsvi`` — the growth baselines on Bayesian
  logistic regression, each coreset posterior by MAP + Laplace
  (``models/logreg.py``) or, with ``mcmc=True``, by NUTS;
- ``_MFVI``, ``run_mfvi``, ``run_mfvi_subset``, ``fit``,
  ``run_mfvi_regressor`` (with the tau grid search),
  ``run_mfvi_subset_regressor`` — mean-field VI on the full data or a
  subset; the net takes no dense backend, so no kernel of ``ops/`` runs
  here, in JAX as in the port;
- ``run_kmeans``, ``run_el2n_coreset``, ``MfviSelect``,
  ``IncrementalMfviSelect``, ``run_selection_with_mfvi`` — coresets chosen
  by selection, evaluated by Laplace or fitted by MFVI.

The greedy loops stay on the host, as in JAX; the numerics run in torch on
the device, step by step (no jit, so the padded static-shape buffers JAX's
``run_sparsevi`` keeps need not exist, but they are kept to hold the same
arithmetic). Index picks draw from NumPy's ``default_rng(seed)`` in JAX's
order, so given equal inputs they are equal; Laplace noise, θ0, the MFVI
batches, noise and initial parameters come from one generator seeded with
``seed``, through ``utils/draws``.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

from psvi_torch.data.datasets import DataBundle
from psvi_torch.device import resolve_device
from psvi_torch.models import logreg as LR
from psvi_torch.models.frequentist import RunFrequentistModel
from psvi_torch.models.networks import set_up_model
from psvi_torch.ops import elbo as E
from psvi_torch.ops import optim as O
from psvi_torch.ops.kmeans import KmeansCluster
from psvi_torch.utils import draws
from psvi_torch.utils.tree import value_and_grad


def _t(a, device, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _aug(x):
    """Append the bias column of ones (ref baselines.py:146-147)."""
    return torch.cat([x, torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)], dim=1)


def _idx(idcs, device):
    return torch.as_tensor(np.asarray(idcs, np.int64), dtype=torch.long, device=device)


def _eval_laplace(generator, x_core, y_core, w_core, xt_aug, yt, inner_it, mc_samples, lr0net,
                  mcmc=False):
    """The coreset posterior's predictive accuracy and NLL: Laplace, NUTS
    with ``mcmc=True``, or the prior for an empty coreset."""
    if x_core.shape[0] == 0:
        samples = draws.normal(generator, (mc_samples, xt_aug.shape[1]))
    elif mcmc:
        samples, _ = LR.mcmc_sample(generator, x_core, y_core, w_core,
                                    num_samples=max(mc_samples, 100), num_warmup=300)
    else:
        acc, nll = LR.evaluate_coreset_laplace(generator, x_core, y_core, w_core, xt_aug, yt,
                                               inner_it=inner_it, mc_samples=mc_samples,
                                               lr0net=lr0net)
        return float(acc), float(nll)
    acc, nll = LR.predictive_scores(LR.logreg_forward(samples, xt_aug), yt)
    return float(acc), float(nll)


def _logreg_data(x, y, xt, yt, seed, device):
    dev = resolve_device(device)
    x, y, xt, yt = (_t(a, dev) for a in (x, y, xt, yt))
    return dev, draws.generator(seed, dev), x, y, _aug(x), _aug(xt), yt


def run_random(x=None, y=None, xt=None, yt=None, mc_samples=4, num_epochs=100, log_every=10,
               N=None, D=None, seed=0, lr0net=1e-3, mcmc=False, device=None,
               **kwargs) -> Dict[str, Any]:
    """Grow a random coreset one point an epoch; evaluate by Laplace, or by
    NUTS with ``mcmc=True``."""
    num_epochs = min(num_epochs, 2000) if mcmc else num_epochs  # ref :148
    rng = np.random.default_rng(seed)
    dev, gen, x, y, x_aug, xt_aug, yt = _logreg_data(x, y, xt, yt, seed, device)
    w = np.zeros(N, np.float32)
    core_idcs: list = []
    accs, nlls, csizes, times = [], [], [], [0.0]
    log_idcs, log_wts = [], []
    t0 = time.time()
    for it in range(num_epochs):
        if it % log_every == 0:
            core = _idx(core_idcs, dev)
            acc, nll = _eval_laplace(gen, x_aug[core], y[core], _t(w[core_idcs], dev), xt_aug,
                                     yt, 1000, mc_samples, lr0net, mcmc=mcmc)
            times.append(times[-1] + time.time() - t0)
            accs.append(acc), nlls.append(nll), csizes.append(len(core_idcs))
            log_idcs.append(list(core_idcs)), log_wts.append(w.tolist())
        remaining = np.setdiff1d(np.arange(N), np.asarray(core_idcs, int))
        core_idcs.append(int(rng.choice(remaining)))
        w[core_idcs] = N / len(core_idcs)
    return {"accs": accs, "nlls": nlls, "csizes": csizes, "times": times[1:],
            "wt_index": _process_wt_index(log_idcs, log_wts)}


def _process_wt_index(log_idcs, log_wts):
    """Per-logged-iteration {index: weight} maps (ref
    inference/utils.py:180-192)."""
    return [{int(i): float(wts[int(i)]) for i in idcs} for idcs, wts in zip(log_idcs, log_wts)]


def _centered_lls(thetas, x_aug, y):
    """(N, S) per-sample log-likelihoods, centred across the samples."""
    ll = LR.bernoulli_ll_multi(thetas, x_aug, y)
    return ll - ll.mean(dim=1, keepdim=True)


def _normalize(v, dim):
    n = torch.linalg.norm(v, dim=dim, keepdim=True)
    return v / torch.where(n == 0, 1.0, n)


def run_giga(x=None, y=None, xt=None, yt=None, mc_samples=100, data_minibatch=512,
             num_epochs=100, log_every=10, N=None, D=None, seed=0, subset_size=200,
             lr0net=1e-3, mcmc=False, giga_growth="log_every", device=None,
             **kwargs) -> Dict[str, Any]:
    """GIGA (Campbell & Broderick 2018): geodesic greedy selection with
    closed-form weights on normalized log-likelihood vectors.

    ``giga_growth="log_every"`` keeps the reference's defects, as JAX does
    for parity: the greedy step runs only on logged iterations (its whole
    selection block sits under ``if it % log_every == 0``), the target
    direction is resampled from a fresh minibatch every iteration, and the
    Laplace posterior takes GIGA's unit-sphere w uncalibrated (100 MAP
    steps). ``"every_step"`` is the paper's: the (N, S) centred
    log-likelihood matrix and the full-data target computed once, a greedy
    step over all N points every iteration, the predictive weights
    calibrated as w·‖ΣL‖/‖ℓ_n‖·⟨lw, ℓ̂⟩ and a 1000-step MAP. Both divide w
    by the norm of the unnormalized geodesic combination, as the paper."""
    if giga_growth not in ("log_every", "every_step"):
        raise ValueError(f"giga_growth must be 'log_every' or 'every_step', got {giga_growth!r}")
    rng = np.random.default_rng(seed)
    S = max(mc_samples, 50)  # (ref :227-230)
    dev, gen, x, y, x_aug, xt_aug, yt = _logreg_data(x, y, xt, yt, seed, device)
    w = np.zeros(N, np.float32)

    # the posterior approximation on a random subset, computed once
    sub_idcs = rng.integers(0, N, size=subset_size)
    sub = _idx(sub_idcs, dev)
    sum_scaling = N / data_minibatch
    w_sub = sum_scaling * torch.ones(subset_size, device=dev)
    if mcmc:
        param_samples, _ = LR.mcmc_sample(gen, x_aug[sub], y[sub], w_sub, num_samples=S)
    else:
        param_samples = LR.run_laplace(gen, x_aug[sub], y[sub], w_sub, inner_it=1000,
                                       mc_samples=S, lr0net=lr0net)

    lw = torch.zeros(S, device=dev)
    core_idcs: list = []
    accs, nlls, csizes, times = [], [], [], [0.0]
    t0 = time.time()
    if giga_growth == "every_step":
        ll_all = _centered_lls(param_samples, x_aug, y)
        sum_lls_full = ll_all.sum(dim=0)
        norm_lls_full = _normalize(ll_all, 1)
        norm_sumlls_full = _normalize(sum_lls_full, 0).reshape(-1)
        all_idcs = np.arange(N)
    for it in range(num_epochs):
        core_arr = _idx(core_idcs, dev)
        if giga_growth == "every_step":
            sub_idcs = all_idcs
            ll_core = ll_all[core_arr]
            sum_lls, norm_lls, norm_sumlls = sum_lls_full, norm_lls_full, norm_sumlls_full
        else:
            sub_idcs = rng.integers(0, N, size=data_minibatch)
            sub = _idx(sub_idcs, dev)
            ll_data = _centered_lls(param_samples, x_aug[sub], y[sub])
            ll_core = _centered_lls(param_samples, x_aug[core_arr], y[core_arr])
            sum_lls = ll_data.sum(dim=0)
            norm_lls = _normalize(ll_data, 1)
            norm_sumlls = _normalize(sum_lls, 0).reshape(-1)

        if it % log_every == 0:
            w_eval = _t(w[core_idcs], dev)
            if (mcmc or giga_growth == "every_step") and core_idcs:
                # the data-count rescaling of GIGA's unit-sphere weights
                w_eval = (w_eval * torch.linalg.norm(sum_lls)
                          / torch.linalg.norm(ll_core, dim=1) * torch.dot(lw, norm_sumlls))
            eval_it = 1000 if giga_growth == "every_step" else 100
            acc, nll = _eval_laplace(gen, x_aug[core_arr], y[core_arr], w_eval, xt_aug, yt,
                                     eval_it, S, lr0net, mcmc=mcmc)
            times.append(times[-1] + time.time() - t0)
            accs.append(acc), nlls.append(nll)
            csizes.append(int((w > 0).sum()))

        if giga_growth == "every_step" or it % log_every == 0:
            # the geodesic direction and the greedy pick
            d = _normalize(norm_sumlls - torch.dot(norm_sumlls, lw) * lw, 0)
            proj = norm_lls @ lw
            dns = _normalize(norm_lls - proj[:, None] * lw[None, :], 1)
            pt_idx = int(sub_idcs[int(torch.argmax(dns @ d))])
            if pt_idx not in core_idcs:
                core_idcs.append(pt_idx)
                idx_new = -1
                core_arr = _idx(core_idcs, dev)
                ll_core = _centered_lls(param_samples, x_aug[core_arr], y[core_arr])
            else:
                idx_new = core_idcs.index(pt_idx)
            nlc = _normalize(ll_core, 1)[idx_new]
            zeta0 = torch.dot(norm_sumlls, nlc)
            zeta1 = torch.dot(norm_sumlls, lw)
            zeta2 = torch.dot(nlc, lw)
            gamma = (zeta0 - zeta1 * zeta2) / (zeta0 - zeta1 * zeta2 + zeta1 - zeta0 * zeta2)
            lw_unnorm = (1 - gamma) * lw + gamma * nlc
            lw = _normalize(lw_unnorm, 0).reshape(-1)
            onehot = np.zeros(N, np.float32)
            onehot[pt_idx] = 1.0
            w = np.maximum(((1 - float(gamma)) * w + float(gamma) * onehot)
                           / float(torch.linalg.norm(lw_unnorm)), 0.0)
    return {"accs": accs, "nlls": nlls, "csizes": csizes, "times": times[1:],
            "_core_idcs": core_idcs, "_w": w, "_lw": lw.cpu().numpy()}


def run_sparsevi(x=None, y=None, xt=None, yt=None, mc_samples=4, data_minibatch=128,
                 num_epochs=100, log_every=10, N=None, D=None, diagonal=True, inner_it=10,
                 outer_it=10, lr0net=1e-3, lr0v=1e-1, seed=0, mcmc=False, device=None,
                 **kwargs) -> Dict[str, Any]:
    """Sparse VI (Campbell & Beronov 2019): Laplace coreset posterior,
    greedy residual-correlation selection, projected Adam on the weights.
    The coreset lives in a buffer of num_epochs slots with zero weights on
    the unused ones (zero-weight rows add nothing to the MAP loss, its
    gradient or the Hessian), as in JAX."""
    rng = np.random.default_rng(seed)
    outer_it = min(outer_it, 500)
    dev, gen, x, y, x_aug, xt_aug, yt = _logreg_data(x, y, xt, yt, seed, device)
    M_max, Dp = num_epochs, x_aug.shape[1]
    xc = torch.zeros((M_max, Dp), device=dev)
    yc = torch.zeros((M_max,), device=dev)
    wc = torch.zeros((M_max,), device=dev)
    mask = torch.zeros((M_max,), dtype=torch.bool, device=dev)
    pos = np.zeros((M_max,), np.int32)  # the dataset index of each slot
    m = 0
    opt_w = O.adam(lr0v)
    accs, nlls, csizes, times = [], [], [], [0.0]
    log_idcs, log_wts = [], []
    core_idcs: list = []
    t0 = time.time()
    scale = N / data_minibatch

    def resid_of(samples, sub_x, sub_y):
        cll_data = _centered_lls(samples, sub_x, sub_y)
        cll_core = _centered_lls(samples, xc, yc)
        return cll_data, cll_core, scale * cll_data.sum(dim=0) - wc @ cll_core

    def select_stats(sub_x, sub_y):
        samples = LR.run_laplace(gen, xc, yc, wc, inner_it=inner_it, mc_samples=mc_samples,
                                 diagonal=diagonal, lr0net=lr0net)
        cll_data, cll_core, resid = resid_of(samples, sub_x, sub_y)
        S = cll_data.shape[1]
        corrs = (cll_data @ resid) / torch.sqrt(torch.sum(cll_data ** 2, dim=1)) / S
        corecorrs = torch.abs(cll_core @ resid) / torch.sqrt(torch.sum(cll_core ** 2, dim=1)) / S
        # padded slots must not win the comparison
        return corrs, torch.where(mask, corecorrs, -torch.inf)

    def w_grad(theta, sub_x, sub_y):
        # the MAP continued across the outer_it weight steps of an epoch
        samples, theta = LR.run_laplace_from(gen, theta, xc, yc, wc, inner_it=inner_it,
                                             mc_samples=mc_samples, diagonal=diagonal,
                                             lr0net=lr0net)
        _, cll_core, resid = resid_of(samples, sub_x, sub_y)
        g = -(cll_core @ resid) / cll_core.shape[1]
        return torch.where(mask, g, 0.0), theta

    for it in range(num_epochs):
        if it % log_every == 0:
            acc, nll = _eval_laplace(gen, xc, yc, wc, xt_aug, yt, 1000, mc_samples, lr0net,
                                     mcmc=mcmc)
            times.append(times[-1] + time.time() - t0)
            accs.append(acc), nlls.append(nll), csizes.append(len(core_idcs))
            log_idcs.append(list(core_idcs))
            w_full = np.zeros(N)
            w_full[pos[:m]] = wc.cpu().numpy()[:m]
            log_wts.append(w_full.tolist())

        # greedy selection; with an empty coreset every corecorr is -inf and
        # the best-correlated point joins unconditionally
        sub = _idx(rng.integers(0, N, size=data_minibatch), dev)
        corrs, corecorrs = select_stats(x_aug[sub], y[sub])
        if float(corrs.max()) > float(corecorrs.max()):
            pt = int(sub[int(torch.argmax(corrs))])
            if pt not in core_idcs and m < M_max:
                core_idcs.append(pt)
                xc[m], yc[m], mask[m] = x_aug[pt], y[pt], True
                pos[m] = pt
                m += 1

        # projected weight updates: a fresh Adam and θ each epoch, θ refined
        # across the outer_it steps
        opt_w_state = opt_w.init(wc)
        theta_w = draws.normal(gen, (Dp,))
        for _ in range(outer_it):
            sub2 = _idx(rng.integers(0, N, size=data_minibatch), dev)
            g_core, theta_w = w_grad(theta_w, x_aug[sub2], y[sub2])
            wc, opt_w_state = opt_w.step(wc, g_core, opt_w_state)
            wc = torch.clamp_min(wc, 0.0)
    return {"accs": accs, "nlls": nlls, "csizes": csizes, "times": times[1:],
            "wt_index": _process_wt_index(log_idcs, log_wts)}


def run_opsvi(x=None, y=None, xt=None, yt=None, mc_samples=10, data_minibatch=128,
              num_epochs=100, log_every=10, N=None, D=None, num_pseudo=10, inner_it=10,
              diagonal=True, lr0net=1e-3, lr0u=1e-3, lr0v=1e-3, init_args="subsample", seed=0,
              log_pseudodata=False, device=None, **kwargs) -> Dict[str, Any]:
    """Original PSVI (Manousakas et al. 2020): a fixed-size pseudocoreset
    with hand-derived gradients for its weights and locations; the MAP
    iterate θ persists across epochs, as the reference's parameter does."""
    rng = np.random.default_rng(seed)
    x_np, y_np = np.asarray(x), np.asarray(y)
    dev, gen, x, y, x_aug, xt_aug, yt = _logreg_data(x, y, xt, yt, seed, device)

    # pseudodata init (ref inference/utils.py:33-77)
    M = num_pseudo
    if init_args == "random":
        u0 = x_np.mean() + 0.1 * rng.standard_normal((M, x_np.shape[1]))
        z0 = np.concatenate([np.full(M // 2, c, np.float32) if c < 1 else
                             np.full(M - M // 2, c, np.float32) for c in range(2)])
    else:
        idx0, idx1 = np.where(y_np == 0)[0], np.where(y_np == 1)[0]
        m0 = M // 2
        take0 = rng.choice(idx0, m0, replace=len(idx0) < m0)
        take1 = rng.choice(idx1, M - m0, replace=len(idx1) < M - m0)
        u0 = np.concatenate([x_np[take0], x_np[take1]])
        z0 = np.concatenate([np.zeros(m0), np.ones(M - m0)]).astype(np.float32)
    u = _t(np.concatenate([u0, np.ones((M, 1))], axis=1), dev)
    z = _t(z0, dev)
    w = (N / M) * torch.ones(M, device=dev)
    opt_u, opt_w = O.adam(lr0u), O.adam(lr0v * N)
    opt_u_state, opt_w_state = opt_u.init(u), opt_w.init(w)
    theta = draws.normal(gen, (x_aug.shape[1],))

    accs, nlls, csizes, times = [], [], [], [0.0]
    us, zs, ws = [], [], []
    t0 = time.time()

    def grads(theta, u, z, w, sub_x, sub_y):
        samples, theta = LR.run_laplace_from(gen, theta, u, z, w, inner_it=inner_it,
                                             mc_samples=mc_samples, diagonal=diagonal,
                                             lr0net=lr0net)
        cll_data = _centered_lls(samples, sub_x, sub_y)
        S = cll_data.shape[1]
        resid = (N / data_minibatch) * cll_data.sum(dim=0) - w @ _centered_lls(samples, u, z)

        def u_fn(u_in):
            # (−w·cll_core)·resid / S with resid and w held fixed
            cll_core = _centered_lls(samples, u_in, z)
            return torch.dot(-w @ cll_core, resid) / S

        loss, u_grad = value_and_grad(u_fn, u)
        w_grad = -(_centered_lls(samples, u, z) @ resid) / S
        u_grad[:, -1] = 0.0  # the bias column stays 1 (ref :804)
        return w_grad, u_grad, theta

    for it in range(num_epochs):
        if it % log_every == 0:
            samples, theta = LR.run_laplace_from(gen, theta, u, z, w, inner_it=inner_it,
                                                 mc_samples=mc_samples, diagonal=diagonal,
                                                 lr0net=lr0net)
            acc, nll = LR.predictive_scores(LR.logreg_forward(samples, xt_aug), yt)
            times.append(times[-1] + time.time() - t0)
            accs.append(float(acc)), nlls.append(float(nll)), csizes.append(M)
            if log_pseudodata:
                us.append(u.cpu().numpy()), zs.append(z.cpu().numpy()), ws.append(w.cpu().numpy())
        sub = _idx(rng.integers(0, N, size=data_minibatch), dev)
        w_grad, u_grad, theta = grads(theta, u, z, w, x_aug[sub], y[sub])
        w, opt_w_state = opt_w.step(w, w_grad, opt_w_state)
        u, opt_u_state = opt_u.step(u, u_grad, opt_u_state)
        w = torch.clamp_min(w, 0.0)
    out = {"accs": accs, "nlls": nlls, "csizes": csizes, "times": times[1:], "elbos": []}
    if log_pseudodata:
        out["us"], out["zs"], out["vs"] = us, zs, ws
    return out


# ----------------------------------------------------------------------
# MFVI flows (BNN)
# ----------------------------------------------------------------------


class _MFVI:
    """Mean-field VI of a net on a fixed or sampled batch. The net takes no
    dense backend (JAX ``_MFVI`` builds it without one), so its products are
    the plain ones."""

    def __init__(self, data: DataBundle, architecture, n_hidden, nc, mc_samples, init_sd,
                 lr0net, data_minibatch, seed, n_layers=1, device=None):
        self.device = resolve_device(device)
        self.data = data
        self.nc = nc
        self.mc_samples = mc_samples
        self.B = min(data_minibatch, data.N)
        self.net = set_up_model(architecture, data.D, n_hidden, nc, init_sd, n_layers=n_layers,
                                n_channels=data.channels or 1).to(self.device)
        self.gen = draws.generator(seed, self.device)
        self.params = draws.init_params(self.net, self.gen)
        self.opt = O.adam(lr0net)
        self.opt_state = self.opt.init(self.params)

    def elbo_loss(self, params, eps, xb, yb, scale, distr, tau, shard=None):
        """The negative ELBO: the scaled NLL summed over (samples, batch),
        plus the KL; with ``shard`` (``parallel/mesh.AxisShard``) the batch
        is this rank's rows and the sum runs over the data axis."""
        nll = E.nll_fn(distr, False, self.nc, tau)(self.net.apply(params, eps, xb), yb)
        nll = torch.sum(nll) if shard is None else shard.sum(torch.sum(nll))
        return scale * nll + self.net.kl(params)

    def step(self, xb, yb, scale, distr, tau, eps=None, shard=None):
        """One Adam step of the ELBO on (xb, yb); ``eps`` drawn if None. With
        ``shard`` each rank takes its rows of the batch and the gradient is
        averaged over the axis."""
        if eps is None:
            eps = draws.sample_eps(self.net, self.gen, self.mc_samples)
        if shard is not None:
            xb, yb = shard.take(xb), shard.take(yb)
        loss, g = value_and_grad(
            lambda p: self.elbo_loss(p, eps, xb, yb, scale, distr, tau, shard), self.params)
        if shard is not None:
            g = shard.mean(g)
        self.params, self.opt_state = self.opt.step(self.params, g, self.opt_state)
        return loss

    @torch.no_grad()
    def classify(self, xt, yt):
        """Accuracy and NLL of the MC-mean logits on (xt, yt)."""
        eps = draws.sample_eps(self.net, self.gen, self.mc_samples)
        logits = self.net.apply(self.params, eps, xt).mean(dim=0)
        acc = torch.mean((torch.argmax(logits, -1).float() == yt).float())
        nll = torch.mean(E.categorical_nll(logits[None], yt)[0])
        return float(acc), float(nll)


def run_mfvi(train=None, mc_samples=4, data_minibatch=128, num_epochs=100, log_every=10,
             N=None, D=None, lr0net=1e-3, mul_fact=2, seed=0, architecture=None, n_hidden=None,
             nc=2, n_layers=1, init_sd=1e-3, mesh=None, shard_batch=False, device=None,
             **kwargs) -> Dict[str, Any]:
    """Mean-field VI on the full training set, a random minibatch a step.
    ``mesh`` + ``shard_batch=True``: every rank draws the same minibatch and
    keeps its rows of it (the mesh's ``data`` axis, the minibatch rounded
    down to a multiple of it); the NLL's sum runs over the axis and the
    gradient is averaged over it, so the numbers equal the unsharded run's
    (JAX ``baselines.py:560-600``)."""
    data: DataBundle = train
    m = _MFVI(data, architecture, n_hidden, nc, mc_samples, init_sd, lr0net, data_minibatch,
              seed, n_layers, device=device)
    shard = None
    if mesh is not None and shard_batch:
        from psvi_torch.parallel.mesh import AxisShard

        shard = AxisShard(mesh, "data")
        m.B = max(shard.size, (m.B // shard.size) * shard.size)
    x, y, xt, yt = (_t(a, m.device) for a in (data.x, data.y, data.xt, data.yt))
    accs, nlls, times, elbos = [], [], [0.0], []
    t0 = time.time()
    total_iterations = mul_fact * num_epochs
    for i in range(total_iterations):
        idx = draws.choice(m.gen, data.N, m.B)
        loss = m.step(x[idx], y[idx], data.N / m.B, "categorical", None, shard=shard)
        elbos.append(-float(loss))
        if i % log_every == 0 or i == total_iterations - 1:
            acc, nll = m.classify(xt, yt)
            times.append(times[-1] + time.time() - t0)
            accs.append(acc), nlls.append(nll)
    return {"accs": accs, "nlls": nlls, "times": times[1:], "elbos": elbos, "csizes": None}


def run_mfvi_subset(train=None, mc_samples=4, data_minibatch=128, num_epochs=100, log_every=10,
                    D=None, lr0net=1e-3, mul_fact=2, seed=0, num_pseudo=100,
                    init_args="subsample", architecture=None, n_hidden=None, nc=2, n_layers=1,
                    init_sd=1e-3, log_pseudodata=False, device=None,
                    **kwargs) -> Dict[str, Any]:
    """MFVI on a fixed class-balanced subset of M points, scaled by N/M."""
    data: DataBundle = train
    m = _MFVI(data, architecture, n_hidden, nc, mc_samples, init_sd, lr0net, data_minibatch,
              seed, n_layers, device=device)
    rng = np.random.default_rng(seed)
    x_np, y_np = np.asarray(data.x), np.asarray(data.y)
    M = num_pseudo
    ppc = [M // nc] * nc
    ppc[-1] = M - sum(ppc[:-1])
    if init_args == "random":
        xb = x_np.mean() + 0.1 * rng.standard_normal((M,) + x_np.shape[1:])
        yb = np.concatenate([np.full(p, c, np.float32) for c, p in enumerate(ppc)])
    else:
        xs, ys = [], []
        for c in range(nc):
            idx = np.where(y_np == c)[0]
            xs.append(x_np[rng.choice(idx, ppc[c], replace=len(idx) < ppc[c])])
            ys.append(np.full(ppc[c], c, np.float32))
        xb, yb = np.concatenate(xs), np.concatenate(ys)
    xb_t, yb_t = _t(xb, m.device), _t(yb, m.device)
    xt, yt = _t(data.xt, m.device), _t(data.yt, m.device)
    sum_scaling = data.N / M
    accs, nlls, times, elbos = [], [], [0.0], []
    t0 = time.time()
    for i in range(mul_fact * num_epochs):
        loss = m.step(xb_t, yb_t, sum_scaling, "categorical", None)
        elbos.append(-float(loss))
        if i % log_every == 0:
            acc, nll = m.classify(xt, yt)
            times.append(times[-1] + time.time() - t0)
            accs.append(acc), nlls.append(nll)
    out = {"accs": accs, "nlls": nlls, "times": times[1:], "elbos": elbos,
           "csizes": [num_pseudo] * (mul_fact * num_epochs)}
    if log_pseudodata:
        out["us"], out["zs"] = np.asarray(xb, np.float32), np.asarray(yb)
        out["vs"] = [sum_scaling] * num_pseudo
    return out


def fit(m: _MFVI, x, y, xp, yp, y_mean, y_std, tau, epochs, log_every=-1, batch_size=None,
        mc_samples=4) -> Dict[str, Any]:
    """Fit a mean-field regression net and log RMSE and predictive LL on
    (xp, yp) (yp not normalised); tensors on ``m``'s device."""
    n_train = x.shape[0]
    B = min(batch_size or n_train, n_train)

    @torch.no_grad()
    def evaluate():
        eps = draws.sample_eps(m.net, m.gen, mc_samples)
        preds = m.net.apply(m.params, eps, xp).squeeze(-1)
        y_pred = (preds * y_std + y_mean).mean(dim=0)
        ytrue = yp.reshape(-1)
        rmse = torch.sqrt(torch.mean(torch.square(y_pred - ytrue)))
        scale = 1.0 / np.sqrt(np.float32(tau))
        ll = torch.mean(-0.5 * torch.square((ytrue - y_pred) / scale) - np.log(scale)
                        - 0.5 * np.log(2 * np.pi))
        return float(rmse), float(ll)

    lls, rmses, times, elbos = [], [], [0.0], []
    t0 = time.time()
    for e in range(epochs):
        idx = draws.choice(m.gen, n_train, B)
        eps = draws.sample_eps(m.net, m.gen, mc_samples)
        loss = m.step(x[idx], y[idx], n_train / B, "gaussian", tau, eps=eps)
        elbos.append(-float(loss))
        if (e % log_every == 0) if log_every > 0 else (e == epochs - 1):
            rmse, ll = evaluate()
            times.append(times[-1] + time.time() - t0)
            lls.append(ll), rmses.append(rmse)
    return {"rmses": rmses, "lls": lls, "times": times[1:], "elbos": elbos,
            "scale": 1.0 / np.sqrt(tau)}


def _regression_tensors(data, m):
    return tuple(_t(a, m.device) for a in (data.xv, data.yv, data.xt, data.yt))


def run_mfvi_regressor(train=None, mc_samples=4, data_minibatch=128, num_epochs=100,
                       log_every=10, lr0net=1e-3, seed=0, architecture="regressor_net",
                       n_hidden=40, n_layers=1, init_sd=1e-6, model_selection=True, device=None,
                       **kwargs) -> Dict[str, Any]:
    """Regression MFVI; with ``model_selection`` the precision tau is the
    one of ``data.taus`` whose fit has the best validation LL."""
    data: DataBundle = train
    bpe = max(1, data.N // data_minibatch)

    def new():
        return _MFVI(data, architecture, n_hidden, 1, mc_samples, init_sd, lr0net,
                     data_minibatch, seed, n_layers, device=device)

    best_tau, best_ll = data.taus[0], -float("inf")
    if model_selection:
        for tau in data.taus:
            m = new()
            x, y = _t(data.x, m.device), _t(data.y, m.device)
            xv, yv, _, _ = _regression_tensors(data, m)
            r = fit(m, x, y, xv, yv, data.y_mean, data.y_std, tau, num_epochs * bpe,
                    log_every=-1, batch_size=data_minibatch, mc_samples=mc_samples)
            if r["lls"][-1] > best_ll:
                best_tau, best_ll = tau, r["lls"][-1]
    m = new()
    x, y = _t(data.x, m.device), _t(data.y, m.device)
    _, _, xt, yt = _regression_tensors(data, m)
    res = fit(m, x, y, xt, yt, data.y_mean, data.y_std, best_tau, num_epochs * bpe,
              log_every=log_every, batch_size=data_minibatch, mc_samples=mc_samples)
    res["best_tau"] = best_tau
    return res


def run_mfvi_subset_regressor(train=None, mc_samples=4, data_minibatch=128, num_epochs=100,
                              log_every=10, lr0net=1e-3, seed=0, num_pseudo=100,
                              architecture="regressor_net", n_hidden=40, n_layers=1,
                              init_sd=1e-6, model_selection=False, device=None,
                              **kwargs) -> Dict[str, Any]:
    """Regression MFVI on a random subset of ``num_pseudo`` points."""
    data: DataBundle = train
    rng = np.random.default_rng(seed)
    idx = rng.choice(data.N, size=min(num_pseudo, data.N), replace=False)
    bpe = max(1, data.N // data_minibatch)

    def new():
        return _MFVI(data, architecture, n_hidden, 1, mc_samples, init_sd, lr0net,
                     data_minibatch, seed, n_layers, device=device)

    best_tau, best_ll = data.taus[0], -float("inf")
    if model_selection:
        for tau in data.taus:
            m = new()
            xv, yv, _, _ = _regression_tensors(data, m)
            r = fit(m, _t(data.x[idx], m.device), _t(data.y[idx], m.device), xv, yv,
                    data.y_mean, data.y_std, tau, num_epochs * bpe, log_every=-1,
                    mc_samples=mc_samples)
            if r["lls"][-1] > best_ll:
                best_tau, best_ll = tau, r["lls"][-1]
    m = new()
    _, _, xt, yt = _regression_tensors(data, m)
    res = fit(m, _t(data.x[idx], m.device), _t(data.y[idx], m.device), xt, yt, data.y_mean,
              data.y_std, best_tau, num_epochs * bpe, log_every=log_every,
              mc_samples=mc_samples)
    res["csizes"] = [num_pseudo]
    res["best_tau"] = best_tau
    return res


# ----------------------------------------------------------------------
# selection-based logreg baselines
# ----------------------------------------------------------------------


def _run_selected(pick, x, y, xt, yt, num_epochs, log_every, N, seed, lr0net, mc_samples,
                  inner_it, device):
    """The loop of ``run_kmeans`` and ``run_el2n_coreset``: at each logged
    epoch ``pick(it)`` gives the coreset, evaluated by Laplace on the
    previous weights, then weighted N/|coreset|."""
    dev, gen, x, y, x_aug, xt_aug, yt = _logreg_data(x, y, xt, yt, seed, device)
    w = np.zeros(N, np.float32)
    accs, nlls, csizes, times = [], [], [], [0.0]
    log_idcs, log_wts = [], []
    t0 = time.time()
    for it in range(num_epochs):
        if it % log_every == 0:
            core_idcs = pick(it)
            core = _idx(core_idcs, dev)
            acc, nll = _eval_laplace(gen, x_aug[core], y[core], _t(w[core_idcs], dev), xt_aug,
                                     yt, inner_it, mc_samples, lr0net)
            if core_idcs:
                w[core_idcs] = N / len(core_idcs)
            times.append(times[-1] + time.time() - t0)
            accs.append(acc), nlls.append(nll), csizes.append(len(core_idcs))
            log_idcs.append(list(core_idcs)), log_wts.append(w.tolist())
    return {"accs": accs, "nlls": nlls, "csizes": csizes, "times": times[1:],
            "wt_index": _process_wt_index(log_idcs, log_wts)}


def run_kmeans(x=None, y=None, xt=None, yt=None, num_epochs=100, log_every=10, N=None, D=None,
               seed=0, lr0net=1e-3, nc=2, mc_samples=4, inner_it=1000, device=None,
               **kwargs) -> Dict[str, Any]:
    """A k-means-selected coreset, re-clustered at each logged epoch,
    evaluated by Laplace."""
    cluster = KmeansCluster(np.asarray(x), np.asarray(y), num_classes=nc, seed=seed,
                            device=device)

    def pick(it):
        cluster.set_num_clusters(max(it, 2 * nc))
        cluster.run_kmeans()
        return cluster.get_arbitrary_pts(max(it, 1))

    return _run_selected(pick, x, y, xt, yt, num_epochs, log_every, N, seed, lr0net,
                         mc_samples, inner_it, device)


def run_el2n_coreset(x=None, y=None, xt=None, yt=None, num_epochs=100, log_every=10, N=None,
                     D=None, seed=0, lr0net=1e-3, nc=2, mc_samples=4, data_minibatch=128,
                     inner_it=1000, device=None, **kwargs) -> Dict[str, Any]:
    """The highest-EL2N points of a frequentist logistic regression (21
    epochs), evaluated by Laplace."""
    freq = RunFrequentistModel(x, y, xt, yt, num_classes=nc, is_logreg=True,
                               data_minibatch=data_minibatch, num_epochs=21, seed=seed,
                               device=device)
    freq.train()
    return _run_selected(freq.get_largest_el2n_indices, x, y, xt, yt, num_epochs, log_every,
                         N, seed, lr0net, mc_samples, inner_it, device)


# ----------------------------------------------------------------------
# selection + MFVI flows
# ----------------------------------------------------------------------


class MfviSelect:
    """Select a coreset by a scoring method, then fit MFVI on the weighted
    subset (JAX ``MfviSelect``)."""

    def __init__(self, train=None, data_minibatch=128, num_pseudo=100, nc=2,
                 architecture="logistic_regression", D=None, n_hidden=100, mc_samples=4,
                 init_sd=1e-3, lr0net=1e-3, num_epochs=100, log_every=10, seed=0, mul_fact=2,
                 log_pseudodata=False, score_method="kmeans", pretrain_epochs=5,
                 data_folder=None, load_from_saved=False, distance_fn="euclidean",
                 last_layer_only=False, dnm=None, device=None, **kw):
        self.data: DataBundle = train
        self.num_pseudo, self.nc = num_pseudo, nc
        self.architecture, self.D, self.n_hidden = architecture, D or train.D, n_hidden
        self.mc_samples, self.init_sd = mc_samples, init_sd
        self.lr0net, self.num_epochs = lr0net, num_epochs
        self.log_every, self.seed, self.mul_fact = log_every, seed, mul_fact
        self.log_pseudodata = log_pseudodata
        self.score_method = score_method
        self.pretrain_epochs = pretrain_epochs
        self.data_folder, self.load_from_saved = data_folder, load_from_saved
        self.distance_fn, self.last_layer_only = distance_fn, last_layer_only
        self.dnm = dnm
        self.data_minibatch = data_minibatch
        self.wt_index = {}
        self._m = _MFVI(self.data, architecture, n_hidden, nc, mc_samples, init_sd, lr0net,
                        data_minibatch, seed, device=device)
        self.device = self._m.device

    def _chosen(self, idx, xs, ys, wts):
        dev = self.device
        return idx, _t(xs, dev), _t(ys, dev), _t(wts, dev)

    def select_data(self):
        from psvi_torch.inference.selection import CoresetSelect

        sel = CoresetSelect(
            self.data.x, self.data.y, self.data.xt, self.data.yt, num_pseudo=self.num_pseudo,
            nc=self.nc, architecture=self.architecture, D=self.D, n_hidden=self.n_hidden,
            mc_samples=self.mc_samples, init_sd=self.init_sd,
            data_minibatch=self.data_minibatch, pretrain_epochs=self.pretrain_epochs,
            lr0net=self.lr0net, seed=self.seed, score_method=self.score_method,
            data_folder=self.data_folder, load_from_saved=self.load_from_saved, dnm=self.dnm,
            distance_fn=self.distance_fn, last_layer_only=self.last_layer_only,
            n_channels=self.data.channels or 1, device=self.device)
        self.chosen = self._chosen(*sel.select_data())
        self.wt_index = sel.wt_index

    def evaluate_coreset(self) -> Dict[str, Any]:
        """MFVI on the weighted subset: loss = −Σ_m w_m Σ_s ll[s, m] + KL."""
        m = self._m
        idx, xs, ys, wts = self.chosen
        xt, yt = _t(self.data.xt, self.device), _t(self.data.yt, self.device)

        def loss_fn(p, eps):
            ll = -E.categorical_nll(m.net.apply(p, eps, xs), ys)  # (S, M)
            return -torch.dot(wts, torch.sum(ll, dim=0)) + m.net.kl(p)

        accs, nlls, elbos = [], [], []
        total = self.mul_fact * self.num_epochs
        for i in range(total):
            eps = draws.sample_eps(m.net, m.gen, self.mc_samples)
            loss, g = value_and_grad(lambda p: loss_fn(p, eps), m.params)
            m.params, m.opt_state = m.opt.step(m.params, g, m.opt_state)
            elbos.append(-float(loss))
            if i % self.log_every == 0:
                acc, nll = m.classify(xt, yt)
                accs.append(acc), nlls.append(nll)
        results = {"accs": accs, "nlls": nlls, "times": 0, "elbos": elbos,
                   "csizes": [self.num_pseudo] * total, "wt_index": self.wt_index}
        if self.log_pseudodata:
            results["us"], results["zs"] = xs.cpu().numpy(), ys.cpu().numpy()
            results["vs"] = wts.cpu().numpy().tolist()
        return results


class IncrementalMfviSelect(MfviSelect):
    """A 20-point k-means coreset, then one point more a round, the
    highest-entropy one under the evolving fit, 10 epochs a round."""

    def select_data(self):
        from psvi_torch.inference.selection import KmeansSelection, RandomIncrementalSelection

        min_pts = 20
        init_sel = KmeansSelection(self.data.x, self.data.y, min_pts, self.nc, self.seed,
                                   embedding_flag=(self.architecture == "lenet"),
                                   device=self.device)
        init_sel.pretrain(self.data.xt, self.data.yt, self.architecture, self.D, self.n_hidden,
                          self.mc_samples, self.init_sd, self.data_minibatch,
                          self.pretrain_epochs, self.lr0net, self.data_folder,
                          self.load_from_saved, self.dnm, n_channels=self.data.channels or 1)
        idx, xs, ys, wts = init_sel.get_weighted_subset()
        self.chosen = self._chosen(idx, xs, ys, wts)
        self.evaluate_coreset()
        core_idc = list(idx)
        inc = RandomIncrementalSelection(self.data.x, self.data.y, self.num_pseudo, self.nc,
                                         self.seed, score_type="entropy", device=self.device)
        orig_epochs = self.num_epochs
        for _ in range(min_pts + 1, self.num_pseudo):
            inc.update_current_state(core_idc, _NetShim(self._m, self.mc_samples))
            ii, xs, ys, wts = inc.get_weighted_subset()
            self.chosen = self._chosen(ii, xs, ys, wts)
            core_idc = list(ii)
            self.num_epochs = 10
            self.evaluate_coreset()
        self.num_epochs = orig_epochs
        self.wt_index = {str(k): float(v) for k, v in zip(core_idc, np.asarray(wts))}


class _NetShim:
    """The evolving MFVI fit's (net, params, mc_samples) as a
    ``pretrained_vi`` for the score computation."""

    def __init__(self, m: "_MFVI", mc_samples):
        self.net = m.net
        self.params = m.params
        self.mc_samples = mc_samples
        self.device = m.device
        self.forgetting_events = None


def run_selection_with_mfvi(train=None, mfvi_selection_method="kmeans",
                            **kwargs) -> Dict[str, Any]:
    """Select by ``mfvi_selection_method`` (``"incremental"``: the
    incremental selection), then fit MFVI on the weighted coreset."""
    cls = IncrementalMfviSelect if mfvi_selection_method == "incremental" else MfviSelect
    sel = cls(train=train, score_method=mfvi_selection_method, **kwargs)
    sel.select_data()
    return sel.evaluate_coreset()
