"""Coreset selection and scoring.

Counterpart of ``psvi_tpu/inference/selection.py`` (ref
``psvi/inference/utils.py:221-1750``):

- ``MeanFieldVI`` — the MFVI pretrainer: ordered sweeps over the training
  set (the last, shorter batch scaled by its own row count), the
  forgetting and never-learnt counters, ``save``/``load`` (``.npz`` files
  in JAX's format);
- ``ScoreCalculator`` — least confidence, entropy, EL2N;
- ``load_embeddings_csv`` / ``load_scores_csv`` — the CSV files of a PSVI
  scoring run, read with NumPy;
- ``sample_multinomial`` and the ``Selection`` family: random, k-means in
  raw, embedding or gradient space, score-based, k-means + score
  multinomial picks, random + score, incremental, weighted k-means,
  submodular facility location;
- ``CoresetSelect`` — the dispatcher over ``score_method``.

The numeric passes (forwards, scores, embeddings, distance matrices,
k-means) run in torch on the device; the greedy and multinomial picks
stay on the host in NumPy, drawn from ``default_rng(seed)`` as in JAX. The
noise of the probabilities and embeddings comes from generators seeded
with ``seed + 7`` and ``seed + 11``, where JAX takes keys of those seeds.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import numpy as np
import torch

from psvi_torch.device import resolve_device
from psvi_torch.inference import submodular as SM
from psvi_torch.models.networks import set_up_model
from psvi_torch.ops import elbo as E
from psvi_torch.ops import optim as O
from psvi_torch.ops.kmeans import KmeansCluster
from psvi_torch.utils import draws
from psvi_torch.utils.tree import tree_leaves, tree_unflatten, value_and_grad


# ----------------------------------------------------------------------
# pretraining engine
# ----------------------------------------------------------------------


class MeanFieldVI:
    """MFVI pretrainer with forgetting-event tracking (JAX ``MeanFieldVI``).

    One iteration is a full ordered sweep over the training set (the order
    matters for the forgetting indices), then, with
    ``forgetting_score_flag``, a per-example train-accuracy pass that
    updates the forgetting and never-learnt counters. The initial
    parameters and every sweep's noise come from a generator seeded with
    ``seed``.
    """

    def __init__(self, x, y, xt, yt, architecture, D, n_hidden, nc, mc_samples=4,
                 init_sd=1e-3, data_minibatch=128, num_epochs=5, lr0net=1e-3, mul_fact=2,
                 seed=0, forgetting_score_flag=False, data_path=None, load_from_saved=False,
                 dnm="data", n_channels=1, log_every=10, device=None):
        dev = self.device = resolve_device(device)
        self.x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        self.y = torch.as_tensor(np.asarray(y, np.float32), device=dev)
        self.xt = torch.as_tensor(np.asarray(xt, np.float32), device=dev)
        self.yt = torch.as_tensor(np.asarray(yt, np.float32), device=dev)
        self.nc = nc
        self.mc_samples = mc_samples
        self.B = min(data_minibatch, len(x))
        self.total_iterations = mul_fact * num_epochs
        self.num_epochs = num_epochs
        self.seed = seed
        self.forgetting_score_flag = forgetting_score_flag
        self.data_path = data_path
        self.load_from_saved = load_from_saved
        self.dnm = dnm
        self.architecture = architecture
        self.net = set_up_model(architecture, D, n_hidden, nc, init_sd,
                                n_channels=n_channels).to(dev)
        self.gen = draws.generator(seed, dev)
        self.params = draws.init_params(self.net, self.gen)
        self.opt = O.adam(lr0net)
        self.opt_state = self.opt.init(self.params)
        self.n_train = len(x)
        self.forgetting_events = np.zeros(self.n_train, np.float32)
        self.last_acc = np.zeros(self.n_train, np.float32)
        self.never_learnt = np.ones(self.n_train, np.float32)
        self.n_batches = -(-self.n_train // self.B)

    def _train_sweep(self, params, opt_state, eps=None):
        """One ordered sweep of Adam steps, one per batch; ``eps`` is the
        batches' noise (a list), else drawn. The loss is the data NLL scaled
        by n_train over the batch's own row count, plus the KL."""
        losses = []
        for b in range(self.n_batches):
            xb, yb = self.x[b * self.B:(b + 1) * self.B], self.y[b * self.B:(b + 1) * self.B]
            e = eps[b] if eps is not None else draws.sample_eps(self.net, self.gen,
                                                                self.mc_samples)
            scaling = self.n_train / xb.shape[0]

            def loss_fn(p):
                nll = E.categorical_nll(self.net.apply(p, e, xb), yb)
                return scaling * torch.sum(nll) + self.net.kl(p)

            loss, g = value_and_grad(loss_fn, params)
            params, opt_state = self.opt.step(params, g, opt_state)
            losses.append(loss)
        return params, opt_state, torch.stack(losses)

    @torch.no_grad()
    def _train_accuracy(self, params, eps=None):
        """Per-example 0/1 train accuracy of the MC-mean logits (NumPy)."""
        if eps is None:
            eps = draws.sample_eps(self.net, self.gen, self.mc_samples)
        logits = self.net.apply(params, eps, self.x).mean(dim=0)
        return (torch.argmax(logits, -1).float() == self.y).float().cpu().numpy()

    def run(self):
        if self.load_from_saved and self.load():
            return
        for _ in range(self.total_iterations):
            self.params, self.opt_state, _ = self._train_sweep(self.params, self.opt_state)
            if self.forgetting_score_flag:
                curr_acc = self._train_accuracy(self.params)
                forgotten = self.last_acc > curr_acc
                self.forgetting_events[forgotten] += 1
                self.last_acc = curr_acc
                self.never_learnt = np.minimum(self.never_learnt, 1.0 - curr_acc)
        if self.forgetting_score_flag:
            # never-learnt examples get the maximum score (ref :405-409)
            self.forgetting_events = np.maximum(self.total_iterations * self.never_learnt,
                                                self.forgetting_events)
        if self.data_path:
            self.save()

    # --- persistence: the JAX package's .npz files (leaves in sorted-key order) ---

    def _fname(self, kind):
        return os.path.join(
            self.data_path,
            f"{kind}_{self.dnm}_{self.architecture}_{self.num_epochs}_{self.seed}.npz")

    def save(self):
        os.makedirs(self.data_path, exist_ok=True)
        np.savez(self._fname("net_state"),
                 *[l.detach().cpu().numpy() for l in tree_leaves(self.params)])
        np.savez(self._fname("forgetting"), forgetting=self.forgetting_events)

    def load(self) -> bool:
        """Read the saved parameters and forgetting counts; False when
        there is no complete saved pair."""
        try:
            d = np.load(self._fname("net_state"))
            n = len(tree_leaves(self.params))
            leaves = [torch.as_tensor(d[f"arr_{i}"], device=self.device) for i in range(n)]
            f = np.load(self._fname("forgetting"))
            forgetting = f["forgetting"]
        except (OSError, KeyError, ValueError):
            return False
        self.params = tree_unflatten(self.params, leaves)
        self.forgetting_events = forgetting
        return True


# ----------------------------------------------------------------------
# scores
# ----------------------------------------------------------------------


class ScoreCalculator:
    """Batch uncertainty scores of probabilities (N, nc)."""

    def __init__(self, outputs_prob, target, nc=10):
        self.p = torch.as_tensor(outputs_prob)
        self.target = torch.as_tensor(target, device=self.p.device)
        self.nc = nc

    def least_confidence_score(self):
        return 1.0 - torch.max(self.p, dim=1).values

    def entropy_score(self):
        return -torch.sum(self.p * torch.log(self.p + 1e-20), dim=1)

    def el2n_score(self):
        onehot = torch.nn.functional.one_hot(self.target.long(), self.nc).to(self.p.dtype)
        return torch.linalg.norm(self.p - onehot, dim=1)


def load_embeddings_csv(data_folder, dnm, seed):
    """Penultimate-layer embeddings saved by a PSVI scoring run
    (``embedding_{dnm}_{seed}.csv``, no header)."""
    fname = os.path.join(data_folder or ".", f"embedding_{dnm}_{seed}.csv")
    return np.loadtxt(fname, delimiter=",", ndmin=2).astype(np.float32)


def load_scores_csv(data_folder, dnm, seed, score_type):
    """One column of the difficulty scores saved by a PSVI scoring run
    (``score_psvi_{dnm}_{seed}.csv``, a header line of column names)."""
    fname = os.path.join(data_folder or ".", f"score_psvi_{dnm}_{seed}.csv")
    table = np.genfromtxt(fname, delimiter=",", names=True)
    return np.atleast_1d(table[score_type]).astype(np.float32)


def sample_multinomial(pval, k, rng=None):
    """Over-dispersed multinomial top-k pick (ref :733-744)."""
    rng = rng or np.random.default_rng()
    pval = np.asarray(pval, np.float64)
    N = pval.shape[0]
    k = min(k, N)
    try:
        pval = pval / pval.sum()
        samples = rng.multinomial(2 * N, pval)
        return np.argsort(samples)[-k:]
    except ValueError:
        # probabilities NumPy refuses (NaN, negative): a uniform pick
        return rng.choice(N, size=k, replace=False)


# ----------------------------------------------------------------------
# selection hierarchy
# ----------------------------------------------------------------------


class Selection:
    """Base: select indices, expose the weighted subset."""

    def __init__(self, x, y, num_pseudo, nc, seed, forgetting_flag=False, device=None):
        self.x = np.asarray(x)
        self.y = np.asarray(y)
        self.num_pseudo = num_pseudo
        self.nc = nc
        self.seed = seed
        self.forgetting_flag = forgetting_flag
        self.device = resolve_device(device)
        self.core_idc: List[int] = []
        self.wt_vec = None
        self.rng = np.random.default_rng(seed)
        self.pretrained_vi: Optional[MeanFieldVI] = None

    def select(self) -> List[int]:
        raise NotImplementedError

    def get_subset(self):
        self.core_idc = self.select()
        return self.x[self.core_idc], self.y[self.core_idc]

    def get_weighted_subset(self):
        if not self.core_idc:
            self.core_idc = list(self.rng.permutation(self.select()))
        if self.wt_vec is None:
            scale = len(self.x) / len(self.core_idc)
            self.wt_vec = scale * np.ones(len(self.core_idc), np.float32)
        idx = [int(i) for i in self.core_idc]
        return idx, self.x[idx], self.y[idx], self.wt_vec

    def pretrain(self, xt, yt, architecture, D, n_hidden, mc_samples, init_sd,
                 data_minibatch, pretrain_epochs, lr0net, data_folder, load_from_saved,
                 dnm, n_channels=1):
        self.pretrained_vi = MeanFieldVI(
            self.x, self.y, xt, yt, architecture, D, n_hidden, self.nc,
            mc_samples=mc_samples, init_sd=init_sd, data_minibatch=data_minibatch,
            num_epochs=pretrain_epochs, lr0net=lr0net, seed=self.seed,
            forgetting_score_flag=self.forgetting_flag, data_path=data_folder,
            load_from_saved=load_from_saved, dnm=dnm, n_channels=n_channels,
            device=self.device)
        self.pretrained_vi.run()

    # --- shared helpers ---

    def _balanced_pick(self, picker):
        """num_pseudo split over the classes, the remainder to the last."""
        n_train = len(self.x)
        ppc = self.num_pseudo // self.nc
        last = self.num_pseudo - (self.nc - 1) * ppc
        out = []
        for c in range(self.nc):
            idx_c = np.arange(n_train)[self.y.astype(int) == c]
            out += picker(idx_c, last if c == self.nc - 1 else ppc)
        return out

    @torch.no_grad()
    def _mean_probs(self):
        """MC-mean softmax probabilities of the pretrained net (N, nc)."""
        vi = self.pretrained_vi
        eps = draws.sample_eps(vi.net, draws.generator(self.seed + 7, vi.device),
                               vi.mc_samples)
        x = torch.as_tensor(np.asarray(self.x, np.float32), device=vi.device)
        logits = vi.net.apply(vi.params, eps, x)
        return torch.softmax(logits.mean(dim=0), dim=-1)

    @torch.no_grad()
    def _penultimate_embeddings(self):
        """Input activations of the final dense layer, summed over the S
        axis (ref ``_get_embeddings``: ``last_layer.sum(0)``)."""
        vi = self.pretrained_vi
        net, params = vi.net, vi.params
        eps = draws.sample_eps(net, draws.generator(self.seed + 11, vi.device), vi.mc_samples)
        x = torch.as_tensor(np.asarray(self.x, np.float32), device=vi.device)
        h = x.unsqueeze(0).expand((vi.mc_samples,) + tuple(x.shape))
        for layer, p, e in zip(net.layers[:-1], params[:-1], eps[:-1]):
            h = layer.apply(p, e, h)
        return h.sum(dim=0).cpu().numpy()


class RandomSelection(Selection):
    """Class-balanced random subset."""

    def select(self):
        return self._balanced_pick(lambda idx_c, n: list(
            self.rng.choice(idx_c, min(n, len(idx_c)), replace=False)))

    def pretrain(self, *a, **k):
        pass


def _num_clusters_heuristic(num_pseudo, multiple_pts):
    """The reference's cluster-count table: 30→30, 50→50, 80→20, 100→20;
    otherwise one cluster per pseudo point."""
    if not multiple_pts:
        return num_pseudo
    return {30: 30, 50: 50, 80: 20, 100: 20}.get(num_pseudo, num_pseudo)


class KmeansSelection(Selection):
    """k-means in raw or embedding space, random points per cluster."""

    def __init__(self, x, y, num_pseudo, nc, seed, forgetting_flag=False, embedding_flag=False,
                 dist="euclidean", multiple_pts=True, loaded=False, data_folder=None, dnm=None,
                 device=None, **kw):
        super().__init__(x, y, num_pseudo, nc, seed, forgetting_flag, device=device)
        self.embedding_flag = embedding_flag
        self.dist = dist
        self.multiple_pts = multiple_pts
        self.loaded = loaded
        self.data_folder = data_folder
        self.dnm = dnm

    def _features(self):
        if self.loaded:
            # the embeddings a PSVI scoring run saved
            return load_embeddings_csv(self.data_folder, self.dnm, self.seed)
        if self.embedding_flag:
            return self._penultimate_embeddings()
        return self.x.reshape(len(self.x), -1)

    def _cluster(self, features, num_clusters):
        cluster = KmeansCluster(features, self.y, num_classes=self.nc, seed=self.seed,
                                dist=self.dist, device=self.device)
        cluster.set_num_clusters(num_clusters)
        cluster.run_kmeans()
        return cluster

    def select(self):
        cluster = self._cluster(self._features(),
                                _num_clusters_heuristic(self.num_pseudo, self.multiple_pts))
        return cluster.get_arbitrary_pts(self.num_pseudo)

    def pretrain(self, *a, **k):
        # no pretraining on the loaded path
        if self.embedding_flag and not self.loaded:
            super().pretrain(*a, **k)


class ScoreSelection(Selection):
    """Top-scored points per class."""

    ALLOWED = ("least_confidence", "entropy", "el2n", "forgetting")

    def __init__(self, x, y, num_pseudo, nc, seed, forgetting_flag=False,
                 score_type="least_confidence", loaded=False, data_folder=None, dnm=None,
                 device=None, **kw):
        if score_type == "forgetting":
            forgetting_flag = True
        if score_type not in self.ALLOWED:
            raise ValueError(f"{score_type} not in {self.ALLOWED}")
        super().__init__(x, y, num_pseudo, nc, seed, forgetting_flag, device=device)
        self.score_type = score_type
        self.loaded = loaded
        self.data_folder = data_folder
        self.dnm = dnm

    def pretrain(self, *a, **k):
        # the scores come from the saved CSV on the loaded path
        if not self.loaded:
            super().pretrain(*a, **k)

    def _get_uncertainty_score(self) -> np.ndarray:
        if self.loaded:
            return load_scores_csv(self.data_folder, self.dnm, self.seed, self.score_type)
        if self.score_type == "forgetting":
            return np.asarray(self.pretrained_vi.forgetting_events)
        calc = ScoreCalculator(self._mean_probs(), self.y, nc=self.nc)
        fn = {"least_confidence": calc.least_confidence_score,
              "entropy": calc.entropy_score, "el2n": calc.el2n_score}[self.score_type]
        return fn().cpu().numpy()

    def select(self):
        score_arr = self._get_uncertainty_score()

        def picker(idx_c, n):
            top = np.argsort(-score_arr[idx_c])[: min(n, len(idx_c))]
            return list(idx_c[top])

        return self._balanced_pick(picker)


class KmeansScoreSelection(ScoreSelection):
    """Clusters, then score-weighted multinomial picks in each."""

    def __init__(self, x, y, num_pseudo, nc, seed, forgetting_flag=False,
                 score_type="least_confidence", embedding_flag=False, dist="euclidean",
                 multiple_pts=True, alpha=0.0, choose_difficult=True, loaded=False,
                 data_folder=None, dnm=None, device=None, **kw):
        super().__init__(x, y, num_pseudo, nc, seed, forgetting_flag, score_type,
                         loaded=loaded, data_folder=data_folder, dnm=dnm, device=device)
        self.embedding_flag = embedding_flag
        self.dist = dist
        self.multiple_pts = multiple_pts
        self.alpha = alpha
        self.choose_difficult = choose_difficult

    _cluster_features = KmeansSelection._features
    _cluster = KmeansSelection._cluster

    def select(self):
        score_arr = self._get_uncertainty_score()
        num_clusters = _num_clusters_heuristic(self.num_pseudo, self.multiple_pts)
        cluster = self._cluster(self._cluster_features(), num_clusters)
        pts_per_cluster = max(int(self.num_pseudo / num_clusters), 1)
        core = []
        for members in cluster.cluster_members:
            sub = score_arr[members]
            weights = sub + self.alpha if self.choose_difficult else \
                1.0 / (sub + self.alpha + 1e-20)
            s = weights.sum()
            pvals = weights / s if s > 0 else np.full(len(sub), 1 / len(sub))
            chosen = sample_multinomial(pvals, pts_per_cluster, self.rng)
            core += [int(members[i]) for i in chosen]
        return core


class RandomScoreSelection(ScoreSelection):
    """Half random, half top-scored."""

    def select(self):
        n_train = len(self.x)
        ppc = max(self.num_pseudo // (2 * self.nc), 1)
        last = max(self.num_pseudo // 2 - (self.nc - 1) * ppc, 1)
        rand_idc = []
        for c in range(self.nc):
            idx_c = np.arange(n_train)[self.y.astype(int) == c]
            n = last if c == self.nc - 1 else ppc
            rand_idc += list(self.rng.choice(idx_c, min(n, len(idx_c)), replace=False))
        n_scored = self.num_pseudo - len(rand_idc)
        score_arr = self._get_uncertainty_score()
        ppc2 = n_scored // self.nc
        last2 = n_scored - (self.nc - 1) * ppc2
        scored = []
        for c in range(self.nc):
            idx_c = np.arange(n_train)[self.y.astype(int) == c]
            n = last2 if c == self.nc - 1 else ppc2
            top = np.argsort(-score_arr[idx_c])[: max(min(n, len(idx_c)), 0)]
            scored += list(idx_c[top])
        return rand_idc + scored


class RandomIncrementalSelection(ScoreSelection):
    """Adds the single highest-scored point not in the coreset yet."""

    def __init__(self, x, y, num_pseudo, nc, seed, score_type="entropy", device=None, **kw):
        super().__init__(x, y, num_pseudo, nc, seed, score_type=score_type, device=device)
        self.current_core_idc: List[int] = []

    def update_current_state(self, current_core_idc, pretrained_vi):
        self.current_core_idc = list(current_core_idc)
        self.pretrained_vi = pretrained_vi

    def select(self):
        order = np.argsort(-self._get_uncertainty_score())
        for new_index in order:
            if int(new_index) not in self.current_core_idc:
                return self.current_core_idc + [int(new_index)]
        return list(self.current_core_idc)

    def get_weighted_subset(self):
        self.core_idc = self.select()
        scale = len(self.x) / len(self.core_idc)
        self.wt_vec = scale * np.ones(len(self.core_idc), np.float32)
        idx = [int(i) for i in self.core_idc]
        return idx, self.x[idx], self.y[idx], self.wt_vec


class WeightedKmeansSelection(KmeansScoreSelection):
    """k-means points with score-proportional weights."""

    def select(self):
        self._kmeans = self._cluster(self._cluster_features(),
                                     _num_clusters_heuristic(self.num_pseudo,
                                                             self.multiple_pts))
        return self._kmeans.get_arbitrary_pts(self.num_pseudo)

    def get_weighted_subset(self):
        if not self.core_idc:
            self.core_idc = self.select()
        score_arr = self._get_uncertainty_score()
        scale = len(self.x) / len(self.core_idc)
        w0 = score_arr[self.core_idc]
        self.wt_vec = (scale / max(w0.sum(), 1e-20)) * w0
        idx = [int(i) for i in self.core_idc]
        return idx, self.x[idx], self.y[idx], self.wt_vec.astype(np.float32)


class KmeansGradientSelection(KmeansSelection):
    """k-means in last-layer-gradient space."""

    def __init__(self, x, y, num_pseudo, nc, seed, forgetting_flag=False, embedding_flag=True,
                 dist="euclidean", last_layer_only=False, device=None, **kw):
        super().__init__(x, y, num_pseudo, nc, seed, forgetting_flag, embedding_flag=True,
                         dist=dist, device=device)
        self.last_layer_only = last_layer_only

    def _gradient_embeddings(self):
        """∂L/∂(mean logits) per example (p − onehot), with the penultimate
        activations' outer product unless ``last_layer_only``."""
        probs = self._mean_probs().cpu().numpy()  # (N, nc)
        bias_grads = probs - np.eye(self.nc, dtype=np.float32)[self.y.astype(int)]
        if self.last_layer_only:
            return bias_grads
        emb = self._penultimate_embeddings()  # (N, E)
        outer = emb[:, None, :] * bias_grads[:, :, None]  # (N, nc, E)
        return np.concatenate([bias_grads, outer.reshape(len(emb), -1)], axis=1)

    def select(self):
        cluster = self._cluster(self._gradient_embeddings(), self.num_pseudo)
        return cluster.get_arbitrary_pts(self.num_pseudo)

    def pretrain(self, *a, **k):
        Selection.pretrain(self, *a, **k)


class SubmodularSelection(KmeansGradientSelection):
    """Facility-location lazy greedy in gradient space, per class."""

    def select(self):
        grads = self._gradient_embeddings()
        n_train = len(self.x)
        ppc = self.num_pseudo // self.nc
        last = self.num_pseudo - (self.nc - 1) * ppc
        core = []
        for c in range(self.nc):
            idx_c = np.arange(n_train)[self.y.astype(int) == c]
            n_pts = last if c == self.nc - 1 else ppc
            pair = SM.euclidean_dist_pair if self.dist == "euclidean" else SM.cossim_pair
            matrix = -1.0 * pair(grads[idx_c], device=self.device)
            matrix -= np.min(matrix) - 1e-3
            fn = SM.FacilityLocation(index=idx_c, similarity_matrix=matrix)
            opt = SM.LazyGreedy(index=idx_c, budget=min(n_pts, len(idx_c)))
            core += list(opt.select(gain_function=fn.calc_gain, update_state=fn.update_state))
        return [int(i) for i in core]


class CoresetSelect:
    """Score-method dispatcher (JAX ``CoresetSelect``)."""

    def __init__(self, x, y, xt, yt, num_pseudo=100, nc=2, architecture="logistic_regression",
                 D=None, n_hidden=100, mc_samples=4, init_sd=1e-3, data_minibatch=128,
                 pretrain_epochs=5, lr0net=1e-3, seed=0, score_method="random",
                 data_folder=None, load_from_saved=False, dnm=None, distance_fn="euclidean",
                 last_layer_only=False, multiple_pts_per_cluster=True, loaded_from_psvi=False,
                 alpha_dirichlet=0.0, choose_difficult=True, n_channels=1, device=None, **kw):
        self.x, self.y, self.xt, self.yt = x, y, xt, yt
        self.num_pseudo, self.nc = num_pseudo, nc
        self.architecture = architecture
        self.D, self.n_hidden = D, n_hidden
        self.mc_samples, self.init_sd = mc_samples, init_sd
        self.data_minibatch = data_minibatch
        self.pretrain_epochs, self.lr0net = pretrain_epochs, lr0net
        self.seed = seed
        self.score_method = score_method
        self.data_folder = data_folder
        self.load_from_saved = load_from_saved
        self.dnm = dnm
        self.distance_fn = distance_fn
        self.last_layer_only = last_layer_only
        self.loaded_from_psvi = loaded_from_psvi
        self.multiple_pts = multiple_pts_per_cluster
        self.alpha_dirichlet = alpha_dirichlet
        self.choose_difficult = choose_difficult
        self.n_channels = n_channels
        self.device = resolve_device(device)
        self.wt_index = {}

    def select_data(self):
        embedding_flag = self.architecture == "lenet"
        common = dict(x=self.x, y=self.y, num_pseudo=self.num_pseudo, nc=self.nc,
                      seed=self.seed, device=self.device)
        sm = self.score_method
        loaded_kw = dict(loaded=self.loaded_from_psvi, data_folder=self.data_folder,
                         dnm=self.dnm)
        if sm == "kmeans":
            method = KmeansSelection(**common, embedding_flag=embedding_flag,
                                     dist=self.distance_fn, multiple_pts=self.multiple_pts,
                                     **loaded_kw)
        elif sm == "kmeans_gradient":
            method = KmeansGradientSelection(**common, dist=self.distance_fn,
                                             last_layer_only=self.last_layer_only)
        elif sm == "submodular":
            method = SubmodularSelection(**common, dist=self.distance_fn,
                                         last_layer_only=self.last_layer_only)
        elif sm == "random":
            method = RandomSelection(**common)
        elif sm in ScoreSelection.ALLOWED:
            method = ScoreSelection(**common, score_type=sm, **loaded_kw)
        elif sm.startswith("scored_kmeans_"):
            method = KmeansScoreSelection(
                **common, score_type=re.sub(r"^scored_kmeans_", "", sm),
                embedding_flag=embedding_flag, dist=self.distance_fn,
                multiple_pts=self.multiple_pts, alpha=self.alpha_dirichlet,
                choose_difficult=self.choose_difficult, **loaded_kw)
        elif sm.startswith("scored_random_"):
            method = RandomScoreSelection(**common,
                                          score_type=re.sub(r"^scored_random_", "", sm))
        elif sm == "weighted_kmeans":
            method = WeightedKmeansSelection(**common, score_type="entropy",
                                             embedding_flag=embedding_flag,
                                             dist=self.distance_fn)
        else:
            raise ValueError(f"{sm} is not implemented")

        self.method = method
        method.pretrain(self.xt, self.yt, self.architecture, self.D, self.n_hidden,
                        self.mc_samples, self.init_sd, self.data_minibatch,
                        self.pretrain_epochs, self.lr0net, self.data_folder,
                        self.load_from_saved, self.dnm, n_channels=self.n_channels)
        idx, xs, ys, wts = method.get_weighted_subset()
        self.chosen = (idx, xs, ys, wts)
        self.wt_index = {str(k): float(v) for k, v in zip(idx, wts)}
        return idx, xs, ys, wts
