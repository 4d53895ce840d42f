"""k-means on the device (Lloyd iterations as matmuls), and the per-class
clustering of the selection baselines.

Counterpart of ``psvi_tpu/ops/kmeans.py``: the distance step is
``‖x‖² − 2 x·cᵀ + ‖c‖²`` (one matmul), the centroid update a one-hot
matmul, both in float32 on the device (TF32 off, ``device.fp32_exact``);
k-means++ draws from a ``torch.Generator``. ``KmeansCluster`` and
``KmeansOnDevice`` keep JAX's backend names: ``"jax"`` is the on-device
path (here torch), ``"native"`` the C++ library of ``psvi_torch/native``.
"""

from __future__ import annotations

import numpy as np
import torch

from psvi_torch.device import resolve_device
from psvi_torch.utils import draws


def pairwise_sq_dists(X, C):
    """(N, K) squared euclidean distances via matmul."""
    xn = torch.sum(torch.square(X), dim=1, keepdim=True)
    cn = torch.sum(torch.square(C), dim=1)[None, :]
    return torch.clamp_min(xn - 2.0 * (X @ C.T) + cn, 0.0)


def _kmeans_pp_init(generator, X, k: int):
    """k-means++ seeding: the first centroid uniform, each next one drawn
    with probability ∝ the squared distance to the nearest chosen one."""
    n = X.shape[0]
    first = torch.randint(0, n, (1,), generator=generator, device=X.device)
    cents = torch.zeros((k, X.shape[1]), dtype=X.dtype, device=X.device)
    cents[0] = X[first[0]]
    for i in range(1, k):
        dmin = torch.amin(pairwise_sq_dists(X, cents[:i]), dim=1)
        p = dmin / torch.clamp_min(torch.sum(dmin), 1e-30)
        nxt = torch.multinomial(p, 1, generator=generator)
        cents[i] = X[nxt[0]]
    return cents


def kmeans_fit(generator, X, k: int, iters: int = 25, init=None):
    """k-means++ (or the centroids ``init``) then ``iters`` Lloyd
    iterations; returns (centroids (k, D), labels (N,)). An empty cluster
    keeps its centroid."""
    cents = _kmeans_pp_init(generator, X, k) if init is None else init.to(X)
    for _ in range(iters):
        assign = torch.argmin(pairwise_sq_dists(X, cents), dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).to(X.dtype)  # (N, k)
        counts = torch.sum(onehot, dim=0)
        new = (onehot.T @ X) / torch.clamp_min(counts, 1.0)[:, None]
        cents = torch.where((counts > 0)[:, None], new, cents)
    labels = torch.argmin(pairwise_sq_dists(X, cents), dim=1)
    return cents, labels


def nearest_index(X, C):
    """Index of the nearest row of X for each centroid (faiss IndexFlatL2
    search analog)."""
    return torch.argmin(pairwise_sq_dists(C, X), dim=1)


def _l2_normalize(X):
    return X / torch.clamp_min(torch.linalg.norm(X, dim=1, keepdim=True), 1e-12)


class KmeansCluster:
    """Per-class (balanced) or global k-means clustering with random
    per-cluster point picks (JAX ``KmeansCluster``). The per-cluster picks
    draw from NumPy's ``default_rng(seed)``, as in JAX; k-means++ from a
    generator seeded with ``seed``, one fit after the other."""

    def __init__(self, x, y, num_classes=2, balance=True, seed=0, dist="euclidean",
                 iters=25, backend="jax", device=None):
        if dist not in ("euclidean", "cosine"):
            raise ValueError(f"invalid dist {dist!r}")
        if backend not in ("jax", "native"):
            raise ValueError(f"invalid backend {backend!r} (expected 'jax' or 'native')")
        self.x = np.asarray(x, np.float32).reshape(len(x), -1)
        self.y = np.asarray(y)
        self.num_classes = num_classes
        self.balance = balance
        self.seed = seed
        self.dist = dist
        self.iters = iters
        self.backend = backend  # 'jax': on the device; 'native': the C++ library
        self.device = resolve_device(device)
        self.cluster_members: list = []  # lists of global indices
        self.cluster_centers: list = []

    def _fit(self, gen, X, k):
        """One k-means fit on the configured backend; NumPy (centroids,
        labels)."""
        if self.backend == "native":
            from psvi_torch import native

            C, labels, _ = native.kmeans_fit(np.asarray(X), k, iters=self.iters,
                                             seed=self.seed)
            return C, labels
        Xd = torch.as_tensor(np.asarray(X), dtype=torch.float32, device=self.device)
        cents, labels = kmeans_fit(gen, Xd, k, self.iters)
        return cents.cpu().numpy(), labels.cpu().numpy()

    def set_num_clusters(self, num_clusters):
        self.num_clusters = num_clusters
        self.pts_per_class = max(int(np.floor(num_clusters / self.num_classes)), 2)

    def _features(self):
        if self.dist == "cosine":
            X = torch.as_tensor(self.x, device=self.device)
            return _l2_normalize(X).cpu().numpy()
        return self.x

    def run_kmeans(self):
        self.cluster_members, self.cluster_centers = [], []
        X = self._features()
        gen = draws.generator(self.seed, self.device)
        if self.balance:
            for c in range(self.num_classes):
                idx = np.where(self.y.astype(int) == c)[0]
                k = min(self.pts_per_class, len(idx))
                if k == 0:
                    continue
                cents, labels = self._fit(gen, X[idx], k)
                for j in range(k):
                    members = idx[labels == j]
                    if len(members):
                        self.cluster_members.append(members)
                self.cluster_centers.append(cents)
        else:
            k = self.num_clusters
            cents, labels = self._fit(gen, X, k)
            for j in range(k):
                members = np.where(labels == j)[0]
                if len(members):
                    self.cluster_members.append(members)
            self.cluster_centers.append(cents)

    def get_arbitrary_pts(self, total_pts=None):
        ncl = len(self.cluster_members)
        if ncl == 0:
            return []
        total = total_pts if total_pts is not None else ncl
        per = [total // ncl] * ncl
        per[-1] = total - sum(per[:-1])
        rng = np.random.default_rng(self.seed)
        out = []
        shortfall = 0
        for members, n in zip(self.cluster_members, per):
            n_take = min(max(n, 0), len(members))
            shortfall += max(n, 0) - n_take
            if n_take:
                out += list(rng.choice(members, n_take, replace=False))
        if shortfall:
            # a cluster smaller than its quota: the deficit is drawn from the
            # points not chosen yet, so the requested count is honoured
            chosen = set(out)
            pool = np.asarray([m for members in self.cluster_members for m in members
                               if m not in chosen])
            extra = min(shortfall, len(pool))
            if extra:
                out += list(rng.choice(pool, extra, replace=False))
        return out


class KmeansOnDevice(KmeansCluster):
    """The nearest real datapoint to each centroid (JAX ``KmeansOnDevice``,
    the faiss analog)."""

    def run_kmeans(self):
        self.cluster_members, self.cluster_centers = [], []
        X = self._features()
        gen = draws.generator(self.seed, self.device)
        centers = []

        def nearest(Xn, cents):
            return nearest_index(torch.as_tensor(Xn, device=self.device),
                                 torch.as_tensor(cents, device=self.device)).cpu().numpy()

        if self.balance:
            for c in range(self.num_classes):
                idx = np.where(self.y.astype(int) == c)[0]
                k = min(self.pts_per_class, len(idx))
                if k == 0:
                    continue
                cents, _ = self._fit(gen, X[idx], k)
                centers += list(idx[nearest(X[idx], cents)])
        else:
            # one global clustering with num_clusters centroids
            cents, _ = self._fit(gen, X, self.num_clusters)
            centers = list(nearest(X, cents))
        self.cluster_centers = centers

    def get_arbitrary_pts(self, total_pts=None):
        return list(self.cluster_centers)
