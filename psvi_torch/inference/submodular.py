"""Submodular coreset selection.

Counterpart of ``psvi_tpu/inference/submodular.py`` (ref
``psvi/submodular/``): the objective functions (``FacilityLocation``,
``GraphCut``, ``LogDeterminant``) and the greedy maximizers
(``NaiveGreedy``, ``LazyGreedy``, ``StochasticGreedy``,
``ApproximateLazyGreedy``, ``OPTIMIZERS``). The similarity matrices are
computed in torch on the device in float32, as JAX computes them; the
sequential greedy loops stay on the host over NumPy, as JAX's do.
"""

from __future__ import annotations

import numpy as np
import torch

from psvi_torch.device import resolve_device
from psvi_torch.ops.kmeans import pairwise_sq_dists


def euclidean_dist_pair(x, device=None) -> np.ndarray:
    """Pairwise euclidean distances (ref submodular/euclidean.py:5-35)."""
    xt = torch.as_tensor(np.asarray(x, np.float32), device=resolve_device(device))
    d2 = pairwise_sq_dists(xt, xt)
    return torch.sqrt(torch.clamp_min(d2, 0.0)).cpu().numpy()


def cossim_pair(x, device=None) -> np.ndarray:
    """Pairwise cosine similarity rescaled to [0, 1] (ref
    submodular/cossim.py:5-33)."""
    xt = torch.as_tensor(np.asarray(x, np.float32), device=resolve_device(device))
    n = torch.linalg.norm(xt, dim=1, keepdim=True)
    xn = xt / torch.where(n == 0, 1.0, n)
    return ((xn @ xn.T + 1.0) / 2.0).cpu().numpy()


class SubmodularFunction:
    """Base with a full similarity matrix (ref submodular_function.py:4-27)."""

    def __init__(self, index, similarity_matrix, already_selected=()):
        self.index = np.asarray(index)
        self.n = len(self.index)
        self.already_selected = list(already_selected)
        assert similarity_matrix.shape == (self.n, self.n)
        self.similarity_matrix = np.asarray(similarity_matrix)

    def similarity_kernel(self, a, b):
        return self.similarity_matrix[np.ix_(a, b)]


class FacilityLocation(SubmodularFunction):
    """Max-coverage gain (ref :30-72)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        if not self.already_selected:
            self.cur_max = np.zeros(self.n, np.float32)
        else:
            self.cur_max = np.max(
                self.similarity_kernel(np.arange(self.n), self.already_selected),
                axis=1,
            )
        self.all_idx = np.ones(self.n, bool)

    def calc_gain(self, idx_gain, selected, **kwargs):
        return np.maximum(
            0.0,
            self.similarity_kernel(self.all_idx, idx_gain)
            - self.cur_max.reshape(-1, 1),
        ).sum(axis=0)

    def update_state(self, new_selection, total_selected, **kwargs):
        self.cur_max = np.maximum(
            self.cur_max,
            np.max(self.similarity_kernel(self.all_idx, new_selection), axis=1),
        )


class GraphCut(SubmodularFunction):
    """(ref :75-110)"""

    def __init__(self, lam: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.lam = lam
        self.sim_matrix_cols_sum = np.sum(self.similarity_matrix, axis=0)
        self.all_idx = np.ones(self.n, bool)

    def calc_gain(self, idx_gain, selected, **kwargs):
        return (
            -2.0 * np.sum(self.similarity_kernel(selected, idx_gain), axis=0)
            + self.lam * self.sim_matrix_cols_sum[idx_gain]
        )

    def update_state(self, new_selection, total_selected, **kwargs):
        pass


class LogDeterminant(SubmodularFunction):
    """(ref :113-143)"""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.all_idx = np.ones(self.n, bool)

    def calc_gain(self, idx_gain, selected, **kwargs):
        sim_ig = self.similarity_kernel(selected, idx_gain).T
        sim_sel = self.similarity_kernel(selected, selected)
        return (sim_ig @ np.linalg.pinv(sim_sel) * sim_ig).sum(-1)

    def update_state(self, new_selection, total_selected, **kwargs):
        pass


class _Optimizer:
    def __init__(self, index, budget: int, already_selected=()):
        self.index = np.asarray(index)
        if budget <= 0 or budget > len(self.index):
            raise ValueError("Illegal budget for optimizer.")
        self.n = len(self.index)
        self.budget = budget
        self.already_selected = list(already_selected)


class NaiveGreedy(_Optimizer):
    """(ref submodular_optimizer.py:20-41)"""

    def select(self, gain_function, update_state=None, **kwargs):
        selected = np.zeros(self.n, bool)
        selected[self.already_selected] = True
        greedy_gain = np.zeros(self.n)
        for _ in range(int(selected.sum()), self.budget):
            greedy_gain[~selected] = gain_function(~selected, selected, **kwargs)
            cur = int(greedy_gain.argmax())
            selected[cur] = True
            greedy_gain[cur] = -np.inf
            if update_state is not None:
                update_state(np.array([cur]), selected, **kwargs)
        return self.index[selected]


class LazyGreedy(_Optimizer):
    """(ref :44-79)"""

    def select(self, gain_function, update_state=None, **kwargs):
        selected = np.zeros(self.n, bool)
        selected[self.already_selected] = True
        greedy_gain = np.zeros(self.n)
        greedy_gain[~selected] = gain_function(~selected, selected, **kwargs)
        greedy_gain[selected] = -np.inf
        for _ in range(int(selected.sum()), self.budget):
            best_gain, last_max = -np.inf, -1
            while True:
                cur = int(greedy_gain.argmax())
                if last_max == cur:
                    selected[cur] = True
                    greedy_gain[cur] = -np.inf
                    if update_state is not None:
                        update_state(np.array([cur]), selected, **kwargs)
                    break
                new_gain = gain_function(np.array([cur]), selected, **kwargs)[0]
                greedy_gain[cur] = new_gain
                if new_gain >= best_gain:
                    best_gain, last_max = new_gain, cur
        return self.index[selected]


class StochasticGreedy(_Optimizer):
    """(ref :82-114)"""

    def __init__(self, index, budget, already_selected=(), epsilon=0.9, seed=0):
        super().__init__(index, budget, already_selected)
        self.epsilon = epsilon
        self.rng = np.random.default_rng(seed)

    def select(self, gain_function, update_state=None, **kwargs):
        selected = np.zeros(self.n, bool)
        selected[self.already_selected] = True
        sample_size = max(round(-np.log(self.epsilon) * self.n / self.budget), 1)
        greedy_gain = np.zeros(self.n)
        all_idx = np.arange(self.n)
        for i in range(int(selected.sum()), self.budget):
            pool = all_idx[~selected]
            subset = self.rng.choice(
                pool, size=min(sample_size, len(pool)), replace=False
            )
            if len(subset) == 0:
                break
            greedy_gain[subset] = gain_function(subset, selected, **kwargs)
            pick = subset[int(greedy_gain[subset].argmax())]
            selected[pick] = True
            greedy_gain[pick] = -np.inf
            if update_state is not None:
                update_state(np.array([pick]), selected, **kwargs)
        return self.index[selected]


class ApproximateLazyGreedy(_Optimizer):
    """(ref :117-152)"""

    def __init__(self, index, budget, already_selected=(), beta=0.9):
        super().__init__(index, budget, already_selected)
        self.beta = beta

    def select(self, gain_function, update_state=None, **kwargs):
        selected = np.zeros(self.n, bool)
        selected[self.already_selected] = True
        greedy_gain = np.zeros(self.n)
        greedy_gain[~selected] = gain_function(~selected, selected, **kwargs)
        greedy_gain[selected] = -np.inf
        for _ in range(int(selected.sum()), self.budget):
            while True:
                cur = int(greedy_gain.argmax())
                max_gain = greedy_gain[cur]
                new_gain = gain_function(np.array([cur]), selected, **kwargs)[0]
                if new_gain >= self.beta * max_gain:
                    selected[cur] = True
                    greedy_gain[cur] = -np.inf
                    if update_state is not None:
                        update_state(np.array([cur]), selected, **kwargs)
                    break
                greedy_gain[cur] = new_gain
        return self.index[selected]


OPTIMIZERS = {
    "NaiveGreedy": NaiveGreedy,
    "LazyGreedy": LazyGreedy,
    "StochasticGreedy": StochasticGreedy,
    "ApproximateLazyGreedy": ApproximateLazyGreedy,
}
