"""Dataset registry for the port.

Counterpart of ``psvi_tpu/data/datasets.py``: full datasets live in host
NumPy arrays; the engine moves them to its device once and draws one
minibatch per outer step there. The port reads the synthetic datasets of
the dense slice, synth_mnist (LeNet slice) and the generated sinus
regression set; every other name raises and points to ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from psvi_torch.data import synthetic

# channels, side, classes, n_train (ref experiments_utils.py:42-78)
DATASET_STATS = {
    "synth_mnist": (1, 28, 10, 6000),
}


@dataclasses.dataclass
class DataBundle:
    x: np.ndarray  # train inputs
    y: np.ndarray  # train targets (float labels, reference convention)
    xt: np.ndarray  # test inputs
    yt: np.ndarray
    N: int
    D: int  # flat feature dim (vision: side*side, as the JAX package)
    nc: int
    channels: int = 0  # >0 for image data (x is (N, C, H, W))
    xv: Optional[np.ndarray] = None  # validation (regression)
    yv: Optional[np.ndarray] = None
    y_mean: float = 0.0  # regression: train-target normalisation
    y_std: float = 1.0
    taus: Tuple[float, ...] = ()  # regression: the tau grid of the dataset


def _split_train_test(X, Y, test_ratio):
    """Split from the end (ref experiments_utils.py:797-804)."""
    Y = np.where(Y == -1, 0, Y)
    test_size = int(test_ratio * X.shape[0])
    return X[:-test_size], Y[:-test_size], X[-test_size:], Y[-test_size:]


def _read_vision(dnm, rng):
    channels, side, nc, n_train = DATASET_STATS[dnm]
    x, y, xt, yt = synthetic.make_synth_images(
        n_per_class=n_train // nc, nc=nc, side=side, channels=channels, rng=rng)
    return DataBundle(x, y, xt, yt, len(x), side * side, nc, channels=channels)


def read_dataset(dnm: str, test_ratio: float = 0.2, seed: int = 0) -> DataBundle:
    rng = np.random.default_rng(seed)
    if dnm == "halfmoon":
        X, Y = synthetic.make_halfmoon(1000, 0.1, 42)
        nc = 2
    elif dnm == "four_blobs":
        X, Y = synthetic.make_four_class_dataset(250, rng)
        nc = 4
    elif dnm.startswith("synth_lr_"):
        X, Y = synthetic.make_synthetic(1000, D=int(dnm.split("_")[-1]), rng=rng)
        nc = 2
    elif dnm in DATASET_STATS:
        return _read_vision(dnm, rng)
    else:
        raise ValueError(
            f"dataset {dnm!r} is not ported yet: psvi_torch reads halfmoon, "
            "four_blobs, synth_lr_<D> and synth_mnist (see ROADMAP.md, queue A)"
        )
    x, y, xt, yt = _split_train_test(X, Y, test_ratio)
    N, D = x.shape
    return DataBundle(x, y, xt, yt, N, D, nc)


def hyperparams_for_regression():
    """Tau grid-search space (ref experiments_utils.py:271-296)."""
    return {
        "concrete": [0.025, 0.05, 0.075],
        "energy": [0.25, 0.5, 0.75],
        "power": [0.05, 0.1, 0.15],
        "kin8nm": [150, 200, 250],
        "protein": [0.025, 0.05, 0.075],
        "naval": [30000, 40000, 50000],
        "yacht": [0.25, 0.5, 0.75],
        "boston": [0.1, 0.15, 0.2],
        "wine": [2.5, 3.0, 3.5],
        "year": [0.1, 1.0, 10.0],
        "sinus": [0.1, 1.0, 10.0],
        "diabetes": [1e-3, 2e-3, 4e-3],
    }


def get_regression_benchmark(name, seed=111, **split_kwargs):
    """(X, Y), splits (ref experiments_utils.py:217-268). Only the generated
    ``sinus`` is ported: the UCI sets need their files in the repository and
    ``diabetes`` needs scikit-learn."""
    if name != "sinus":
        raise NotImplementedError(
            f"regression benchmark {name!r} is not ported yet: psvi_torch reads "
            "the generated 'sinus' (see ROADMAP.md, queue A item 7)")
    rng = np.random.default_rng(seed)
    X, Y = synthetic.make_sinus(1000, rng)
    return (X, Y), split_data(len(X), seed=seed, **split_kwargs)


def split_data(N, p_split=(0.6, 0.2, 0.2), n_split=None, shuffle=True, seed=None):
    """Train/val/test index splitter (ref experiments_utils.py:107-141)."""
    rng = np.random.default_rng(seed)
    if n_split is None:
        p_split = np.array(p_split, dtype=np.float64)
        assert np.sum(p_split == -1) <= 1
        p_split[p_split == -1] = 1 - (np.sum(p_split) + 1)
        train_idx = int(np.ceil(p_split[0] * N))
        val_idx = int(np.ceil(train_idx + p_split[1] * N))
    else:
        n_split = np.array(n_split)
        assert np.sum(n_split == -1) <= 1
        n_split[n_split == -1] = N - (np.sum(n_split) + 1)
        train_idx = int(n_split[0])
        val_idx = int(train_idx + n_split[1])
    idx = np.arange(N)
    if shuffle:
        rng.shuffle(idx)
    return {"train": idx[:train_idx], "val": idx[train_idx:val_idx],
            "test": idx[val_idx:]}


def read_regression_dataset(dnm, seed=0, num_test=100):
    """Normalized regression bundle (ref experiments_utils.py:159-214):
    ``num_test`` points for test, 10 % for validation, the rest for
    training; inputs and train targets normalised by the train split's
    statistics, test and validation targets left raw."""
    (X, Y), _ = get_regression_benchmark(dnm, seed=seed, n_split=(0, 0, 0), shuffle=False)
    N_total = len(X)
    n_val = int(np.ceil(0.1 * N_total))
    n_te = int(num_test) if num_test >= 1 else int(np.ceil(num_test * N_total))
    idx = split_data(N_total, n_split=(N_total - n_val - n_te, n_val, n_te), seed=seed)
    taus = hyperparams_for_regression()[dnm]
    x, y = X[idx["train"]], Y[idx["train"]]
    xv, yv = X[idx["val"]], Y[idx["val"]]
    xt, yt = X[idx["test"]], Y[idx["test"]]
    x_mean, x_std = np.mean(x, 0), np.std(x, 0)
    y_mean, y_std = np.mean(y), np.std(y)
    x_std = np.where(x_std == 0, 1.0, x_std)

    def norm(a):
        return ((a - x_mean) / x_std).astype(np.float32)

    return DataBundle(
        x=norm(x), y=((y - y_mean) / y_std).astype(np.float32),
        xt=norm(xt), yt=yt.astype(np.float32),
        xv=norm(xv), yv=yv.astype(np.float32),
        N=len(x), D=x.shape[1], nc=1,
        y_mean=float(y_mean), y_std=float(y_std), taus=tuple(taus),
    )
