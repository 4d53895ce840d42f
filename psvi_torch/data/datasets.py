"""Dataset registry for the port.

Counterpart of ``psvi_tpu/data/datasets.py``: full datasets live in host
NumPy arrays; the engine moves them to its device once and draws one
minibatch per outer step there. The port reads the synthetic datasets of
the dense slice and synth_mnist (LeNet slice); every other name raises and
points to ROADMAP.md.
"""

from __future__ import annotations

import dataclasses

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
