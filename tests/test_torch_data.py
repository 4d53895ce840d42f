"""The port's datasets equal the JAX package's bit for bit (halfmoon without
scikit-learn included)."""

import numpy as np
import pytest

from psvi_torch.data import read_dataset
from psvi_torch.data.synthetic import make_moons
from psvi_tpu.data import read_dataset as jax_read_dataset


@pytest.mark.parametrize("name", ["halfmoon", "four_blobs", "synth_lr_5", "synth_lr_2"])
def test_read_dataset_matches_jax_bitwise(name):
    a, b = read_dataset(name), jax_read_dataset(name)
    for k in ("x", "y", "xt", "yt"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y), k
    assert (a.N, a.D, a.nc) == (b.N, b.D, b.nc)


@pytest.mark.parametrize("n,noise,seed", [(1000, 0.1, 42), (101, 0.3, 0), (7, 0.0, 3)])
def test_make_moons_matches_sklearn_bitwise(n, noise, seed):
    from sklearn.datasets import make_moons as sk_make_moons

    X, y = make_moons(n, noise, seed)
    Xs, ys = sk_make_moons(n_samples=n, noise=noise, random_state=seed)
    assert np.array_equal(X, Xs) and np.array_equal(y, ys)


def test_unported_dataset_points_to_roadmap():
    with pytest.raises(ValueError, match="ROADMAP"):
        read_dataset("synth_mnist")
