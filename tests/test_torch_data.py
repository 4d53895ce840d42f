"""The port's datasets equal the JAX package's bit for bit (halfmoon without
scikit-learn, and the synth_mnist images, included)."""

import numpy as np
import pytest

from psvi_torch.data import read_dataset
from psvi_torch.data.synthetic import make_moons
from psvi_tpu.data import read_dataset as jax_read_dataset


@pytest.mark.parametrize("name", ["halfmoon", "four_blobs", "synth_lr_5", "synth_lr_2",
                                  "synth_mnist"])
def test_read_dataset_matches_jax_bitwise(name):
    a, b = read_dataset(name), jax_read_dataset(name)
    for k in ("x", "y", "xt", "yt"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y), k
    assert (a.N, a.D, a.nc, a.channels) == (b.N, b.D, b.nc, b.channels)


@pytest.mark.parametrize("n,noise,seed", [(1000, 0.1, 42), (101, 0.3, 0), (7, 0.0, 3)])
def test_make_moons_matches_sklearn_bitwise(n, noise, seed):
    from sklearn.datasets import make_moons as sk_make_moons

    X, y = make_moons(n, noise, seed)
    Xs, ys = sk_make_moons(n_samples=n, noise=noise, random_state=seed)
    assert np.array_equal(X, Xs) and np.array_equal(y, ys)


def test_synth_mnist_shapes():
    d = read_dataset("synth_mnist")
    assert d.x.shape == (6000, 1, 28, 28) and d.xt.shape == (1000, 1, 28, 28)
    assert (d.N, d.D, d.nc, d.channels) == (6000, 784, 10, 1)


def test_unported_dataset_points_to_roadmap(tmp_path):
    """Every name of JAX's registry reads; the file-gated ones raise
    FileNotFoundError without their file (tests/test_torch_data_readers.py
    reads them from files), and a name outside the registry raises
    ValueError, as JAX's reader does."""
    for name in ("mnist", "fashion_mnist", "cifar10"):
        with pytest.raises(ValueError, match="unknown dataset"):
            read_dataset(name)
    for name in ("MNIST", "FashionMNIST", "Cifar10", "phishing"):
        with pytest.raises(FileNotFoundError, match=name.lower() if name != "phishing"
                           else "phishing.npz"):
            read_dataset(name, data_folder=str(tmp_path))
    assert read_dataset("synth_cifar").x.shape == (6000, 3, 32, 32)
