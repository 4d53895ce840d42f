"""Synthetic dataset generators (host-side NumPy).

The port's own copies of ``psvi_tpu/data/synthetic.py``'s generators for
the datasets of the dense, LeNet and regression slices
(``make_synth_images`` makes synth_mnist, ``make_sinus`` the sinus
regression set). ``make_halfmoon`` reproduces
``sklearn.datasets.make_moons`` bit for bit without scikit-learn: the same
``RandomState`` generator, half-circles, index shuffle and additive noise,
in the same order.
"""

from __future__ import annotations

import numpy as np


def make_four_class_dataset(N_K: int = 250, rng=None):
    rng = rng or np.random.default_rng(0)
    X1 = np.stack(
        [0.8 + 0.4 * rng.standard_normal(N_K), 1.5 + 0.4 * rng.standard_normal(N_K)],
        axis=-1,
    )
    X2 = np.stack(
        [0.5 + 0.6 * rng.standard_normal(N_K), -0.2 - 0.1 * rng.standard_normal(N_K)],
        axis=-1,
    )
    X3 = np.stack(
        [2.5 - 0.1 * rng.standard_normal(N_K), 1.0 + 0.6 * rng.standard_normal(N_K)],
        axis=-1,
    )
    cov = np.array([[0.2, 0.1], [0.1, 0.1]])
    X4 = rng.multivariate_normal([-0.5, 1.5], cov, size=N_K)
    X = np.concatenate([X1, X2, X3, X4]).astype(np.float32)
    Y = np.concatenate([np.full(N_K, c) for c in range(4)]).astype(np.float32)
    X[:, 1] -= 1
    X[:, 0] -= 0.5
    perm = rng.permutation(len(X))
    return X[perm], Y[perm]


def make_synthetic(num_datapoints: int = 1000, D: int = 2, rng=None):
    """D-dimensional synthetic logistic regression."""
    rng = rng or np.random.default_rng(0)
    th = np.full(D, 5.0)
    X = rng.multivariate_normal(np.zeros(D), np.eye(D), num_datapoints)
    ps = 1.0 / (1.0 + np.exp(-(X * th).sum(axis=1)))
    y = (rng.random(num_datapoints) <= ps).astype(np.float32)
    return X.astype(np.float32), y


def make_moons(n_samples: int = 100, noise: float = 0.0, random_state: int = 0):
    """Two interleaving half-circles, as ``sklearn.datasets.make_moons``
    (shuffle=True) draws them from ``np.random.RandomState(random_state)``."""
    gen = np.random.RandomState(random_state)
    n_out = n_samples // 2
    n_in = n_samples - n_out
    outer_x = np.cos(np.linspace(0, np.pi, n_out))
    outer_y = np.sin(np.linspace(0, np.pi, n_out))
    inner_x = 1 - np.cos(np.linspace(0, np.pi, n_in))
    inner_y = 1 - np.sin(np.linspace(0, np.pi, n_in)) - 0.5
    X = np.vstack(
        [np.append(outer_x, inner_x), np.append(outer_y, inner_y)]
    ).T
    y = np.hstack([np.zeros(n_out, dtype=np.intp), np.ones(n_in, dtype=np.intp)])
    idx = np.arange(n_samples)
    gen.shuffle(idx)
    X, y = X[idx], y[idx]
    X += gen.normal(scale=noise, size=X.shape)
    return X, y


def make_halfmoon(n_samples: int = 1000, noise: float = 0.1, random_state: int = 42):
    X, Y = make_moons(n_samples=n_samples, noise=noise, random_state=random_state)
    return X.astype(np.float32), Y.astype(np.float32)


def make_sinus(n: int = 1000, rng=None):
    """x ~ U(0, 2π), y = sin x, as (n, 1) float32 columns."""
    rng = rng or np.random.default_rng(111)
    X = rng.random(n) * 2 * np.pi
    Y = np.sin(X)
    return X[:, None].astype(np.float32), Y[:, None].astype(np.float32)


def make_synth_images(n_per_class: int = 600, n_test_per_class: int = 100, nc: int = 10,
                      side: int = 28, channels: int = 1, rng=None):
    """Class-structured images: each class is a fixed random low-frequency
    template (side/4 squared, upsampled 4×) plus N(0, 0.6²) pixel noise.
    Returns ``(x (n, C, side, side), y, xt, yt)``, shuffled per split."""
    rng = rng or np.random.default_rng(7)
    f = side // 4
    templates = rng.standard_normal((nc, channels, f, f)).astype(np.float32)
    templates = templates.repeat(4, axis=2).repeat(4, axis=3)

    def gen(n_pc):
        xs, ys = [], []
        for c in range(nc):
            noise = 0.6 * rng.standard_normal((n_pc, channels, side, side)).astype(np.float32)
            xs.append(templates[c][None] + noise)
            ys.append(np.full(n_pc, c, dtype=np.float32))
        X, Y = np.concatenate(xs), np.concatenate(ys)
        perm = rng.permutation(len(X))
        return X[perm], Y[perm]

    xtr, ytr = gen(n_per_class)
    xte, yte = gen(n_test_per_class)
    return xtr, ytr, xte, yte
