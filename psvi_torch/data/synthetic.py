"""Synthetic dataset generators (host-side NumPy).

The port's own copies of ``psvi_tpu/data/synthetic.py``'s generators:
four_blobs, ``make_synthetic`` (synth_lr_<D>), ``make_synthetic_normal``
(normal_mvn), ``make_synth_images`` (synth_mnist, synth_cifar),
``make_synth_images_hard`` (synth_mnist_hard) with
``nearest_template_accuracy``, its Bayes ceiling, and ``make_sinus`` (the
sinus regression set); each gives JAX's arrays from the same seed.
``make_halfmoon`` reproduces
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


def make_synthetic_normal(num_datapoints: int = 1000, rng=None):
    """Two correlated Gaussians, one a class (ref experiments_utils.py:679-701)."""
    rng = rng or np.random.default_rng(43)
    cov = 8.0 * np.eye(2)
    cov[0, 1] = cov[1, 0] = 2.5
    p1 = rng.multivariate_normal([-1, 1], cov, num_datapoints)
    p2 = rng.multivariate_normal([1, -1], cov, num_datapoints)
    X = np.vstack([p1, p2]).astype(np.float32)
    y = np.concatenate([np.zeros(num_datapoints), np.ones(num_datapoints)]).astype(np.float32)
    perm = rng.permutation(len(X))
    return X[perm], y[perm]


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


def make_synth_images_hard(n_per_class: int = 600, n_test_per_class: int = 100, nc: int = 10,
                           side: int = 28, channels: int = 1, sep: float = 0.55,
                           noise_sd: float = 1.0, max_shift: int = 2, label_noise: float = 0.08,
                           rng=None):
    """MNIST-shaped images with a controlled Bayes ceiling: each class
    template is a shared low-frequency base plus ``sep`` times a class's own
    component (7×7 upsampled 4×); a sample is its template rolled by up to
    ``max_shift`` pixels each way plus N(0, ``noise_sd``²) pixel noise; then
    each label, train and test, becomes a uniform other class with
    probability ``label_noise``. Returns (x_train, y_train, x_test, y_test,
    templates)."""
    rng = rng or np.random.default_rng(7)
    f = side // 4
    base = rng.standard_normal((1, channels, f, f)).astype(np.float32)
    uniq = rng.standard_normal((nc, channels, f, f)).astype(np.float32)
    templates = (base + sep * uniq).repeat(4, axis=2).repeat(4, axis=3)

    def gen(n_pc):
        xs, ys = [], []
        for c in range(nc):
            dys = rng.integers(-max_shift, max_shift + 1, n_pc)
            dxs = rng.integers(-max_shift, max_shift + 1, n_pc)
            shifted = np.stack([np.roll(templates[c], (dy, dx), axis=(1, 2))
                                for dy, dx in zip(dys, dxs)])
            noise = noise_sd * rng.standard_normal(
                (n_pc, channels, side, side)).astype(np.float32)
            xs.append(shifted + noise)
            ys.append(np.full(n_pc, c, dtype=np.float32))
        X, Y = np.concatenate(xs), np.concatenate(ys)
        flip = rng.random(len(Y)) < label_noise
        offsets = rng.integers(1, nc, len(Y))
        Y = np.where(flip, (Y + offsets) % nc, Y).astype(np.float32)
        perm = rng.permutation(len(X))
        return X[perm], Y[perm]

    xtr, ytr = gen(n_per_class)
    xte, yte = gen(n_test_per_class)
    return xtr, ytr, xte, yte, templates


def nearest_template_accuracy(x, y, templates, max_shift: int = 2, batch: int = 512):
    """The Bayes rule's accuracy on :func:`make_synth_images_hard` data: the
    nearest template over every generative shift."""
    nc = templates.shape[0]
    shifts = [(dy, dx) for dy in range(-max_shift, max_shift + 1)
              for dx in range(-max_shift, max_shift + 1)]
    cand = np.stack([np.roll(templates, (dy, dx), axis=(2, 3)) for dy, dx in shifts])
    cand = cand.reshape(len(shifts) * nc, -1)
    labels = np.tile(np.arange(nc), len(shifts))
    X = x.reshape(len(x), -1)
    correct = 0
    for i in range(0, len(X), batch):
        xb = X[i:i + batch]
        d = ((xb[:, None, :] - cand[None, :, :]) ** 2).sum(-1)
        correct += int((labels[np.argmin(d, axis=1)] == y[i:i + batch]).sum())
    return correct / len(X)
