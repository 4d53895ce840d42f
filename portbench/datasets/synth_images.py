"""Class-structured images at MNIST's shapes, from the seed: each class a
fixed random low-frequency template (side/4 squared, upsampled 4×) plus
N(0, 0.6²) pixel noise, each split shuffled. A frozen copy of
``psvi_torch/data/synthetic.py::make_synth_images`` (``synth_mnist``)."""

from __future__ import annotations

import numpy as np


def make(args: dict, seed: int):
    """``(x (n, C, side, side), y, xt, yt, nc)`` as float32 arrays."""
    rng = np.random.default_rng(seed)
    nc, side, channels = args["nc"], args["side"], args["channels"]
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

    x, y = gen(args["n_per_class"])
    xt, yt = gen(args["n_test_per_class"])
    return x, y, xt, yt, nc
