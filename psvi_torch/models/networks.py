"""Network builders for the dense, LeNet and regression slices.

Counterpart of ``psvi_tpu/models/networks.py``'s ``make_logreg``,
``make_fcnet``, ``make_regressor_net``, ``make_lenet`` and those branches of
``set_up_model``. The other architectures of the JAX model zoo arrive in
later slices (ROADMAP.md, queue A item 8).
"""

from __future__ import annotations

from typing import Optional

from psvi_torch.models.layers import (Flatten, MaxPool2d, ReLU, Sequential, VIConv2d,
                                     VILinear)


def make_logreg(d: int, nc: int, init_sd: float = 1e-3, prior_sd: float = 1.0):
    """Bayesian multinomial logistic regression: one variational dense layer."""
    return Sequential([VILinear(d, nc, init_sd=init_sd, prior_sd=prior_sd)])


def make_fcnet(in_dim: int, h_dim: int, out_dim: int, n_layers: int = 2,
               init_sd: float = 0.01, prior_sd: float = 1.0):
    """Mean-field MLP ("fn"): ``VILinear (ReLU VILinear)*``."""
    layers = []
    for i in range(n_layers):
        layers.append(VILinear(in_dim if i == 0 else h_dim, h_dim,
                               init_sd=init_sd, prior_sd=prior_sd))
        layers.append(ReLU())
    layers.append(VILinear(h_dim, out_dim, init_sd=init_sd, prior_sd=prior_sd))
    return Sequential(layers)


def make_regressor_net(in_dim: int, h_dim: int, out_dim: int = 1, n_layers: int = 2,
                       init_sd: float = 0.01, prior_sd: float = 1.0):
    """The regression MLP: the ``fn`` topology, kept apart as the reference
    keeps it."""
    return make_fcnet(in_dim, h_dim, out_dim, n_layers, init_sd, prior_sd)


def make_dense(widths, init_sd: float = 1e-3, prior_sd: float = 1.0):
    """``VILinear (ReLU VILinear)*`` over ``widths = (D, h, ..., nc)``."""
    layers = []
    for l in range(len(widths) - 1):
        if l:
            layers.append(ReLU())
        layers.append(VILinear(widths[l], widths[l + 1], init_sd=init_sd,
                               prior_sd=prior_sd))
    return Sequential(layers)


def make_lenet(init_sd: float = 0.01, prior_sd: float = 1.0, in_channels: int = 1):
    """LeNet-5: conv 1→6→16 (5×5), pools, fc 400→120→84→10
    (ref ``psvi/models/neural_net.py:334-359``). Pool before ReLU, as the
    JAX package (max and ReLU commute)."""
    kw = dict(init_sd=init_sd, prior_sd=prior_sd)
    return Sequential([
        VIConv2d(in_channels, 6, 5, padding=2, **kw),
        MaxPool2d(2, 2),
        ReLU(),
        VIConv2d(6, 16, 5, padding=0, **kw),
        MaxPool2d(2, 2),
        ReLU(),
        Flatten(),
        VILinear(400, 120, **kw),
        ReLU(),
        VILinear(120, 84, **kw),
        ReLU(),
        # the final classifier takes the default init_sd (ref
        # `linear_class(84, 10)` without **kwargs, neural_net.py:358)
        VILinear(84, 10, prior_sd=prior_sd),
    ])


_LATER = {
    "logistic_regression_fullcov": "A.8",
    "fn2": "A.8",
    "alexnet": "A.8",
    "resnet": "A.8",
}


def set_up_model(architecture: str, D: int, n_hidden: Optional[int], nc: int,
                 init_sd: float, n_layers: int = 1, n_channels: int = 1,
                 prior_sd: float = 1.0):
    """Architecture dispatch (ref ``psvi_classes.py:689-758``)."""
    if architecture == "logistic_regression":
        return make_logreg(D, nc, init_sd=init_sd, prior_sd=prior_sd)
    if architecture in {"fn", "residual_fn"}:
        return make_fcnet(D, n_hidden, nc, n_layers=n_layers, init_sd=init_sd,
                          prior_sd=prior_sd)
    if architecture == "lenet":
        return make_lenet(init_sd=init_sd, prior_sd=prior_sd, in_channels=n_channels)
    if architecture == "regressor_net":
        return make_regressor_net(D, n_hidden, nc, n_layers=n_layers, init_sd=init_sd,
                                  prior_sd=prior_sd)
    if architecture in _LATER:
        raise NotImplementedError(
            f"architecture {architecture!r} is not ported yet "
            f"(ROADMAP.md, queue A item {_LATER[architecture]})"
        )
    raise ValueError(f"unknown architecture: {architecture!r}")
