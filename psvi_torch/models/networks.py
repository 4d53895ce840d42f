"""Network builders for the dense slice.

Counterpart of ``psvi_tpu/models/networks.py``'s ``make_logreg``,
``make_fcnet`` and the dense branches of ``set_up_model``. The other
architectures of the JAX model zoo arrive in later slices (ROADMAP.md,
queue A items 6 and 8).
"""

from __future__ import annotations

from typing import Optional

from psvi_torch.models.layers import ReLU, Sequential, VILinear


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


def make_dense(widths, init_sd: float = 1e-3, prior_sd: float = 1.0):
    """``VILinear (ReLU VILinear)*`` over ``widths = (D, h, ..., nc)``."""
    layers = []
    for l in range(len(widths) - 1):
        if l:
            layers.append(ReLU())
        layers.append(VILinear(widths[l], widths[l + 1], init_sd=init_sd,
                               prior_sd=prior_sd))
    return Sequential(layers)


_LATER = {
    "logistic_regression_fullcov": "A.8",
    "fn2": "A.8",
    "lenet": "A.6",
    "alexnet": "A.8",
    "regressor_net": "A.7",
    "resnet": "A.8",
}


def set_up_model(architecture: str, D: int, n_hidden: Optional[int], nc: int,
                 init_sd: float, n_layers: int = 1, prior_sd: float = 1.0):
    """Architecture dispatch for the dense family (ref ``psvi_classes.py:689-758``)."""
    if architecture == "logistic_regression":
        return make_logreg(D, nc, init_sd=init_sd, prior_sd=prior_sd)
    if architecture in {"fn", "residual_fn"}:
        return make_fcnet(D, n_hidden, nc, n_layers=n_layers, init_sd=init_sd,
                          prior_sd=prior_sd)
    if architecture in _LATER:
        raise NotImplementedError(
            f"architecture {architecture!r} is not ported yet "
            f"(ROADMAP.md, queue A item {_LATER[architecture]})"
        )
    raise ValueError(f"unknown architecture: {architecture!r}")
