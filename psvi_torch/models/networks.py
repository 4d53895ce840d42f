"""Network builders of the variational model zoo.

Counterpart of ``psvi_tpu/models/networks.py``: ``make_logreg``,
``make_logreg_fullcov``, ``make_fcnet``, ``make_regressor_net``,
``make_fc2net``, ``make_lenet``, ``make_alexnet``, ``make_resnet`` (with
``_conv3x3``, ``_basic_block`` and ``_bottleneck_block``, ResNet-18 to -152
for 32×32 inputs) and the architecture dispatch ``set_up_model``.
"""

from __future__ import annotations

from typing import Optional

from psvi_torch.models.layers import (AvgPool2d, BatchNorm2d, Flatten, LocalResponseNorm,
                                     MaxPool2d, ReLU, Residual, Sequential, VIConv2d,
                                     VILinear, VILinearFullCov)


def make_logreg(d: int, nc: int, init_sd: float = 1e-3, prior_sd: float = 1.0):
    """Bayesian multinomial logistic regression: one variational dense layer."""
    return Sequential([VILinear(d, nc, init_sd=init_sd, prior_sd=prior_sd)])


def make_logreg_fullcov(d: int, nc: int, init_sd: float = 1e-3, prior_sd: float = 1.0):
    """Logistic regression with one full-covariance variational layer."""
    return Sequential([VILinearFullCov(d, nc, init_sd=init_sd, prior_sd=prior_sd)])


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


def make_fc2net(in_dim: int, h_dim: int, out_dim: int, n_layers: int = 2,
                init_sd: float = 0.01, prior_sd: float = 1.0):
    """Full-covariance MLP ("fn2", ref ``neural_net.py:494-524``): the ``fn``
    topology with every dense layer a ``VILinearFullCov``."""
    layers = []
    for i in range(n_layers):
        layers.append(VILinearFullCov(in_dim if i == 0 else h_dim, h_dim, init_sd=init_sd,
                                      prior_sd=prior_sd))
        layers.append(ReLU())
    layers.append(VILinearFullCov(h_dim, out_dim, init_sd=init_sd, prior_sd=prior_sd))
    return Sequential(layers)


def make_alexnet(init_sd: float = 0.01, prior_sd: float = 1.0, in_channels: int = 3):
    """AlexNet-style CNN for 32×32 inputs (ref ``neural_net.py:362-397``):
    conv 5×5 →64, pool 3/2, LRN, conv 5×5 64→64, LRN, pool 3/2, fc
    4096→384→192→10. As in JAX, the two convs take the default ``init_sd``
    and ``prior_sd``; only the dense layers take the caller's, and the last
    of them the default ``init_sd``. Pool before ReLU in the first pair,
    as JAX has it (max and ReLU commute; every 3/2 window with padding 1
    holds real elements)."""
    kw = dict(init_sd=init_sd, prior_sd=prior_sd)
    lrn = dict(alpha=0.001 / 9.0, beta=0.75, k=1.0)
    return Sequential([
        VIConv2d(in_channels, 64, 5, stride=1, padding=2),
        MaxPool2d(3, 2, padding=1),
        ReLU(),
        LocalResponseNorm(4, **lrn),
        VIConv2d(64, 64, 5, padding=2, stride=1),
        ReLU(),
        LocalResponseNorm(4, **lrn),
        MaxPool2d(3, 2, padding=1),
        Flatten(),
        VILinear(4096, 384, **kw),
        ReLU(),
        VILinear(384, 192, **kw),
        ReLU(),
        VILinear(192, 10, prior_sd=prior_sd),
    ])


def _conv3x3(cin, cout, stride=1, init_sd=0.1, prior_sd=1.0):
    return VIConv2d(cin, cout, 3, stride=stride, padding=1, use_bias=False, init_sd=init_sd,
                    prior_sd=prior_sd)


def _shortcut(in_planes, out_planes, stride, init_sd, prior_sd):
    """The projection shortcut (1×1 conv and BatchNorm) where the block
    changes the stride or the width, else the identity (an empty stack)."""
    if stride == 1 and in_planes == out_planes:
        return Sequential([])
    return Sequential([
        VIConv2d(in_planes, out_planes, 1, stride=stride, use_bias=False, init_sd=init_sd,
                 prior_sd=prior_sd),
        BatchNorm2d(out_planes),
    ])


def _basic_block(in_planes, planes, stride=1, init_sd=0.1, prior_sd=1.0):
    """ResNet BasicBlock (ref ``neural_net.py:532-555``); returns the block
    and its output width."""
    body = Sequential([
        _conv3x3(in_planes, planes, stride, init_sd, prior_sd),
        BatchNorm2d(planes),
        ReLU(),
        _conv3x3(planes, planes, 1, init_sd, prior_sd),
        BatchNorm2d(planes),
    ])
    return Residual(body, _shortcut(in_planes, planes, stride, init_sd, prior_sd)), planes


def _bottleneck_block(in_planes, planes, stride=1, init_sd=0.1, prior_sd=1.0):
    """ResNet Bottleneck (ref ``neural_net.py:558-584``), expansion 4;
    returns the block and its output width."""
    kw = dict(use_bias=False, init_sd=init_sd, prior_sd=prior_sd)
    body = Sequential([
        VIConv2d(in_planes, planes, 1, **kw),
        BatchNorm2d(planes),
        ReLU(),
        VIConv2d(planes, planes, 3, stride=stride, padding=1, **kw),
        BatchNorm2d(planes),
        ReLU(),
        VIConv2d(planes, 4 * planes, 1, **kw),
        BatchNorm2d(4 * planes),
    ])
    return (Residual(body, _shortcut(in_planes, 4 * planes, stride, init_sd, prior_sd)),
            4 * planes)


_RESNET_ARCHS = {
    "resnet18": ("basic", [2, 2, 2, 2]),
    "resnet34": ("basic", [3, 4, 6, 3]),
    "resnet50": ("bottleneck", [3, 4, 6, 3]),
    "resnet101": ("bottleneck", [3, 4, 23, 3]),
    "resnet152": ("bottleneck", [3, 8, 36, 3]),
}


def make_resnet(arch: str = "resnet18", channel: int = 3, num_classes: int = 10,
                init_sd: float = 0.1, prior_sd: float = 1.0):
    """All-variational ResNet for 32×32 inputs (ref ``neural_net.py:587-659``):
    a 3×3 conv stem, four stages of blocks at widths 64-128-256-512 (stride
    2 from the second), a 4×4 average pool and one ``VILinear`` head."""
    kind, num_blocks = _RESNET_ARCHS[arch.lower()]
    block_fn = _basic_block if kind == "basic" else _bottleneck_block
    expansion = 1 if kind == "basic" else 4
    layers = [_conv3x3(channel, 64, 1, init_sd, prior_sd), BatchNorm2d(64), ReLU()]
    in_planes = 64
    for planes, nb, stride0 in zip([64, 128, 256, 512], num_blocks, [1, 2, 2, 2]):
        for s in [stride0] + [1] * (nb - 1):
            blk, in_planes = block_fn(in_planes, planes, s, init_sd, prior_sd)
            layers.append(blk)
    layers += [AvgPool2d(4), Flatten(),
               VILinear(512 * expansion, num_classes, init_sd=init_sd, prior_sd=prior_sd)]
    return Sequential(layers)


def set_up_model(architecture: str, D: int, n_hidden: Optional[int], nc: int,
                 init_sd: float, n_layers: int = 1, n_channels: int = 1,
                 prior_sd: float = 1.0):
    """Architecture dispatch (ref ``psvi_classes.py:689-758``)."""
    if architecture == "logistic_regression":
        return make_logreg(D, nc, init_sd=init_sd, prior_sd=prior_sd)
    if architecture == "logistic_regression_fullcov":
        return make_logreg_fullcov(D, nc, init_sd=init_sd, prior_sd=prior_sd)
    if architecture in {"fn", "residual_fn"}:
        return make_fcnet(D, n_hidden, nc, n_layers=n_layers, init_sd=init_sd,
                          prior_sd=prior_sd)
    if architecture == "fn2":
        return make_fc2net(D, n_hidden, nc, n_layers=n_layers, init_sd=init_sd,
                           prior_sd=prior_sd)
    if architecture == "lenet":
        return make_lenet(init_sd=init_sd, prior_sd=prior_sd, in_channels=n_channels)
    if architecture == "alexnet":
        return make_alexnet(init_sd=init_sd, prior_sd=prior_sd, in_channels=n_channels)
    if architecture == "regressor_net":
        return make_regressor_net(D, n_hidden, nc, n_layers=n_layers, init_sd=init_sd,
                                  prior_sd=prior_sd)
    if architecture == "resnet":
        return make_resnet("resnet18", channel=n_channels or 3, num_classes=nc,
                           init_sd=init_sd, prior_sd=prior_sd)
    raise ValueError(f"unknown architecture: {architecture!r}")
