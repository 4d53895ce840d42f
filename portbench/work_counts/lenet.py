"""Operations and bytes of the LeNet nested step, counted from the
configuration's shapes (a configuration names this counter by
``"work": "lenet"``).

``lenet_work`` is a frozen copy of ``chip_smoke.py::lenet_work`` (the
bounds of the kernel table in PERF.md), kept here so that a later change
to the program cannot move the yardstick. ``LeNetShape`` carries the sizes
it reads, taken from the configuration's ``net`` and ``data``:
conv 1→K1 k×k 'same'-padded, 2×2 max-pool, conv K1→K2 k×k unpadded, 2×2
max-pool, then the dense widths. ``lenet_outer_ops`` counts the step's
outer IW-ELBO, which runs outside the kernel pair. Multiply-adds count 2.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

# the kernels of the pair (``psvi_torch/ops/csrc/fused_lenet.cu``), by name
KERNELS = ("k_adam", "k_adam_vjp", "k_bias", "k_conv1", "k_conv1_wpart", "k_conv2",
           "k_conv2_back", "k_conv2_wpart", "k_core_weights", "k_cw_vjp", "k_cwbar", "k_gemm",
           "k_head", "k_hvp", "k_loss", "k_reduce_m", "k_sample", "k_ubar_part", "k_ubar_sum")


@dataclasses.dataclass(frozen=True)
class LeNetShape:
    """The sizes of the LeNet inner unroll that ``lenet_work`` reads."""

    T: int
    S: int
    M: int
    nc: int
    K1: int = 6
    K2: int = 16
    k: int = 5
    H: int = 28
    fc_hidden: Tuple[int, ...] = (400, 120, 84)

    @property
    def fc(self):
        return self.fc_hidden + (self.nc,)

    @property
    def q(self):
        return self.k * self.k

    @property
    def P1(self):
        return self.H // 2

    @property
    def H2(self):
        return self.P1 - self.k + 1

    def layer_shapes(self):
        f, k = self.fc, self.k
        return [((self.K1, 1, k, k), self.K1), ((self.K2, self.K1, k, k), self.K2),
                ((f[1], f[0]), f[1]), ((f[2], f[1]), f[2]), ((f[3], f[2]), f[3])]

    @property
    def n_theta(self):
        return sum(math.prod(w) + o for w, o in self.layer_shapes())

    @property
    def n_params(self):
        return 2 * self.n_theta

    @property
    def n_eps(self):
        return self.S * self.n_theta


def shape(cell) -> LeNetShape:
    """The step's sizes at a cell, from its configuration; a net of
    another topology raises."""
    e, net, data = cell.config["engine"], cell.config["net"], cell.config["data"]
    conv, fc = net.get("conv"), net.get("fc")
    if not conv or len(conv) != 2 or not fc or len(fc) != 4:
        raise ValueError("the lenet work counter covers two convs and three dense layers")
    (c0, K1, k, pad1), (c1, K2, k2, pad2) = conv
    H = data["side"]
    P2 = (H // 2 - k + 1) // 2
    if (c0, data["channels"], c1, k2, pad1, pad2) != (1, 1, K1, k, (k - 1) // 2, 0) \
            or fc[0] != K2 * P2 * P2:
        raise ValueError(f"the lenet work counter does not cover the net {net}")
    return LeNetShape(T=e["inner_it"], S=e["mc_samples"], M=cell.mix["num_pseudo"], nc=fc[-1],
                      K1=K1, K2=K2, k=k, H=H, fc_hidden=tuple(fc[:3]))


def lenet_work(cfg):
    """Operations (multiply-adds count 2) and bytes of lenet_fwd and
    lenet_rev at this config. The pool keeps one of four conv outputs, so
    every pass after the pooled forward (the backprop, the weight gradients,
    the tangent pass at the stored winners, ū) counts the winners only; the
    forward computes all four parities for the max."""
    S, M, T, K1, K2, q, nc = cfg.S, cfg.M, cfg.T, cfg.K1, cfg.K2, cfg.q, cfg.nc
    F0, F1, F2 = cfg.fc[:3]
    SM = S * M
    conv1 = 2 * SM * K1 * cfg.H * cfg.H * q
    conv2 = 2 * SM * K2 * cfg.H2 * cfg.H2 * K1 * q
    conv1_win, conv2_win = conv1 // 4, conv2 // 4
    fc = 2 * SM * (F0 * F1 + F1 * F2 + F2 * nc)
    head = 8 * SM * nc
    elem = 12 * S * cfg.n_theta  # sampling, the ε-weighted sums, Adam, KL
    # forward; backprop (fc data, conv2 data) and weight gradients
    fwd_iter = conv1 + conv2 + fc + head + (2 * fc + 2 * conv2_win + conv1_win) + elem
    # tangent forward (conv1, both conv2 terms, both fc terms), tangent backprop and
    # weight gradients (two terms each, one for conv1), ū (two terms)
    tangent = (conv1_win + 2 * conv2_win + 2 * fc + head + 2 * fc + 2 * conv2_win
               + 2 * fc + 2 * conv2_win + conv1_win + 2 * conv1_win + elem)
    ops = {"lenet_fwd": T * fwd_iter, "lenet_rev": T * (fwd_iter + tangent)}
    P, E, U = cfg.n_params, cfg.n_eps, M * cfg.H * cfg.H
    f = 4
    byts = {
        "lenet_fwd": f * (P + U + 3 * M + 1 + T * E) + f * (T + (T + 1) * 3 * P + M),
        "lenet_rev": f * ((T + 1) * 3 * P + P + T + U + 3 * M + 1 + T * E)
                     + f * (P + U + M + 1),
    }
    return ops, byts


def lenet_outer_ops(cfg, B: int) -> int:
    """Operations of the LeNet step's outer IW-ELBO and its gradient over
    the M + B points, in ``lenet_work``'s terms: the forward at all four
    pool parities and the head; the backprop and the weight gradients at
    the winners; ū (conv1's input gradient) at the M pseudo points; the
    sampling and the per-sample NKL of the dense layers."""
    S, K1, K2, q, nc = cfg.S, cfg.K1, cfg.K2, cfg.q, cfg.nc
    F0, F1, F2 = cfg.fc[:3]
    SP = S * (cfg.M + B)
    conv1 = 2 * SP * K1 * cfg.H * cfg.H * q
    conv2 = 2 * SP * K2 * cfg.H2 * cfg.H2 * K1 * q
    fc = 2 * SP * (F0 * F1 + F1 * F2 + F2 * nc)
    head = 8 * SP * nc
    forward = conv1 + conv2 + fc + head
    backward = 2 * fc + 2 * (conv2 // 4) + conv1 // 4
    ubar = (2 * S * cfg.M * K1 * cfg.H * cfg.H * q) // 4
    elem = 12 * S * cfg.n_theta
    return forward + backward + ubar + elem


def kernel_work(cell):
    """Operations and bytes of each kernel of the pair at a cell."""
    return lenet_work(shape(cell))


def step_ops(cell) -> int:
    """Operations of one whole step: the pair's unroll and the outer
    IW-ELBO with its gradient, whatever runs them."""
    s = shape(cell)
    ops, _ = lenet_work(s)
    return sum(ops.values()) + lenet_outer_ops(s, cell.config["engine"]["data_minibatch"])
