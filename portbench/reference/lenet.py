"""Plain LeNet-5 over sampled weights (the reference's ``neural_net.py``
LeNet): conv 1→6 5×5 padded 2, 2×2 max-pool, ReLU; conv 6→16 5×5, 2×2
max-pool, ReLU; flatten (C, H, W); fc 400→120, ReLU, 120→84, ReLU, 84→nc.
Every layer is mean-field Gaussian; only the dense layers carry KL and
log-density terms (the reference's ELBOs skip the conv layers'). One
grouped convolution runs the S samples' weights together."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import Model


def _conv(x, w, b, pad: int):
    """x (S, N, C, H, W) or (N, C, H, W), w (S, K, C, k, k), b (S, K) →
    (S, N, K, OH, OW)."""
    S, K, C, k, _ = w.shape
    if x.dim() == 4:
        x = x.unsqueeze(0).expand(S, *x.shape)
    N, H, W = x.shape[1], x.shape[3], x.shape[4]
    y = F.conv2d(x.transpose(0, 1).reshape(N, S * C, H, W), w.reshape(S * K, C, k, k),
                 padding=pad, groups=S)
    y = y.reshape(N, S, K, *y.shape[-2:]).transpose(0, 1)
    return y + b[:, None, :, None, None]


def _pool_relu(y):
    S, N = y.shape[:2]
    p = F.max_pool2d(y.reshape(S * N, *y.shape[2:]), 2, 2)
    return torch.relu(p.reshape(S, N, *p.shape[1:]))


def forward(thetas, x):
    (w1, b1), (w2, b2), (w3, b3), (w4, b4), (w5, b5) = thetas
    h = _pool_relu(_conv(x, w1, b1, pad=2))
    h = _pool_relu(_conv(h, w2, b2, pad=0))
    h = h.reshape(*h.shape[:2], -1)
    h = torch.relu(torch.matmul(h, w3.transpose(1, 2)) + b3[:, None, :])
    h = torch.relu(torch.matmul(h, w4.transpose(1, 2)) + b4[:, None, :])
    return torch.matmul(h, w5.transpose(1, 2)) + b5[:, None, :]


MODEL = Model(forward=forward, kl_layers=(2, 3, 4))


def make_model(config) -> Model:
    return MODEL
