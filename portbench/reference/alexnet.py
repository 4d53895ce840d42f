"""Plain AlexNet for 32×32 inputs over sampled weights (the reference code's
``neural_net.py::make_alexnet``, arXiv:2211.02377): conv 3→64 5×5 padded
2, 3×3 max-pool stride 2 padded 1, ReLU, LRN(4); conv 64→64 5×5 padded 2,
ReLU, LRN(4), the same max-pool; flatten (C, H, W); fc 4096→384, ReLU,
384→192, ReLU, 192→nc. Every layer is mean-field Gaussian; only the dense
layers carry KL and log-density terms (the reference's ELBOs skip the conv
layers'). A convolution is written as its sums: the input's k×k patches
(``F.unfold``) times each sample's weights in one batched matrix product,
so every product of the net goes through ``torch.matmul``, and the
benchmark's control (this reference in float32 with TF32 on) runs all of
them in TF32.

Two departures from the published layer list, each exact:

- the first pool runs before its ReLU (the reference has ReLU, then
  pool). Max and ReLU commute, and every 3/2 window with padding 1 holds
  at least one real element, so the padding's −∞ never wins;
- the LRN's window at even n: the sum of squares runs over channels c − lo
  … c + hi with lo = (n − 1)//2 = 1 and hi = n − 1 − lo = 2, the window of
  the layer this benchmark measures and of the JAX package it was ported
  from. ``torch.nn.LocalResponseNorm`` puts the longer side below (lo =
  n//2 = 2), which at n = 4 is another function.

Memory. The float64 step at the benchmark's sizes (S = 10, T = 20, M =
100) does not fit one card if autograd keeps every inner iteration's
activations for the reverse. So the forward is an ``autograd.Function``
that keeps only its inputs (the input images and the sampled weights) and
recomputes the layers in its backward; that backward is itself an
``autograd.Function`` (the vector-Jacobian product) that keeps only its
inputs and, when the outer gradient reaches it, recomputes the layers and
their reverse once more and differentiates that. The unroll then holds,
per inner iteration, the sampled weights and the Adam states, not the
activations. The values and derivatives of every order used are those of
the plain layers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import Model

LRN = dict(size=4, alpha=0.001 / 9.0, beta=0.75, k=1.0)


def _conv(x, w, b, pad: int):
    """Stride-1 convolution of each sample's input with its own weights:
    x (S, N, C, H, W) or (N, C, H, W), w (S, K, C, k, k), b (S, K) →
    (S, N, K, OH, OW)."""
    S, K, C, k, _ = w.shape
    if x.dim() == 4:
        x = x.unsqueeze(0).expand(S, *x.shape)
    N, H, W = x.shape[1], x.shape[3], x.shape[4]
    patches = F.unfold(x.reshape(S * N, C, H, W), k, padding=pad).reshape(S, N, C * k * k, -1)
    y = torch.matmul(w.reshape(S, 1, K, C * k * k), patches)
    return y.reshape(S, N, K, H + 2 * pad - k + 1, -1) + b[:, None, :, None, None]


def _pool(y):
    """3×3 max-pool, stride 2, padding 1, over (H, W)."""
    S, N = y.shape[:2]
    p = F.max_pool2d(y.reshape(S * N, *y.shape[2:]), 3, 2, padding=1)
    return p.reshape(S, N, *p.shape[1:])


def _lrn(y, size: int, alpha: float, beta: float, k: float):
    """y / (k + α·mean of y² over the window c − lo … c + hi)^β."""
    lo = (size - 1) // 2
    S, N, C, H, W = y.shape
    sq = F.pad(torch.square(y).reshape(S * N, 1, C, H, W), (0, 0, 0, 0, lo, size - 1 - lo))
    mean = F.avg_pool3d(sq, (size, 1, 1), stride=1).reshape(S, N, C, H, W)
    return y / torch.pow(k + alpha * mean, beta)


def layers(thetas, x):
    """The logits (S, N, nc) of the plain layers."""
    (w1, b1), (w2, b2), (w3, b3), (w4, b4), (w5, b5) = thetas
    h = _lrn(torch.relu(_pool(_conv(x, w1, b1, pad=2))), **LRN)
    h = _pool(_lrn(torch.relu(_conv(h, w2, b2, pad=2)), **LRN))
    h = h.reshape(*h.shape[:2], -1)
    h = torch.relu(torch.matmul(h, w3.transpose(1, 2)) + b3[:, None, :])
    h = torch.relu(torch.matmul(h, w4.transpose(1, 2)) + b4[:, None, :])
    return torch.matmul(h, w5.transpose(1, 2)) + b5[:, None, :]


def _pairs(flat):
    return [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]


def _vjp(gy, x, flat, create_graph: bool):
    """The layers' vector-Jacobian product at (x, θ) against the logits'
    cotangent ``gy``: the cotangents of x and of each weight and bias, the
    layers recomputed here."""
    with torch.enable_grad():
        xs = x if x.requires_grad else x.detach().requires_grad_(True)
        ps = [t if t.requires_grad else t.detach().requires_grad_(True) for t in flat]
        y = layers(_pairs(ps), xs)
        return torch.autograd.grad(y, [xs, *ps], gy, create_graph=create_graph)


class _Vjp(torch.autograd.Function):
    """``_vjp`` as a function of (gy, x, θ) that keeps only its inputs; its
    own derivative recomputes the layers and their reverse."""

    @staticmethod
    def forward(ctx, gy, x, *flat):
        ctx.save_for_backward(gy, x, *flat)
        return _vjp(gy.detach(), x.detach(), [t.detach() for t in flat], create_graph=False)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gg):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            outs = _vjp(ins[0], ins[1], ins[2:], create_graph=True)
            return torch.autograd.grad(outs, ins, gg, allow_unused=True)


class _Forward(torch.autograd.Function):
    """The logits of ``layers``, keeping only (x, θ); the backward is
    ``_Vjp``, so that it can be differentiated again."""

    @staticmethod
    def forward(ctx, x, *flat):
        ctx.save_for_backward(x, *flat)
        return layers(_pairs(flat), x)

    @staticmethod
    def backward(ctx, gy):
        x, *flat = ctx.saved_tensors
        return _Vjp.apply(gy, x, *flat)


def forward(thetas, x):
    return _Forward.apply(x, *[t for pair in thetas for t in pair])


MODEL = Model(forward=forward, kl_layers=(2, 3, 4))


def make_model(config) -> Model:
    return MODEL
