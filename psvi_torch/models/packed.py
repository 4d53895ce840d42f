"""Packed flat-parameter representation of mean-field variational nets.

Counterpart of ``psvi_tpu/models/packed.py``. ``PackedMeanField`` holds
every mean-field parameter of a ``Sequential`` as two flat vectors
``{'mu': (P,), 'rho': (P,)}`` and draws one ``(S, P)`` noise matrix, so

- the reparameterized sample θ = μ + softplus(ρ)·ε is one elementwise op,
- the analytic KL and the per-sample NKL are one masked sum each (the
  reference's dense-only KL counting becomes a constant (P,) 0/1 mask from
  each layer's ``count_kl``),
- the inner optimizer steps a two-leaf tree,
- each layer's weights are slices and reshapes of θ, fed to its
  ``apply_theta``.

Numerics: the same formulas elementwise; the KL and NKL sums run over P in
one reduction instead of per layer, and the one (S, P) draw is another
stream than the per-layer draws. ``init`` calls the wrapped net's ``init``
on the same generator and then ravels, so the initial parameters are
bitwise the unpacked net's.

Packable stacks: every parameterized layer a mean-field ``VILinear`` or
``VIConv2d`` (logistic regression, fn, LeNet); ``pack_net`` returns None
otherwise. The fused kernels' gates refuse a packed net (it is not a
``Sequential``), as JAX's do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from psvi_torch.models.layers import (Sequential, VIConv2d, VILinear, _gaussian_kl,
                                      _normal_logpdf, softplus)


@dataclasses.dataclass(frozen=True)
class _Segment:
    layer_idx: int
    key: str  # 'w' | 'b'
    offset: int
    size: int
    shape: Tuple[int, ...]
    prior_sd: float
    count_kl: bool


def _mean_field_segments(net: Sequential) -> Optional[Tuple[_Segment, ...]]:
    """The flat layout, or None if the stack is not packable."""
    segs, offset = [], 0
    for i, layer in enumerate(net.layers):
        if isinstance(layer, (VILinear, VIConv2d)):
            if isinstance(layer, VILinear):
                shapes = [("w", (layer.out_dim, layer.in_dim))]
                if layer.use_bias:
                    shapes.append(("b", (layer.out_dim,)))
            else:
                k = layer.kernel_size
                shapes = [("w", (layer.out_channels, layer.in_channels, k, k))]
                if layer.use_bias:
                    shapes.append(("b", (layer.out_channels,)))
            for key, shp in shapes:
                size = 1
                for d in shp:
                    size *= d
                segs.append(_Segment(i, key, offset, size, shp, layer.prior_sd, layer.count_kl))
                offset += size
        elif layer.is_variational:
            return None  # another variational family
        elif layer.init(torch.Generator()):
            return None  # a parameterized layer that is not variational
    return tuple(segs) if segs else None


class PackedMeanField(nn.Module):
    """Drop-in for ``Sequential`` over flat parameters: params
    ``{'mu': (P,), 'rho': (P,)}``, eps ``(S, P)``."""

    def __init__(self, base: Sequential, segments: Tuple[_Segment, ...]):
        super().__init__()
        self.base = base
        self.segments = segments
        P = self.num_params
        mask, prior = torch.zeros(P), torch.ones(P)
        for s in segments:
            prior[s.offset:s.offset + s.size] = s.prior_sd
            if s.count_kl:
                mask[s.offset:s.offset + s.size] = 1.0
        self.register_buffer("kl_mask", mask)
        self.register_buffer("prior_sd", prior)

    @property
    def num_params(self) -> int:
        last = self.segments[-1]
        return last.offset + last.size

    @property
    def layers(self):
        return self.base.layers

    @property
    def variational_layers(self):
        return self.base.variational_layers

    def prep_input(self, x):
        """:meth:`Sequential.prep_input`; ``apply`` takes the resulting
        ``PrePatched`` through the first layer's ``apply_theta``."""
        return self.base.prep_input(x)

    def init(self, generator):
        """Bitwise the initial values of ``Sequential.init`` on the same
        generator, ravelled."""
        tree = self.base.init(generator)
        mu = [tree[s.layer_idx]["mu_" + s.key].reshape(-1) for s in self.segments]
        rho = [tree[s.layer_idx]["rho_" + s.key].reshape(-1) for s in self.segments]
        return {"mu": torch.cat(mu), "rho": torch.cat(rho)}

    def sample_eps(self, generator, mc_samples: int):
        return torch.randn((mc_samples, self.num_params), generator=generator,
                           device=generator.device)

    def apply(self, params, eps, x, mc_samples: Optional[int] = None):
        theta = params["mu"] + softplus(params["rho"]) * eps  # (S, P)
        S = theta.shape[0]
        by_layer = {}
        for s in self.segments:
            w = theta[:, s.offset:s.offset + s.size].reshape((S,) + s.shape)
            by_layer.setdefault(s.layer_idx, {})[s.key] = w
        in_ndim = x.dim()
        for i, layer in enumerate(self.base.layers):
            if i in by_layer:
                x = layer.apply_theta(by_layer[i]["w"], by_layer[i].get("b"), x)
            else:
                x = layer.apply({}, {}, x)
        if x.is_floating_point() and x.element_size() < 4:
            x = x.float()
        if x.dim() == in_ndim and not any(l.is_variational for l in self.base.layers):
            x = x.unsqueeze(0).expand((S,) + tuple(x.shape))
        return x

    def kl(self, params):
        """Analytic KL over the KL-counted segments, one masked sum."""
        sd = softplus(params["rho"])
        return torch.sum(self.kl_mask * _gaussian_kl(params["mu"], sd, self.prior_sd))

    def nkl(self, params, eps):
        """Per-sample log p(θ) − log q(θ) over the KL-counted segments, (S,)."""
        sd = softplus(params["rho"])
        theta = params["mu"] + sd * eps
        lp = _normal_logpdf(theta, 0.0, self.prior_sd)
        lq = _normal_logpdf(theta, params["mu"], sd)
        return torch.sum(self.kl_mask * (lp - lq), dim=-1)

    def unpack(self, params):
        """The per-layer parameter tuple (``Sequential``'s layout)."""
        out = [dict() for _ in self.base.layers]
        for s in self.segments:
            for name in ("mu", "rho"):
                out[s.layer_idx][f"{name}_{s.key}"] = (
                    params[name][s.offset:s.offset + s.size].reshape(s.shape))
        return tuple(out)

    def unpack_eps(self, eps):
        """The per-layer noise tuple of the flat (S, P) draw."""
        S = eps.shape[0]
        out = [dict() for _ in self.base.layers]
        for s in self.segments:
            out[s.layer_idx][s.key] = eps[:, s.offset:s.offset + s.size].reshape(
                (S,) + s.shape)
        return tuple(out)

    def pack_eps(self, eps_tree):
        """The flat (S, P) noise of a per-layer ``Sequential`` noise tree."""
        parts = [eps_tree[s.layer_idx][s.key] for s in self.segments]
        S = parts[0].shape[0]
        return torch.cat([p.reshape(S, -1) for p in parts], dim=1)


def pack_net(net) -> Optional[PackedMeanField]:
    """Pack a ``Sequential`` of mean-field layers, or None if unsupported."""
    if not isinstance(net, Sequential):
        return None
    segs = _mean_field_segments(net)
    return None if segs is None else PackedMeanField(net, segs)
