"""Mean-field variational dense layers.

Counterpart of the dense part of ``psvi_tpu/models/layers.py``. Each layer
is an ``nn.Module`` that holds its configuration; the computation is
functional so that ``torch.autograd`` can differentiate through the inner
unroll:

- ``init(generator)`` returns the parameter dict ``{'mu_w','rho_w','mu_b',
  'rho_b'}`` (sd stored pre-softplus) on the generator's device;
- ``sample_eps(generator, S)`` draws the standard-normal noise dict with a
  leading MC-sample axis ``S``;
- ``apply(params, eps, x)`` runs the reparameterized forward for all S
  samples, θ = μ + softplus(ρ)·ε;
- ``nkl(params, eps)`` is the per-sample log p(θ) − log q(θ) from the same
  ε as the forward; ``kl(params)`` the analytic KL(q‖p).

Activations carry a leading sample axis ``(S, N, ...)``; the first
variational layer accepts an unbatched ``(N, ...)`` input and adds it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def inverse_softplus(x):
    """Stable inverse of softplus: y such that softplus(y) = x."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return x + torch.log(-torch.expm1(-x))


def softplus(x):
    """log(1 + eˣ) as ``jax.nn.softplus`` computes it (no threshold)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _normal_logpdf(x, mu, sd):
    return -0.5 * torch.square((x - mu) / sd) - torch.log(sd) - _HALF_LOG_2PI


def _gaussian_kl(mu_q, sd_q, sd_p: float):
    """KL( N(mu_q, sd_q) || N(0, sd_p) ), elementwise."""
    return (
        torch.log(sd_p / sd_q)
        + (torch.square(sd_q) + torch.square(mu_q)) / (2.0 * sd_p * sd_p)
        - 0.5
    )


class Layer(nn.Module):
    """Base: stateless pass-through layer."""

    def init(self, generator: torch.Generator) -> dict:
        return {}

    def sample_eps(self, generator: torch.Generator, mc_samples: int) -> dict:
        return {}

    def apply(self, params, eps, x):
        raise NotImplementedError

    def kl(self, params):
        return 0.0

    def nkl(self, params, eps):
        return 0.0

    @property
    def is_variational(self) -> bool:
        return False


class VILinear(Layer):
    """Mean-field Gaussian variational dense layer, ``y = x @ W_sᵀ + b_s``
    (ref ``psvi/models/neural_net.py:176-179``)."""

    def __init__(self, in_dim: int, out_dim: int, init_sd: float = 0.01,
                 prior_sd: float = 1.0, use_bias: bool = True):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.init_sd, self.prior_sd = init_sd, prior_sd
        self.use_bias = use_bias
        self.count_kl = True

    def extra_repr(self):
        return f"{self.in_dim}, {self.out_dim}, init_sd={self.init_sd}, prior_sd={self.prior_sd}"

    def init(self, generator):
        # torch nn.Linear.reset_parameters: U(±1/√fan_in) means
        dev = generator.device
        bound = 1.0 / math.sqrt(self.in_dim)
        rho = inverse_softplus(self.init_sd).to(dev)

        def uniform(shape):
            r = torch.rand(shape, generator=generator, device=dev)
            return (2.0 * r - 1.0) * bound

        p = {
            "mu_w": uniform((self.out_dim, self.in_dim)),
            "rho_w": torch.full((self.out_dim, self.in_dim), float(rho), device=dev),
        }
        if self.use_bias:
            p["mu_b"] = uniform((self.out_dim,))
            p["rho_b"] = torch.full((self.out_dim,), float(rho), device=dev)
        return p

    def sample_eps(self, generator, mc_samples):
        dev = generator.device
        e = {"w": torch.randn((mc_samples, self.out_dim, self.in_dim),
                              generator=generator, device=dev)}
        if self.use_bias:
            e["b"] = torch.randn((mc_samples, self.out_dim), generator=generator, device=dev)
        return e

    def _theta(self, params, eps):
        w = params["mu_w"] + softplus(params["rho_w"]) * eps["w"]
        b = None
        if self.use_bias:
            b = params["mu_b"] + softplus(params["rho_b"]) * eps["b"]
        return w, b

    def apply(self, params, eps, x):
        # x: (N, in) unbatched or (S, N, in); w: (S, out, in); b: (S, out)
        w, b = self._theta(params, eps)
        if x.dim() == 2:
            y = torch.einsum("ni,soi->sno", x, w)
        else:
            y = torch.matmul(x, w.transpose(1, 2))
        if b is not None:
            y = y + b[:, None, :]
        return y

    def kl(self, params):
        sd_w = softplus(params["rho_w"])
        total = torch.sum(_gaussian_kl(params["mu_w"], sd_w, self.prior_sd))
        if self.use_bias:
            sd_b = softplus(params["rho_b"])
            total = total + torch.sum(_gaussian_kl(params["mu_b"], sd_b, self.prior_sd))
        return total

    def nkl(self, params, eps):
        # per-sample log p(θ_s) − log q(θ_s), shape (S,) (ref neural_net.py:110-115)
        w, b = self._theta(params, eps)
        sp = torch.tensor(self.prior_sd, dtype=w.dtype, device=w.device)
        sd_w = softplus(params["rho_w"])
        lp = torch.sum(_normal_logpdf(w, 0.0, sp), dim=(-2, -1))
        lq = torch.sum(_normal_logpdf(w, params["mu_w"], sd_w), dim=(-2, -1))
        out = lp - lq
        if self.use_bias:
            sd_b = softplus(params["rho_b"])
            lpb = torch.sum(_normal_logpdf(b, 0.0, sp), dim=-1)
            lqb = torch.sum(_normal_logpdf(b, params["mu_b"], sd_b), dim=-1)
            out = out + (lpb - lqb)
        return out

    @property
    def is_variational(self) -> bool:
        return True


class ReLU(Layer):
    def apply(self, params, eps, x):
        return torch.relu(x)


class Identity(Layer):
    """Pass-through placeholder (keeps params/eps trees aligned with nets
    whose pooling was folded away in the JAX package)."""

    def apply(self, params, eps, x):
        return x


def _infer_mc_samples(eps) -> Optional[int]:
    for e in eps:
        for v in e.values():
            return int(v.shape[0])
    return None


class Sequential(nn.Module):
    """An ordered stack of layers with tuple-of-dicts params and noise."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def init(self, generator):
        return tuple(layer.init(generator) for layer in self.layers)

    def sample_eps(self, generator, mc_samples: int):
        return tuple(layer.sample_eps(generator, mc_samples) for layer in self.layers)

    def apply(self, params, eps, x, mc_samples: Optional[int] = None):
        """Forward all S samples. x: (N, ...) or (S, N, ...)."""
        in_ndim = x.dim()
        for layer, p, e in zip(self.layers, params, eps):
            x = layer.apply(p, e, x)
        if x.dim() == in_ndim and not any(l.is_variational for l in self.layers):
            S = mc_samples if mc_samples is not None else _infer_mc_samples(eps)
            x = x.unsqueeze(0).expand((S,) + tuple(x.shape))
        return x

    def kl(self, params):
        total = 0.0
        for layer, p in zip(self.layers, params):
            if layer.is_variational and layer.count_kl:
                total = total + layer.kl(p)
        return total

    def nkl(self, params, eps):
        total = None
        for layer, p, e in zip(self.layers, params, eps):
            if layer.is_variational and layer.count_kl:
                term = layer.nkl(p, e)
                total = term if total is None else total + term
        if total is None:
            total = torch.zeros((_infer_mc_samples(eps),))
        return total

    def prep_input(self, x):
        """Identity for dense nets (the JAX package pre-extracts conv
        patches here; that arrives with the LeNet slice)."""
        return x
