"""Variational layers: dense (mean-field and full-covariance), conv, and
the stateless and normalising layers of the model zoo.

Counterpart of ``psvi_tpu/models/layers.py``'s ``VILinear``,
``VILinearFullCov``, ``VIConv2d``, ``VIConvPool2d`` (with ``PrePatched``
and ``fuse_conv_pool``), ``MaxPool2d`` (both backends, ``_argmax_pool``),
``AvgPool2d``, ``BatchNorm2d``, ``LocalResponseNorm``, ``Flatten``,
``ReLU``, ``Identity``, ``Residual``, ``Sequential`` and the net rewrites
``with_dense_backend``, ``with_compute_dtype`` and ``with_pool_backend``.
Each layer is an ``nn.Module`` that holds its configuration; the
computation is functional so that ``torch.autograd`` can differentiate
through the inner unroll:

- ``init(generator)`` returns the parameter dict (for the mean-field
  layers ``{'mu_w','rho_w','mu_b','rho_b'}``, sd stored pre-softplus) on
  the generator's device;
- ``sample_eps(generator, S)`` draws the standard-normal noise dict with a
  leading MC-sample axis ``S``;
- ``apply(params, eps, x)`` runs the reparameterized forward for all S
  samples, θ = μ + softplus(ρ)·ε;
- ``nkl(params, eps)`` is the per-sample log p(θ) − log q(θ) from the same
  ε as the forward; ``kl(params)`` the analytic KL(q‖p).

Activations carry a leading sample axis ``(S, N, ...)``; the first
variational layer accepts an unbatched ``(N, ...)`` input and adds it.

Mixed precision (``compute_dtype="bfloat16"`` on the variational layers,
JAX's rules): the matmul and conv operands are cast to bf16 and the
activations stay bf16 between layers; the parameters, KL, NKL and all loss
math stay float32, and ``Sequential.apply`` casts the net's output back to
float32.
"""

from __future__ import annotations

import copy
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from psvi_torch.utils.tree import tree_leaves

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


def _dtype(name: str) -> torch.dtype:
    """The torch dtype of a ``compute_dtype`` name (``"float32"``,
    ``"bfloat16"``, ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"unknown compute_dtype {name!r}")
    return dt


def _to_compute(name: str, *xs):
    """``xs`` cast to the compute dtype ``name``; under float32 (or for a
    float64 run) they pass as they are, and None passes through."""
    cd = _dtype(name)
    if cd == torch.float32:
        return xs
    return tuple(None if x is None else x.to(cd) for x in xs)


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


class _MeanField(Layer):
    """θ = μ + softplus(ρ)·ε for a weight of any shape and an optional bias;
    the analytic KL to N(0, prior_sd²) and the per-sample log p − log q.
    Subclasses set ``prior_sd`` and ``use_bias``."""

    def _theta(self, params, eps):
        w = params["mu_w"] + softplus(params["rho_w"]) * eps["w"]
        b = None
        if self.use_bias:
            b = params["mu_b"] + softplus(params["rho_b"]) * eps["b"]
        return w, b

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
        sp = w.new_full((), self.prior_sd)  # made on the device: no host copy, no sync
        sd_w = softplus(params["rho_w"])
        axes = tuple(range(1, w.dim()))
        out = (torch.sum(_normal_logpdf(w, 0.0, sp), dim=axes)
               - torch.sum(_normal_logpdf(w, params["mu_w"], sd_w), dim=axes))
        if self.use_bias:
            sd_b = softplus(params["rho_b"])
            out = out + (torch.sum(_normal_logpdf(b, 0.0, sp), dim=-1)
                         - torch.sum(_normal_logpdf(b, params["mu_b"], sd_b), dim=-1))
        return out

    @property
    def is_variational(self) -> bool:
        return True


class VILinear(_MeanField):
    """Mean-field Gaussian variational dense layer, ``y = x @ W_sᵀ + b_s``
    (ref ``psvi/models/neural_net.py:176-179``).

    ``backend`` keeps the JAX package's two values so that a JAX config
    selects the same path: ``"xla"``, the plain product; ``"pallas"``, which
    in the port means kernel B3 (``ops/sampled_linear.py``, hand-written
    CUDA on the card) for every batched (S, N, in) input. B3's backward is
    first-order only, so ``"pallas"`` serves the first-order paths; under a
    compute dtype other than float32 the layer takes the plain formulation
    (B3 is float32 only), as the JAX layer does."""

    def __init__(self, in_dim: int, out_dim: int, init_sd: float = 0.01,
                 prior_sd: float = 1.0, use_bias: bool = True, backend: str = "xla",
                 compute_dtype: str = "float32"):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.init_sd, self.prior_sd = init_sd, prior_sd
        self.use_bias = use_bias
        self.count_kl = True
        self.backend = backend
        self.compute_dtype = compute_dtype

    def extra_repr(self):
        return (f"{self.in_dim}, {self.out_dim}, init_sd={self.init_sd}, "
                f"prior_sd={self.prior_sd}, backend={self.backend}, "
                f"compute_dtype={self.compute_dtype}")

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

    def apply(self, params, eps, x):
        # x: (N, in) unbatched or (S, N, in); w: (S, out, in); b: (S, out)
        if (x.dim() == 3 and self.backend == "pallas" and self.use_bias
                and self.compute_dtype == "float32"):
            # imported here, as the JAX layer does (layers.py:158)
            from psvi_torch.ops.sampled_linear import sampled_linear

            return sampled_linear(x, params["mu_w"], params["rho_w"], params["mu_b"],
                                  params["rho_b"], eps["w"], eps["b"])
        w, b = self._theta(params, eps)
        return self.apply_theta(w, b, x)

    def apply_theta(self, w, b, x):
        """Forward with explicit samples w (S, out, in), b (S, out)."""
        x, w, b = _to_compute(self.compute_dtype, x, w, b)
        if x.dim() == 2:
            y = torch.einsum("ni,soi->sno", x, w)
        else:
            y = torch.matmul(x, w.transpose(1, 2))
        if b is not None:
            y = y + b[:, None, :]
        return y


class VILinearFullCov(Layer):
    """Full-covariance Gaussian variational dense layer (JAX
    ``VILinearFullCov``; ref ``VILinearMultivariateNormal``,
    ``psvi/models/neural_net.py:408-491``): the flattened weights and bias,
    W first, share one multivariate normal N(mean, L Lᵀ), with L =
    softplus(ρ) on the diagonal and ``corr`` on the full strictly-lower
    triangle in row-major order (``jnp.tril_indices(n, k=-1)``'s). JAX
    deliberately fills the whole triangle where the reference leaves the
    last row without free entries; the port keeps JAX's family.

    Parameters ``{'mean', 'rho', 'corr'}``, ``mean`` and ``corr`` starting
    at zero; noise ``{'e': (S, n)}``; θ = mean + ε Lᵀ."""

    def __init__(self, in_dim: int, out_dim: int, init_sd: float = 0.01,
                 prior_sd: float = 1.0, use_bias: bool = True,
                 compute_dtype: str = "float32"):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.init_sd, self.prior_sd = init_sd, prior_sd
        self.use_bias = use_bias
        self.count_kl = True
        self.compute_dtype = compute_dtype

    def extra_repr(self):
        return (f"{self.in_dim}, {self.out_dim}, init_sd={self.init_sd}, "
                f"prior_sd={self.prior_sd}, compute_dtype={self.compute_dtype}")

    @property
    def num_params(self) -> int:
        return self.out_dim * self.in_dim + (self.out_dim if self.use_bias else 0)

    def init(self, generator):
        dev, n = generator.device, self.num_params
        rho = float(inverse_softplus(self.init_sd))
        return {"mean": torch.zeros(n, device=dev),
                "rho": torch.full((n,), rho, device=dev),
                "corr": torch.zeros(n * (n - 1) // 2, device=dev)}

    def sample_eps(self, generator, mc_samples):
        return {"e": torch.randn((mc_samples, self.num_params), generator=generator,
                                 device=generator.device)}

    def _scale_tril(self, params):
        n, rho = self.num_params, params["rho"]
        i, j = torch.tril_indices(n, n, offset=-1, device=rho.device)
        return torch.diag(softplus(rho)).index_put((i, j), params["corr"])

    def _theta_flat(self, params, eps):
        L = self._scale_tril(params)
        return params["mean"] + eps["e"] @ L.T, L

    def apply(self, params, eps, x):
        theta, _ = self._theta_flat(params, eps)
        nw = self.out_dim * self.in_dim
        w = theta[..., :nw].reshape(*theta.shape[:-1], self.out_dim, self.in_dim)
        b = theta[..., nw:] if self.use_bias else None
        x, w, b = _to_compute(self.compute_dtype, x, w, b)
        y = torch.einsum("ni,soi->sno" if x.dim() == 2 else "sni,soi->sno", x, w)
        if b is not None:
            y = y + b[:, None, :]
        return y

    def kl(self, params):
        # KL( N(μ, LLᵀ) ‖ N(0, σ_p² I) ), analytic (ref neural_net.py:435-436)
        n, sp2 = self.num_params, self.prior_sd ** 2
        L = self._scale_tril(params)
        logdet_q = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
        tr = torch.sum(torch.square(L)) / sp2
        quad = torch.sum(torch.square(params["mean"])) / sp2
        logdet_p = 2.0 * n * math.log(self.prior_sd)
        return 0.5 * (logdet_p - logdet_q - n + tr + quad)

    def nkl(self, params, eps):
        # log q(θ): θ − μ = Lε, so the quadratic form is ‖ε‖²
        theta, L = self._theta_flat(params, eps)
        lq = (-0.5 * torch.sum(torch.square(eps["e"]), dim=-1)
              - torch.sum(torch.log(torch.diagonal(L))) - self.num_params * _HALF_LOG_2PI)
        sp = theta.new_full((), self.prior_sd)
        return torch.sum(_normal_logpdf(theta, 0.0, sp), dim=-1) - lq

    @property
    def is_variational(self) -> bool:
        return True


class VIConv2d(_MeanField):
    """Mean-field Gaussian variational 2-D convolution (ref
    ``psvi/models/neural_net.py:194-246``), weights (K, C, k, k).

    ``count_kl`` defaults to False: the reference's ELBOs skip conv-layer KL
    terms (``psvi_classes.py:479-483,506-510``). An unbatched (N, C, H, W)
    input with C·k² ≤ 256 takes the im2col form (``_apply_patches``); a
    batched (S, N, C, H, W) input runs one grouped convolution over the S
    samples.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, init_sd: float = 0.01, prior_sd: float = 1.0,
                 use_bias: bool = True, count_kl: bool = False, compute_dtype: str = "float32"):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.init_sd, self.prior_sd = init_sd, prior_sd
        self.use_bias, self.count_kl = use_bias, count_kl
        self.compute_dtype = compute_dtype

    def config(self) -> dict:
        return dict(in_channels=self.in_channels, out_channels=self.out_channels,
                    kernel_size=self.kernel_size, stride=self.stride, padding=self.padding,
                    init_sd=self.init_sd, prior_sd=self.prior_sd, use_bias=self.use_bias,
                    count_kl=self.count_kl, compute_dtype=self.compute_dtype)

    def extra_repr(self):
        return ", ".join(f"{k}={v}" for k, v in self.config().items())

    def _out_hw(self, H, W):
        k, st, p = self.kernel_size, self.stride, self.padding
        return (H + 2 * p - k) // st + 1, (W + 2 * p - k) // st + 1

    def init(self, generator):
        dev = generator.device
        k = self.kernel_size
        bound = 1.0 / math.sqrt(self.in_channels * k * k)
        rho = float(inverse_softplus(self.init_sd))
        shape = (self.out_channels, self.in_channels, k, k)

        def uniform(sh):
            return (2.0 * torch.rand(sh, generator=generator, device=dev) - 1.0) * bound

        p = {"mu_w": uniform(shape), "rho_w": torch.full(shape, rho, device=dev)}
        if self.use_bias:
            p["mu_b"] = uniform((self.out_channels,))
            p["rho_b"] = torch.full((self.out_channels,), rho, device=dev)
        return p

    def sample_eps(self, generator, mc_samples):
        dev, k = generator.device, self.kernel_size
        e = {"w": torch.randn((mc_samples, self.out_channels, self.in_channels, k, k),
                              generator=generator, device=dev)}
        if self.use_bias:
            e["b"] = torch.randn((mc_samples, self.out_channels), generator=generator, device=dev)
        return e

    def apply(self, params, eps, x):
        w, b = self._theta(params, eps)
        return self.apply_theta(w, b, x)

    def apply_theta(self, w, b, x):
        """Forward with explicit samples w (S,K,C,k,k), b (S,K)."""
        if x.dim() == 4 and self.in_channels * self.kernel_size ** 2 <= 256:
            return self._apply_patches(w, b, x)
        if x.dim() == 4:
            x = x.unsqueeze(0).expand((w.shape[0],) + tuple(x.shape))
        x, w, b = _to_compute(self.compute_dtype, x, w, b)
        S, N, C, H, W = x.shape
        K, k = w.shape[1], self.kernel_size
        OH, OW = self._out_hw(H, W)
        xg = x.permute(1, 0, 2, 3, 4).reshape(N, S * C, H, W)
        y = F.conv2d(xg, w.reshape(S * K, C, k, k), stride=self.stride,
                     padding=self.padding, groups=S)
        y = y.reshape(N, S, K, OH, OW).permute(1, 0, 2, 3, 4)
        if b is not None:
            y = y + b[:, None, :, None, None]
        return y

    def _patches(self, x):
        """Stride-st im2col of an unbatched input: (N, k², C, OH, OW)."""
        k, st, p = self.kernel_size, self.stride, self.padding
        N, C, H, W = x.shape
        OH, OW = self._out_hw(H, W)
        xp = F.pad(x, (p, p, p, p)) if p else x
        cols = [xp[:, :, i:i + st * OH:st, j:j + st * OW:st]
                for i in range(k) for j in range(k)]
        return torch.stack(cols, dim=1)

    def _apply_patches(self, w, b, x):
        """im2col formulation for an unbatched input (N, C, H, W)."""
        S, K, C, k = w.shape[0], w.shape[1], self.in_channels, self.kernel_size
        P, wf, b = _to_compute(self.compute_dtype, self._patches(x),
                               w.reshape(S, K, C, k * k), b)
        y = torch.einsum("nqchw,socq->snohw", P, wf)
        if b is not None:
            y = y + b[:, None, :, None, None]
        return y


class PrePatched:
    """Pre-extracted first-layer conv patches standing in for the raw
    (N, C, H, W) input of a :class:`VIConvPool2d`-headed net (built by
    :meth:`Sequential.prep_input` once per outer step)."""

    def __init__(self, pr, x_shape):
        self.pr = pr  # (N, q, C, PH, pk, PW, pk)
        self.x_shape = tuple(x_shape)

    def dim(self):
        return len(self.x_shape)

    @property
    def shape(self):
        return self.x_shape


class VIConvPool2d(VIConv2d):
    """Conv + non-overlapping ``pool_k``×``pool_k`` max-pool, fused.

    On an unbatched input the conv output positions are split into the
    pool_k² pool-window parities, each an im2col einsum, and the pool is an
    elementwise max over them; the bias is added after the max (exact:
    rounding is monotone). A batched input, or a conv output that does not
    tile by pool_k, takes the grouped conv and a crop-and-reshape pool
    (floor semantics, as ``MaxPool2d``).
    """

    def __init__(self, *args, pool_k: int = 2, **kwargs):
        super().__init__(*args, **kwargs)
        self.pool_k = pool_k

    def supports_parity(self, x_shape) -> bool:
        """True when ``x_shape`` (N, C, H, W) takes the parity path."""
        if len(x_shape) != 4:
            return False
        OH, OW = self._out_hw(x_shape[-2], x_shape[-1])
        pk = self.pool_k
        return OH % pk == 0 and OW % pk == 0 and self.in_channels * self.kernel_size ** 2 <= 256

    def extract_patches(self, x):
        """Stride-1 im2col patches reshaped for the parity einsums:
        (N, q, C, PH, pk, PW, pk), in the compute dtype."""
        P = self._patches(x)
        N, q, C, OH, OW = P.shape
        pk = self.pool_k
        (Pr,) = _to_compute(self.compute_dtype, P.reshape(N, q, C, OH // pk, pk, OW // pk, pk))
        return Pr

    def apply_theta(self, w, b, x):
        if isinstance(x, PrePatched):
            return self._parity_matmuls(w, b, x.pr)
        if not self.supports_parity(tuple(x.shape)):
            y = super().apply_theta(w, b, x)
            *lead, HH, WW = y.shape
            pk = self.pool_k
            y = y[..., :(HH // pk) * pk, :(WW // pk) * pk]
            y = y.reshape(*lead, HH // pk, pk, WW // pk, pk)
            return torch.amax(y, dim=(-3, -1))
        return self._parity_matmuls(w, b, self.extract_patches(x))

    def _parity_matmuls(self, w, b, Pr):
        S, K, C, k = w.shape[0], w.shape[1], self.in_channels, self.kernel_size
        wf, b = _to_compute(self.compute_dtype, w.reshape(S, K, C, k * k), b)
        y = None
        for a_ in range(self.pool_k):
            for b_ in range(self.pool_k):
                ya = torch.einsum("nqchw,skcq->snkhw", Pr[:, :, :, :, a_, :, b_], wf)
                y = ya if y is None else torch.maximum(y, ya)
        if b is not None:
            y = y + b[:, None, :, None, None]
        return y


class ReLU(Layer):
    def apply(self, params, eps, x):
        return torch.relu(x)


class Identity(Layer):
    """Pass-through placeholder: stands where :func:`fuse_conv_pool` folded
    a MaxPool2d into the conv before it, so the params/eps trees keep the
    unfused net's structure."""

    def apply(self, params, eps, x):
        return x


class Flatten(Layer):
    """Flatten trailing (C, H, W) → features (ref ``nn.Flatten(-3, -1)``)."""

    def apply(self, params, eps, x):
        return x.reshape(*x.shape[:-3], -1)


def _argmax_pool(x, k: int):
    """Non-overlapping k×k max-pool whose gradient goes to the recorded
    argmax of each window, the first index on ties, as torch's
    ``MaxPool2d`` and JAX's ``_argmax_pool`` route it (the ``"reshape"``
    backend's ``torch.amax`` splits it over tied positions instead). The
    value is the window's max; the gradient is ``gather``'s, whose own
    gradient is a scatter, so every order of derivative exists. (JAX's
    int8 residual is a memory device of XLA's and has no meaning here.)"""
    *lead, H, W = x.shape
    xw = x.reshape(*lead, H // k, k, W // k, k).movedim(-3, -2).reshape(
        *lead, H // k, W // k, k * k)
    idx = torch.argmax(xw, dim=-1, keepdim=True)  # the first maximal index
    return torch.gather(xw, -1, idx).squeeze(-1)


_POOL_BACKENDS = ("reshape", "argmax")


class MaxPool2d(Layer):
    """Max-pool over (H, W); leading axes pass through (ref
    ``BatchMaxPool2d``, ``psvi/models/neural_net.py:249-255``).
    ``backend="argmax"`` takes :func:`_argmax_pool` on the non-overlapping
    path."""

    def __init__(self, kernel_size: int, stride: int, padding: int = 0,
                 backend: str = "reshape"):
        super().__init__()
        if backend not in _POOL_BACKENDS:
            raise ValueError(f"unknown pool backend {backend!r}")
        self.kernel_size, self.stride, self.padding, self.backend = (
            kernel_size, stride, padding, backend)

    def apply(self, params, eps, x):
        k, s, p = self.kernel_size, self.stride, self.padding
        *lead, H, W = x.shape
        if k == s and p == 0 and H % k == 0 and W % k == 0:
            if self.backend == "argmax":
                return _argmax_pool(x, k)
            return torch.amax(x.reshape(*lead, H // k, k, W // k, k), dim=(-3, -1))
        y = F.max_pool2d(x.reshape(1, -1, H, W), k, s, p)
        return y.reshape(*lead, *y.shape[-2:])


class AvgPool2d(Layer):
    """Average pool over (H, W) with no padding (floor); leading axes pass
    through. ``stride`` None means ``kernel_size``."""

    def __init__(self, kernel_size: int, stride: Optional[int] = None):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride

    def apply(self, params, eps, x):
        k = self.kernel_size
        *lead, H, W = x.shape
        y = F.avg_pool2d(x.reshape(1, -1, H, W), k, self.stride if self.stride is not None else k)
        return y.reshape(*lead, *y.shape[-2:])


class BatchNorm2d(Layer):
    """Batch normalisation per channel with the current batch's statistics
    over every other axis, (S, N, H, W) together, and the biased variance
    (JAX ``BatchNorm2d``; the reference's ``BayesBatchNorm2d``,
    ``neural_net.py:257-263``, flattens (S, N) and never leaves train mode).
    No running statistics are kept. Parameters ``{'gamma', 'beta'}``."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.num_features, self.eps = num_features, eps

    def init(self, generator):
        dev = generator.device
        return {"gamma": torch.ones(self.num_features, device=dev),
                "beta": torch.zeros(self.num_features, device=dev)}

    def apply(self, params, eps, x):
        # x: (S, N, C, H, W) or (N, C, H, W)
        c_axis = x.dim() - 3
        axes = tuple(i for i in range(x.dim()) if i != c_axis)
        mean = torch.mean(x, dim=axes, keepdim=True)
        var = torch.var(x, dim=axes, keepdim=True, correction=0)
        shape = (1,) * c_axis + (-1, 1, 1)
        xhat = (x - mean) * torch.rsqrt(var + self.eps)
        return xhat * params["gamma"].reshape(shape) + params["beta"].reshape(shape)


class LocalResponseNorm(Layer):
    """Cross-channel local response normalisation (AlexNet; ref
    ``nn.LocalResponseNorm(4, alpha=0.001/9, beta=0.75, k=1)``,
    ``psvi/models/neural_net.py:384-388``), as JAX's layer computes it:
    x / (k + α/n·Σ x²)^β with the sum over channels c − lo … c + hi, lo =
    (n − 1)//2, hi = n − 1 − lo. ``F.local_response_norm`` puts the longer
    side of an even window on the other side (lo = n//2), so at n = 4 it is
    another function."""

    def __init__(self, size: int, alpha: float = 1e-4, beta: float = 0.75, k: float = 1.0):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def apply(self, params, eps, x):
        # x: (S, N, C, H, W) or (N, C, H, W)
        n, C = self.size, x.shape[-3]
        lo = (n - 1) // 2
        sq = F.pad(torch.square(x), (0, 0, 0, 0, lo, n - 1 - lo))
        ssum = sq.narrow(-3, 0, C)
        for j in range(1, n):
            ssum = ssum + sq.narrow(-3, j, C)
        return x / torch.pow(self.k + (self.alpha / n) * ssum, self.beta)


def fuse_conv_pool(net: "Sequential") -> "Sequential":
    """Fold every top-level ``(VIConv2d, MaxPool2d(k == s, p == 0))`` pair
    into a :class:`VIConvPool2d` + :class:`Identity` pair. Both MaxPool2d
    and Identity hold empty params, so the params/eps trees keep their
    structure."""
    layers, out, i = list(net.layers), [], 0
    while i < len(layers):
        l = layers[i]
        nxt = layers[i + 1] if i + 1 < len(layers) else None
        if (type(l) is VIConv2d and isinstance(nxt, MaxPool2d)
                and nxt.kernel_size == nxt.stride and nxt.padding == 0
                and nxt.backend == "reshape"):
            out += [VIConvPool2d(**l.config(), pool_k=nxt.kernel_size), Identity()]
            i += 2
        else:
            out.append(l)
            i += 1
    return Sequential(out)


def _rewrite_layers(net: "Sequential", fn) -> "Sequential":
    """A copy of ``net`` with ``fn`` run on each of its leaf layers, which it
    may change in place, recursing through the containers (``Residual``'s
    body and shortcut), as JAX ``_rewrite_layers``. The input net is left as
    it is."""
    net = copy.deepcopy(net)

    def visit(layers):
        for layer in layers:
            if isinstance(layer, Residual):
                visit(layer.body.layers)
                visit(layer.shortcut.layers)
            else:
                fn(layer)

    visit(net.layers)
    return net


def _set_if(kind, **attrs):
    def fn(layer):
        if isinstance(layer, kind):
            for k, v in attrs.items():
                setattr(layer, k, v)
    return fn


def with_dense_backend(net: "Sequential", backend: str) -> "Sequential":
    """A copy of ``net`` with every ``VILinear``'s ``backend`` replaced
    (``"xla"`` or ``"pallas"``); convolutions are left as they are."""
    if backend not in ("xla", "pallas"):
        raise ValueError(f"unknown dense backend {backend!r}")
    return _rewrite_layers(net, _set_if(VILinear, backend=backend))


def with_compute_dtype(net: "Sequential", dtype: str) -> "Sequential":
    """A copy of ``net`` with every variational layer's ``compute_dtype``
    replaced (``"bfloat16"`` for mixed precision): only the matmul and conv
    operands are cast; parameters, KL, NKL and the loss math stay
    float32."""
    _dtype(dtype)

    def fn(layer):  # every layer that has one, as JAX rewrites them
        if hasattr(layer, "compute_dtype"):
            layer.compute_dtype = dtype

    return _rewrite_layers(net, fn)


def with_pool_backend(net: "Sequential", backend: str) -> "Sequential":
    """A copy of ``net`` with every ``MaxPool2d``'s ``backend`` replaced
    (``"argmax"``: :func:`_argmax_pool`)."""
    if backend not in _POOL_BACKENDS:
        raise ValueError(f"unknown pool backend {backend!r}")
    return _rewrite_layers(net, _set_if(MaxPool2d, backend=backend))


def _infer_mc_samples(eps) -> int:
    leaves = tree_leaves(eps)
    if not leaves:
        raise ValueError("cannot infer mc_samples from empty eps pytree")
    return int(leaves[0].shape[0])


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
        if x.is_floating_point() and x.element_size() < 4:
            # the mixed-precision boundary: the objective's math runs in fp32
            # (a float64 run, the tests' oracles, stays float64)
            x = x.float()
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
            # no counted layer: zeros on the noise's device and dtype (an
            # empty noise tree raises, as in JAX)
            S = _infer_mc_samples(eps)
            leaf = tree_leaves(eps)[0]
            total = torch.zeros((S,), dtype=leaf.dtype, device=leaf.device)
        return total

    @property
    def variational_layers(self):
        return tuple(i for i, l in enumerate(self.layers) if l.is_variational)

    def prep_input(self, x):
        """Pre-extract the first layer's conv patches for repeated forwards
        on the same input (the inner loop on the coreset u): a
        :class:`PrePatched` when the net starts with a :class:`VIConvPool2d`
        that takes ``x`` on its parity path, else ``x`` unchanged."""
        first = self.layers[0] if len(self.layers) else None
        if (isinstance(first, VIConvPool2d) and not isinstance(x, PrePatched)
                and first.supports_parity(tuple(x.shape))):
            return PrePatched(first.extract_patches(x), x.shape)
        return x


class Residual(Layer):
    """Residual block, y = relu(body(x) + shortcut(x)) (JAX ``Residual``; ref
    ``psvi/models/neural_net.py:532-584``). ``body`` and ``shortcut`` are
    Sequentials (an empty shortcut is the identity); parameters and noise
    are ``{'body', 'shortcut'}`` dicts, drawn body first. The block counts
    as variational, and its KL is counted, only where a sub-layer is
    variational with its KL counted: the builders' convs are not, so a
    ResNet's KL and NKL are its last ``VILinear``'s alone."""

    def __init__(self, body: Sequential, shortcut: Sequential):
        super().__init__()
        self.body, self.shortcut = body, shortcut

    def init(self, generator):
        return {"body": self.body.init(generator), "shortcut": self.shortcut.init(generator)}

    def sample_eps(self, generator, mc_samples):
        return {"body": self.body.sample_eps(generator, mc_samples),
                "shortcut": self.shortcut.sample_eps(generator, mc_samples)}

    @staticmethod
    def _sub_apply(net, params, eps, x):
        # x already carries the S axis: the layers run without a broadcast
        for layer, p, e in zip(net.layers, params, eps):
            x = layer.apply(p, e, x)
        return x

    def apply(self, params, eps, x):
        out = self._sub_apply(self.body, params["body"], eps["body"], x)
        sc = self._sub_apply(self.shortcut, params["shortcut"], eps["shortcut"], x)
        return torch.relu(out + sc)

    def kl(self, params):
        return self.body.kl(params["body"]) + self.shortcut.kl(params["shortcut"])

    def nkl(self, params, eps):
        return (self.body.nkl(params["body"], eps["body"])
                + self.shortcut.nkl(params["shortcut"], eps["shortcut"]))

    @property
    def is_variational(self) -> bool:
        return any(l.is_variational and l.count_kl
                   for l in list(self.body.layers) + list(self.shortcut.layers))

    @property
    def count_kl(self) -> bool:
        return self.is_variational
