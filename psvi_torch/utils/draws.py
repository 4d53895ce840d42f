"""The random draws of the baselines, of selection and of k-means.

Every draw that the JAX package takes from ``jax.random`` in
``inference/baselines.py``, ``inference/selection.py``,
``inference/sparsebbvi.py``, ``models/logreg.py`` and
``models/frequentist.py`` comes here from a ``torch.Generator`` on the
device: standard normals (Laplace noise, initial θ), subsets without
replacement (minibatches), the nets' noise and initial parameters. The
modules call these functions through this module's namespace, so a test
can replace them and feed the JAX package's draws in the order JAX took
them. Draws from NumPy's ``default_rng`` (index picks, initial pseudodata)
stay NumPy in both packages and need no seam.
"""

from __future__ import annotations

import torch


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def normal(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard normal float32 draws of ``shape`` on the generator's device."""
    return torch.randn(tuple(shape), generator=gen, device=gen.device)


def uniform(gen: torch.Generator, shape, low: float = 0.0, high: float = 1.0) -> torch.Tensor:
    """U[low, high) float32 draws of ``shape``."""
    return low + (high - low) * torch.rand(tuple(shape), generator=gen, device=gen.device)


def choice(gen: torch.Generator, n: int, size: int) -> torch.Tensor:
    """``size`` distinct indices of ``range(n)`` (a minibatch)."""
    return torch.randperm(n, generator=gen, device=gen.device)[:size]


def init_params(net, gen: torch.Generator):
    """The net's initial variational parameters."""
    return net.init(gen)


def sample_eps(net, gen: torch.Generator, mc_samples: int):
    """The net's noise for ``mc_samples`` samples."""
    return net.sample_eps(gen, mc_samples)
