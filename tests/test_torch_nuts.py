"""The port's NUTS sampler (``psvi_torch/ops/nuts.py``) held by statistics,
as tests/test_nuts.py holds JAX's, with the same targets and tolerances:
a correlated 2-D Gaussian's moments and the accept rate, an anisotropic
Gaussian's adapted mass, tree positions, the weighted logreg posterior
against its Laplace approximation, and ``run_random(mcmc=True)``'s
accuracy on halfmoon.
"""

import torch_threads  # noqa: F401  (torch on this worker's share of the cores)

import numpy as np
import torch

from psvi_torch.data import read_dataset
from psvi_torch.inference.baselines import run_random
from psvi_torch.models.logreg import logreg_forward, mcmc_sample, run_laplace
from psvi_torch.ops.nuts import nuts_sample


def gen(seed):
    return torch.Generator().manual_seed(seed)


def test_port_nuts_correlated_gaussian_moments():
    mu = torch.tensor([1.0, -2.0])
    cov = torch.tensor([[2.0, 1.2], [1.2, 1.0]])
    prec = torch.linalg.inv(cov)

    def logd(x):
        d = x - mu
        return -0.5 * d @ prec @ d

    samples, info = nuts_sample(logd, torch.zeros(2), gen(0), num_samples=4000,
                                num_warmup=1000)
    s = samples.numpy()
    assert s.shape == (4000, 2)
    assert not info["diverging"].any()
    np.testing.assert_allclose(s.mean(0), mu.numpy(), atol=0.15)
    np.testing.assert_allclose(np.cov(s.T), cov.numpy(), atol=0.35)
    assert 0.6 < float(info["accept_stat"].mean()) <= 1.0


def test_port_nuts_anisotropic_mass_adaptation():
    """Variances 100 and 0.01: the Welford window must learn the metric."""
    sd = torch.tensor([10.0, 0.1])

    def logd(x):
        return -0.5 * torch.sum(torch.square(x / sd))

    samples, info = nuts_sample(logd, torch.tensor([1.0, 0.1]), gen(1), num_samples=4000,
                                num_warmup=1500, max_depth=10)
    s = samples.numpy()
    inv_mass = info["inv_mass"].numpy()
    assert inv_mass[0] / inv_mass[1] > 100.0
    np.testing.assert_allclose(s.std(0), sd.numpy(), rtol=0.35)
    np.testing.assert_allclose(s.mean(0), np.zeros(2), atol=0.6)


def test_port_nuts_tree_position():
    def logd(tree):
        return -0.5 * (torch.sum(tree["a"] ** 2) + torch.sum(tree["b"] ** 2))

    init = {"a": torch.zeros(3), "b": torch.zeros((2, 2))}
    samples, _ = nuts_sample(logd, init, gen(2), num_samples=200, num_warmup=200)
    assert samples["a"].shape == (200, 3) and samples["b"].shape == (200, 2, 2)
    assert torch.isfinite(samples["a"]).all()


def test_port_mcmc_sample_logreg_posterior_matches_laplace():
    rng = np.random.default_rng(0)
    N, D = 200, 3
    theta_true = np.asarray([1.5, -2.0, 0.5])
    x = rng.standard_normal((N, D)).astype(np.float32)
    y = (rng.random(N) < 1 / (1 + np.exp(-x @ theta_true))).astype(np.float32)
    w = np.ones(N, np.float32)
    samples, info = mcmc_sample(gen(3), x, y, w, num_samples=2000, num_warmup=800)
    s = samples.numpy()
    assert not info["diverging"].any()
    lap = run_laplace(gen(4), torch.tensor(x), torch.tensor(y), torch.tensor(w), inner_it=8000,
                      mc_samples=4000, diagonal=False, lr0net=1e-2).numpy()
    np.testing.assert_allclose(s.mean(0), lap.mean(0), atol=0.25)
    np.testing.assert_allclose(s.std(0), lap.std(0), rtol=0.5)
    xt = torch.tensor(x)
    acc_nuts = np.mean((logreg_forward(torch.tensor(s[::10]), xt).numpy() > 0.5) == (y > 0.5))
    acc_lap = np.mean((logreg_forward(torch.tensor(lap[::10]), xt).numpy() > 0.5) == (y > 0.5))
    assert abs(acc_nuts - acc_lap) < 0.03


def test_port_run_random_mcmc_eval():
    data = read_dataset("halfmoon")
    res = run_random(x=data.x, y=data.y, xt=data.xt, yt=data.yt, N=data.N, D=data.D,
                     num_epochs=21, log_every=10, mc_samples=50, seed=0, mcmc=True,
                     device="cpu")
    assert len(res["accs"]) == 3
    assert res["accs"][-1] > 0.75
