"""The port's MFVI family against the JAX package's: ``_MFVI.elbo_loss``
and its gradient on JAX's parameters and noise (rtol 1e-5 and 1e-4),
``run_mfvi``, ``run_mfvi_subset``, the regressors and the tau their grid
search picks.

As in tests/test_torch_baselines_growth.py, each runner runs in JAX with
its draws recorded and then in the port on them (``torch_jax_tape``): the
accuracies agree within one test point, NLLs, RMSEs, LLs and ELBOs within
rtol 1e-5, and the regressor's tau is JAX's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from psvi_torch.data import read_dataset, read_regression_dataset
from psvi_torch.inference import baselines as PB
from psvi_torch.utils.convert import params_from_jax
from psvi_torch.utils.tree import tree_leaves, value_and_grad
from psvi_tpu.inference import baselines as JB
from torch_jax_tape import run_both

RTOL = 1e-5


@pytest.fixture(scope="module")
def halfmoon():
    return read_dataset("halfmoon")


def test_mfvi_elbo_loss_matches_jax(halfmoon):
    d = halfmoon
    jm = JB._MFVI(d, "fn", 20, 2, 4, 1e-3, 1e-3, 64, 0)
    pm = PB._MFVI(d, "fn", 20, 2, 4, 1e-3, 1e-3, 64, 0, device="cpu")
    rng = np.random.default_rng(2)
    jp = jax.tree_util.tree_map(lambda a: (0.5 * rng.standard_normal(a.shape)).astype(np.float32),
                                jm.params)
    eps = jm.net.sample_eps(jax.random.PRNGKey(5), 4)
    xb, yb = d.x[:64], d.y[:64]
    jl, jg = jax.value_and_grad(jm.elbo_loss)(jp, eps, xb, yb, d.N / 64, "categorical", None)
    pl, pg = value_and_grad(
        lambda p: pm.elbo_loss(p, params_from_jax(eps, "cpu"), torch.tensor(xb),
                               torch.tensor(yb), d.N / 64, "categorical", None),
        params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu"))
    np.testing.assert_allclose(float(pl), float(jl), rtol=RTOL)
    for a, b in zip(tree_leaves(pg), jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5 * np.abs(np.asarray(b)).max())


def test_mfvi_runs_match_jax(monkeypatch, halfmoon):
    """run_mfvi (a random minibatch a step) and run_mfvi_subset (a fixed
    class-balanced subset, logged pseudodata)."""
    d = halfmoon
    kw = dict(train=d, architecture="fn", n_hidden=20, nc=2, num_epochs=3, log_every=2,
              mc_samples=4, init_sd=1e-3)
    run_both(monkeypatch, JB.run_mfvi, PB.run_mfvi, **kw)
    rj, rp = run_both(monkeypatch, JB.run_mfvi_subset, PB.run_mfvi_subset, **kw, num_pseudo=20,
                      log_pseudodata=True)
    np.testing.assert_array_equal(rp["us"], np.asarray(rj["us"]))
    np.testing.assert_array_equal(rp["zs"], np.asarray(rj["zs"]))


def test_mfvi_regressor_tau_grid_matches_jax(monkeypatch):
    """The tau grid search, over two of sinus's taus, picks JAX's tau; the
    test RMSE and LL follow."""
    rd = read_regression_dataset("sinus")
    rd = dataclasses.replace(rd, taus=tuple(rd.taus[:2]))
    rj, rp = run_both(monkeypatch, JB.run_mfvi_regressor, PB.run_mfvi_regressor, train=rd,
                      num_epochs=1, log_every=5, mc_samples=4, model_selection=True)
    assert rp["best_tau"] in rd.taus
    run_both(monkeypatch, JB.run_mfvi_subset_regressor, PB.run_mfvi_subset_regressor, train=rd,
             num_epochs=1, log_every=5, num_pseudo=50, mc_samples=4)


def test_mfvi_refuses_the_mesh():
    with pytest.raises(NotImplementedError, match="A.11|item 11"):
        PB.run_mfvi(train=read_dataset("halfmoon"), architecture="fn", n_hidden=4,
                    shard_batch=True, device="cpu")
