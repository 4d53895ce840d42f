"""The port's growth baselines (random, GIGA, sparse VI, original PSVI)
against the JAX package's, on the halfmoon
configuration of tests/test_baselines.py (num_epochs=21, log_every=10,
S=4, seed 0).

Each runner runs in JAX with its draws recorded (``torch_jax_tape``: the
JAX closures eager, every ``jax.random`` draw kept in order), then in the
port with those draws fed to ``psvi_torch.utils.draws``. NumPy picks the
indices in both, from the same stream, so ``csizes`` and the ``wt_index``
keys are equal exactly; the accuracies agree within one test point
(1/200) and the NLLs within rtol 1e-5 (the same Laplace fits, float32
summed in another order).
"""

import torch_threads  # noqa: F401  (torch on this worker's share of the cores)

import numpy as np
import pytest

from psvi_torch.data import read_dataset
from psvi_torch.inference import baselines as PB
from psvi_tpu.inference import baselines as JB
from torch_jax_tape import run_both


@pytest.fixture(scope="module")
def kw():
    d = read_dataset("halfmoon")
    return dict(x=d.x, y=d.y, xt=d.xt, yt=d.yt, N=d.N, D=d.D, num_epochs=21, log_every=10,
                mc_samples=4, seed=0)


def run_named(monkeypatch, name, kw):
    return run_both(monkeypatch, getattr(JB, name), getattr(PB, name), **kw)


def assert_same_run(rj, rp):
    assert len(rp["times"]) == len(rj["times"])
    if "wt_index" in rj:
        assert [sorted(w) for w in rp["wt_index"]] == [sorted(w) for w in rj["wt_index"]]
        for wp, wj in zip(rp["wt_index"], rj["wt_index"]):
            np.testing.assert_allclose([wp[k] for k in sorted(wp)],
                                       [wj[k] for k in sorted(wj)], rtol=1e-5)


def test_run_random_matches_jax(monkeypatch, kw):
    rj, rp = run_named(monkeypatch, "run_random", kw)
    assert_same_run(rj, rp)
    assert rp["csizes"] == [0, 10, 20] and len(rp["wt_index"][-1]) == 20


@pytest.mark.parametrize("growth", ["log_every", "every_step"])
def test_giga_matches_jax(monkeypatch, kw, growth):
    """Both GIGA modes: the reference-faithful cap and the paper's growth."""
    rj, rp = run_named(monkeypatch, "run_giga", {**kw, "data_minibatch": 128,
                                                 "giga_growth": growth})
    assert_same_run(rj, rp)
    assert rp["_core_idcs"] == rj["_core_idcs"]
    np.testing.assert_allclose(rp["_w"], rj["_w"], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(rp["_lw"], rj["_lw"], atol=1e-5)


def test_giga_growth_modes_and_refusal(kw):
    """'every_step' grows more than the capped reference mode, as in JAX's
    tests/test_baselines.py; an unknown mode is refused."""
    kw = {**kw, "data_minibatch": 128, "device": "cpu"}
    ref = PB.run_giga(**kw, giga_growth="log_every")
    fix = PB.run_giga(**kw, giga_growth="every_step")
    assert fix["csizes"][-1] > ref["csizes"][-1]
    assert all(np.isfinite(fix["nlls"]))
    with pytest.raises(ValueError, match="giga_growth"):
        PB.run_giga(**kw, giga_growth="sometimes")


def test_sparsevi_matches_jax(monkeypatch, kw):
    rj, rp = run_named(monkeypatch, "run_sparsevi",
                      {**kw, "data_minibatch": 128, "inner_it": 20, "outer_it": 5})
    assert_same_run(rj, rp)
    assert rp["csizes"][-1] > 0


def test_opsvi_matches_jax(monkeypatch, kw):
    """The persistent MAP iterate, the hand-derived w and u gradients and
    their Adam steps; u, z and w logged."""
    rj, rp = run_named(monkeypatch, "run_opsvi", {**kw, "data_minibatch": 128, "num_pseudo": 10,
                                                  "inner_it": 20, "log_pseudodata": True})
    assert_same_run(rj, rp)
    for k, tol in (("us", 1e-5), ("zs", 0.0), ("vs", 1e-4)):
        np.testing.assert_allclose(np.stack(rp[k]), np.stack(rj[k]), rtol=tol, atol=1e-6)
