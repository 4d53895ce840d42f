"""The port's selection-based logreg baselines (k-means, EL2N), sparse
black-box VI and the incremental MFVI selection against the JAX package's.

As in tests/test_torch_baselines_growth.py, each runner runs in JAX with
its draws recorded and then in the port on them (``torch_jax_tape``):
NumPy's picks are equal, the accuracies agree within one test point and
the NLLs within rtol 1e-5 (sparse BBVI's ELBOs within 1e-4: its inner
steps take Adam on gradients summed over the inner loop, which carry the
float32 rounding further).
"""

import torch_threads  # noqa: F401  (torch on this worker's share of the cores)

import pytest

from psvi_torch.data import read_dataset
from psvi_torch.inference import baselines as PB
from psvi_torch.inference.sparsebbvi import run_sparsevi_with_bb_elbo
from psvi_tpu.inference import baselines as JB
from psvi_tpu.inference import sparsebbvi as JS
from torch_jax_tape import run_both

@pytest.fixture(scope="module")
def halfmoon():
    d = read_dataset("halfmoon")
    return d, dict(x=d.x, y=d.y, xt=d.xt, yt=d.yt, N=d.N, D=d.D, num_epochs=11,
                   log_every=10, mc_samples=4, seed=0)


@pytest.mark.parametrize("name", ["run_kmeans", "run_el2n_coreset"])
def test_selected_logreg_baselines_match_jax(monkeypatch, halfmoon, name):
    """k-means (re-clustered at each logged epoch, JAX's k-means++ centroids
    fed) and EL2N (the frequentist model's uniform init and minibatches
    fed): the same coresets, weights and Laplace evaluations."""
    rj, rp = run_both(monkeypatch, getattr(JB, name), getattr(PB, name), **halfmoon[1], nc=2)
    assert rp["wt_index"] == rj["wt_index"]


def test_sparsebbvi_matches_jax(monkeypatch, halfmoon):
    """Four epochs of the inner, select and outer steps (S=4, three inner
    and three outer steps) with the elbos registered."""
    d = halfmoon[0]
    run_both(monkeypatch, JS.run_sparsevi_with_bb_elbo, run_sparsevi_with_bb_elbo, x=d.x, y=d.y,
             xt=d.xt, yt=d.yt, num_epochs=4, log_every=3, inner_it=3, outer_it=3, seed=0,
             register_elbos=True)


def test_incremental_mfvi_selection_matches_jax(monkeypatch):
    """A 20-point k-means coreset, then one round adding the highest-entropy
    point under the evolving fit (``IncrementalMfviSelect``, ``_NetShim``)."""
    rj, rp = run_both(monkeypatch, JB.run_selection_with_mfvi, PB.run_selection_with_mfvi,
                      train=read_dataset("four_blobs"), mfvi_selection_method="incremental", architecture="fn",
                      n_hidden=8, nc=4, num_pseudo=22, num_epochs=2, log_every=3,
                      pretrain_epochs=1, seed=3)
    assert rp["wt_index"].keys() == rj["wt_index"].keys() and len(rp["wt_index"]) == 21
