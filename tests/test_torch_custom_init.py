"""The engine's ``init_args='custom'`` against the JAX engine's, and the
nine selection options.

- On four_blobs (fn 2-8-4, M=8), ``mfvi_selection_method`` ``kmeans`` (raw
  space) and ``entropy`` (an MFVI pretraining, then the top-entropy points
  per class), with JAX's selection draws fed (``torch_jax_tape``, recorded
  during JAX's ``_init_pseudodata`` only): the same ``chosen_indices``, u
  and z bit for bit, and v (standard normal from the engine's NumPy
  stream) bit for bit; then one nested step from JAX's state against the
  jitted JAX step, plain and fused, at the tolerances of
  tests/test_torch_lifecycle.py.
- Soft labels (``learn_z``) start one-hot from the chosen labels.
- Every ``score_method`` JAX's ``CoresetSelect`` accepts builds an engine
  that takes a fused step (the plain versions of B1 on the CPU).
- The nine options reach ``CoresetSelect`` with the engine's values, as
  tests/test_round2_features.py checks for JAX; the parallelism options
  are still refused.
"""

import torch_threads  # noqa: F401  (torch on this worker's share of the cores)

import jax
import numpy as np
import pytest
import torch

from psvi_torch.data import read_dataset
from psvi_torch.inference import psvi as PP
from psvi_torch.inference import selection as PS
from psvi_torch.inference.psvi import PSVI
from psvi_tpu.data import read_dataset as jax_read_dataset
from psvi_tpu.inference.psvi import PSVI as JPSVI
from test_torch_lifecycle import _check_step_against_jax
from torch_jax_tape import feed, record

TOY = dict(method="psvi_learn_v", num_pseudo=8, mc_samples=4, inner_it=3, data_minibatch=32,
           init_sd=1e-3, architecture="fn", n_hidden=8, num_epochs=1, log_every=1000, seed=2,
           init_args="custom", pretrain_epochs=1)
NINE = dict(mfvi_selection_method="kmeans", pretrain_epochs=2, load_from_saved=True,
            multiple_pts_per_cluster=False, alpha_dirichlet=0.5, choose_difficult=False,
            distance_fn="cosine", last_layer_only=True, loaded_from_psvi=False)


def engines(monkeypatch, **kw):
    """A JAX engine whose pseudodata init runs with its draws recorded, and
    a port engine built on them."""
    box = {}
    real = JPSVI._init_pseudodata

    def init_pseudodata(self, key):
        with pytest.MonkeyPatch.context() as mp:
            box["tape"] = record(mp)
            return real(self, key)

    with monkeypatch.context() as mp:
        mp.setattr(JPSVI, "_init_pseudodata", init_pseudodata)
        jeng = JPSVI(jax_read_dataset("four_blobs"), fused_inner=False, **{**TOY, **kw})
    with monkeypatch.context() as mp:
        feed(mp, box["tape"])
        peng = PSVI(read_dataset("four_blobs"), device="cpu", **{**TOY, **kw})
    assert all(n == 0 for n in box["tape"].sizes().values()), box["tape"].sizes()
    return jeng, peng


@pytest.mark.parametrize("method", ["kmeans", "entropy"])
def test_custom_init_matches_jax(monkeypatch, method):
    jeng, peng = engines(monkeypatch, mfvi_selection_method=method)
    assert peng.chosen_indices == [int(i) for i in jeng.chosen_indices]
    assert len(set(peng.chosen_indices)) == 8
    for k in ("u", "z", "v"):
        np.testing.assert_array_equal(getattr(peng.state, k).numpy(),
                                      np.asarray(getattr(jeng.state, k)), err_msg=k)
    np.testing.assert_array_equal(peng.state.v.numpy(),
                                  np.random.default_rng(2).standard_normal(8).astype(np.float32))
    _check_step_against_jax(jeng, peng, jax.random.PRNGKey(5))


def test_custom_init_soft_labels_start_one_hot(monkeypatch):
    jeng, peng = engines(monkeypatch, mfvi_selection_method="kmeans", learn_z=True)
    assert peng.state.z.shape == (8, 4)
    np.testing.assert_array_equal(peng.state.z.numpy(), np.asarray(jeng.state.z))


@pytest.mark.parametrize("method", ["kmeans", "kmeans_gradient", "submodular", "random",
                                    "least_confidence", "entropy", "el2n", "forgetting",
                                    "scored_kmeans_entropy", "scored_random_least_confidence",
                                    "weighted_kmeans"])
def test_every_score_method_takes_a_fused_step(method):
    eng = PSVI(read_dataset("four_blobs"), device="cpu", fused_inner=True,
               **{**TOY, "mfvi_selection_method": method})
    assert eng._step.__name__ == "_nested_step_fused"
    assert len(eng.chosen_indices) == eng.state.u.shape[0] == 8
    state, aux = eng._step(eng.state)
    assert torch.isfinite(aux["outer_loss"]) and not torch.equal(state.v, eng.state.v)


def test_nine_options_reach_coreset_select(monkeypatch):
    seen = {}

    class Capture(PS.CoresetSelect):
        def __init__(self, *a, **kw):
            seen.update(kw)
            super().__init__(*a, **{**kw, "load_from_saved": False})

    monkeypatch.setattr(PS, "CoresetSelect", Capture)
    eng = PSVI(read_dataset("four_blobs"), device="cpu", **{**TOY, **NINE})
    renamed = {"mfvi_selection_method": "score_method"}
    for k, v in NINE.items():
        assert getattr(eng, k) == v
        assert seen[renamed.get(k, k)] == v, k
    # the parallel options are ported (queue A item 11): none is refused by
    # name, shard_mc takes JAX's error without a mesh
    assert not hasattr(PP, "_UNPORTED")
    for k in ("shard_batch", "stream_data"):
        assert getattr(PSVI(read_dataset("four_blobs"), device="cpu", **{**TOY, k: True}),
                       "stream_data") == (k == "stream_data")
    with pytest.raises(ValueError, match="shard_mc"):
        PSVI(read_dataset("four_blobs"), device="cpu", **{**TOY, "shard_mc": True})
