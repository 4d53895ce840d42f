"""The port's selection subsystem against the JAX package's, on four_blobs
(fn 2-8-4):

- one ``MeanFieldVI`` sweep from JAX's parameters on JAX's noise: the
  parameters within rtol 1e-5 and the losses within 1e-5; a whole
  pretraining run with the forgetting counters on JAX's draws: the same
  counters exactly; ``save``/``load`` across the packages;
- ``ScoreCalculator`` (rtol 1e-6), ``sample_multinomial`` (the same picks
  from the same NumPy stream), the CSV readers against JAX's on the files
  a scoring run writes;
- every ``CoresetSelect`` branch from a ``MeanFieldVI`` pretrained in JAX
  and carried across, with JAX's draws fed (the noise of the
  probabilities and embeddings, k-means++): the same indices and weights
  (rtol 1e-6); the loaded branches from the CSV files;
- ``RunFrequentistModel`` on JAX's init and minibatches: parameters, EL2N
  scores and test metrics within rtol 1e-5, the same largest-EL2N indices.
"""

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from psvi_torch.data import read_dataset
from psvi_torch.inference import selection as PS
from psvi_torch.models.frequentist import RunFrequentistModel as PFreq
from psvi_torch.utils.convert import model_state_from_jax, params_from_jax
from psvi_torch.utils.tree import tree_leaves
from psvi_tpu.inference import selection as JS
from psvi_tpu.models.frequentist import RunFrequentistModel as JFreq
from torch_jax_tape import feed, record

VI_ARGS = ("fn", 2, 8, 4)
VI_KW = dict(mc_samples=4, init_sd=1e-3, data_minibatch=256, num_epochs=1, lr0net=1e-2, seed=3,
             forgetting_score_flag=True)


@pytest.fixture(scope="module")
def blobs():
    return read_dataset("four_blobs")


@pytest.fixture(scope="module")
def pretrained(blobs):
    """A JAX ``MeanFieldVI`` pretrained (jitted) and its state carried into
    a port ``MeanFieldVI``."""
    d = blobs
    jvi = JS.MeanFieldVI(d.x, d.y, d.xt, d.yt, *VI_ARGS, **VI_KW)
    jvi.run()
    pvi = PS.MeanFieldVI(d.x, d.y, d.xt, d.yt, *VI_ARGS, **VI_KW, device="cpu")
    model_state_from_jax(jvi, pvi)
    pvi.forgetting_events = np.array(jvi.forgetting_events)
    return jvi, pvi


def _leaves_close(p, j, rtol):
    for a, b in zip(tree_leaves(p), jax.tree_util.tree_leaves(j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=rtol * max(np.abs(np.asarray(b)).max(), 1e-3))


def test_meanfieldvi_sweep_matches_jax(blobs):
    d = blobs
    jvi = JS.MeanFieldVI(d.x, d.y, d.xt, d.yt, *VI_ARGS, **VI_KW)
    pvi = PS.MeanFieldVI(d.x, d.y, d.xt, d.yt, *VI_ARGS, **VI_KW, device="cpu")
    model_state_from_jax(jvi, pvi)
    key = jax.random.PRNGKey(9)
    jp, jo, jl = jvi._train_sweep(jvi.params, jvi.opt_state, key)
    eps = [params_from_jax(jax.tree_util.tree_map(np.asarray, jvi.net.sample_eps(k, 4)), "cpu")
           for k in jax.random.split(key, jvi._n_batches)]
    assert pvi.n_batches == jvi._n_batches == 4 and d.N % 256 != 0  # a short last batch
    pp, po, pl = pvi._train_sweep(pvi.params, pvi.opt_state, eps=eps)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-5)
    _leaves_close(pp, jp, 1e-5)
    assert po.count == int(jo.count)
    _leaves_close(po.mu, jo.mu, 1e-5)


def test_meanfieldvi_forgetting_counters_match_jax(monkeypatch, blobs, tmp_path):
    d = blobs
    with monkeypatch.context() as mp:
        tape = record(mp)
        jvi = JS.MeanFieldVI(d.x, d.y, d.xt, d.yt, *VI_ARGS, **VI_KW)
        jvi.run()
    with monkeypatch.context() as mp:
        feed(mp, tape)
        pvi = PS.MeanFieldVI(d.x, d.y, d.xt, d.yt, *VI_ARGS, **VI_KW, device="cpu",
                             data_path=str(tmp_path), dnm="blobs")
        pvi.run()
    assert all(n == 0 for n in tape.sizes().values())
    np.testing.assert_array_equal(pvi.forgetting_events, jvi.forgetting_events)
    np.testing.assert_array_equal(pvi.never_learnt, jvi.never_learnt)
    assert pvi.forgetting_events.max() > 0
    _leaves_close(pvi.params, jvi.params, 1e-4)
    # the port's files load into JAX's MeanFieldVI, and back
    jl = JS.MeanFieldVI(d.x, d.y, d.xt, d.yt, *VI_ARGS, **VI_KW, data_path=str(tmp_path),
                        dnm="blobs")
    assert jl.load()
    _leaves_close(pvi.params, jl.params, 0.0)
    jl.save()
    pl = PS.MeanFieldVI(d.x, d.y, d.xt, d.yt, *VI_ARGS, **VI_KW, device="cpu",
                        data_path=str(tmp_path), dnm="blobs", load_from_saved=True)
    pl.run()  # loads, does not train
    _leaves_close(pl.params, jl.params, 0.0)
    assert not PS.MeanFieldVI(d.x, d.y, d.xt, d.yt, *VI_ARGS, **VI_KW, device="cpu",
                              data_path=str(tmp_path / "none")).load()


def test_scores_and_multinomial_match_jax():
    rng = np.random.default_rng(0)
    p = rng.dirichlet(np.ones(4), size=50).astype(np.float32)
    y = rng.integers(0, 4, 50).astype(np.float32)
    jc, pc = JS.ScoreCalculator(p, y, nc=4), PS.ScoreCalculator(torch.tensor(p), y, nc=4)
    for f in ("least_confidence_score", "entropy_score", "el2n_score"):
        np.testing.assert_allclose(getattr(pc, f)().numpy(), np.asarray(getattr(jc, f)()),
                                   rtol=1e-6, atol=1e-7, err_msg=f)
    for pv in (p[:, 0], np.full(50, np.nan)):
        picks = [SM.sample_multinomial(pv, 7, np.random.default_rng(4)) for SM in (JS, PS)]
        np.testing.assert_array_equal(picks[1], picks[0])


def test_csv_readers_match_jax(tmp_path):
    rng = np.random.default_rng(7)
    emb = rng.standard_normal((12, 4)).astype(np.float32)
    np.savetxt(tmp_path / "embedding_toy_0.csv", emb, delimiter=",")
    pd.DataFrame({k: rng.random(12) for k in ("el2n", "forgetting", "entropy",
                                              "least_confidence")}).to_csv(
        tmp_path / "score_psvi_toy_0.csv", index=False)
    np.testing.assert_array_equal(PS.load_embeddings_csv(str(tmp_path), "toy", 0),
                                  JS.load_embeddings_csv(str(tmp_path), "toy", 0))
    for col in ("el2n", "forgetting", "entropy", "least_confidence"):
        np.testing.assert_array_equal(PS.load_scores_csv(str(tmp_path), "toy", 0, col),
                                      JS.load_scores_csv(str(tmp_path), "toy", 0, col))


BRANCHES = ["kmeans", "kmeans_gradient", "submodular", "random", "least_confidence", "entropy",
            "el2n", "forgetting", "scored_kmeans_entropy", "scored_random_el2n",
            "weighted_kmeans"]


def _select_both(monkeypatch, pretrained, d, **kw):
    jvi, pvi = pretrained
    common = dict(num_pseudo=12, nc=4, architecture="fn", D=2, n_hidden=8, seed=3, **kw)
    with monkeypatch.context() as mp:
        tape = record(mp)
        mp.setattr(JS.Selection, "pretrain", lambda self, *a, **k: setattr(
            self, "pretrained_vi", jvi))
        jsel = JS.CoresetSelect(d.x, d.y, d.xt, d.yt, **common)
        jout = jsel.select_data()
    with monkeypatch.context() as mp:
        feed(mp, tape)
        mp.setattr(PS.Selection, "pretrain", lambda self, *a, **k: setattr(
            self, "pretrained_vi", pvi))
        psel = PS.CoresetSelect(d.x, d.y, d.xt, d.yt, **common, device="cpu")
        pout = psel.select_data()
    assert all(n == 0 for n in tape.sizes().values()), tape.sizes()
    assert pout[0] == [int(i) for i in jout[0]]
    np.testing.assert_array_equal(pout[1], jout[1])
    np.testing.assert_array_equal(pout[2], jout[2])
    np.testing.assert_allclose(pout[3], np.asarray(jout[3]), rtol=1e-6)
    assert psel.wt_index.keys() == jsel.wt_index.keys()
    return pout


@pytest.mark.parametrize("method", BRANCHES)
def test_coreset_select_branch_matches_jax(monkeypatch, pretrained, blobs, method):
    idx = _select_both(monkeypatch, pretrained, blobs, score_method=method)[0]
    assert len(set(idx)) == len(idx) > 0


@pytest.mark.parametrize("method", ["entropy", "kmeans", "scored_kmeans_el2n"])
def test_coreset_select_loaded_from_csv_matches_jax(monkeypatch, pretrained, blobs, tmp_path,
                                                    method):
    """``loaded_from_psvi``: the scores and embeddings of a scoring run."""
    rng = np.random.default_rng(1)
    np.savetxt(tmp_path / "embedding_blobs_3.csv", rng.standard_normal((blobs.N, 5)),
               delimiter=",")
    pd.DataFrame({k: rng.random(blobs.N) for k in ("el2n", "forgetting", "entropy",
                                                   "least_confidence")}).to_csv(
        tmp_path / "score_psvi_blobs_3.csv", index=False)
    _select_both(monkeypatch, pretrained, blobs, score_method=method, loaded_from_psvi=True,
                 data_folder=str(tmp_path), dnm="blobs")


def test_coreset_select_refuses_unknown_method(blobs):
    with pytest.raises(ValueError, match="not implemented"):
        PS.CoresetSelect(blobs.x, blobs.y, blobs.xt, blobs.yt, score_method="oracle",
                         device="cpu").select_data()


def test_frequentist_model_matches_jax(monkeypatch, blobs):
    d = blobs
    for is_logreg in (False, True):
        y = d.y if not is_logreg else (d.y > 1.5).astype(np.float32)
        yt = d.yt if not is_logreg else (d.yt > 1.5).astype(np.float32)
        kw = dict(num_classes=4 if not is_logreg else 2, is_logreg=is_logreg,
                  data_minibatch=128, num_epochs=2, seed=1)
        with monkeypatch.context() as mp:
            tape = record(mp)
            jm = JFreq(d.x, y, d.xt, yt, **kw)
            jm.train()
        with monkeypatch.context() as mp:
            feed(mp, tape)
            pm = PFreq(d.x, y, d.xt, yt, **kw, device="cpu")
            pm.train()
        assert all(n == 0 for n in tape.sizes().values())
        _leaves_close(pm.params, jm.params, 1e-5)
        np.testing.assert_allclose(pm.test(), jm.test(), rtol=1e-5)
        np.testing.assert_allclose(pm.get_el2n_scores(), jm.get_el2n_scores(), rtol=1e-5,
                                   atol=1e-6)
        assert pm.get_largest_el2n_indices(15) == jm.get_largest_el2n_indices(15)
