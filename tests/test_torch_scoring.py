"""The port's data-difficulty scoring run against the JAX engine.

- ``_train_set_mean_probs`` on JAX's per-batch noise matches JAX's.
- Fed the same probability arrays (``_train_set_mean_probs`` replaced on
  both engines), the forgetting calculator and ``_do_scoring`` write JAX's
  scores: the port's ``score_psvi_{dnm}_{seed}.csv`` (written without
  pandas) has JAX's header and values, read back with ``np.genfromtxt``;
  the embeddings on JAX's noise match JAX's
  ``embedding_{dnm}_{seed}.csv``.
- A scoring run through ``run_psvi`` writes both files, one row per
  train point.
"""

import torch_threads  # noqa: F401  (torch on this worker's share of the cores)

import jax
import numpy as np
import pytest

from psvi_torch.data import read_dataset
from psvi_torch.inference.psvi import PSVI
from psvi_torch.utils.convert import params_from_jax, state_from_jax
from psvi_tpu.data import read_dataset as jax_read_dataset
from psvi_tpu.inference.psvi import PSVI as JPSVI
from test_torch_engine import _np_tree

HEADER = ["el2n", "forgetting", "entropy", "least_confidence"]
KW = dict(method="psvi_learn_v", num_pseudo=8, mc_samples=4, inner_it=3, data_minibatch=32,
          init_sd=1e-3, architecture="fn", n_hidden=8, num_epochs=5, seed=1,
          scoring_run=True, dnm="four_blobs")


def _engines(tmp_path):
    """A JAX and a port engine on the same state, each writing into its own
    folder."""
    jeng = JPSVI(jax_read_dataset("four_blobs"), fused_inner=False,
                 data_folder=str(tmp_path / "jax"), **KW)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: (0.5 * rng.standard_normal(a.shape)).astype(np.float32),
        _np_tree(jeng.state.params))
    jeng.state = jeng.state._replace(params=jax.tree_util.tree_map(jax.numpy.asarray, params))
    peng = PSVI(read_dataset("four_blobs"), device="cpu", data_folder=str(tmp_path / "port"),
                **KW)
    peng.state = state_from_jax(_np_tree(jeng.state), device="cpu")
    return jeng, peng


@pytest.mark.parametrize("batch", [1024, 300])
def test_train_set_mean_probs_matches_jax(tmp_path, batch):
    jeng, peng = _engines(tmp_path)
    key = jax.random.PRNGKey(8)
    n = peng.n_train_now
    eps = [params_from_jax(_np_tree(jeng.net.sample_eps(jax.random.fold_in(key, i),
                                                        jeng.mc_samples_eval)), device="cpu")
           for i in range(0, n, batch)]
    jp = jeng._train_set_mean_probs(key, batch=batch)
    pp = peng._train_set_mean_probs(eps, batch=batch)
    assert pp.shape == jp.shape == (n, 4)
    np.testing.assert_allclose(pp, jp, rtol=1e-5, atol=1e-6)


def test_scores_and_embeddings_match_jax(tmp_path):
    jeng, peng = _engines(tmp_path)
    n = peng.n_train_now
    rng = np.random.default_rng(5)
    # five rounds of probabilities: the forgetting calculator's four, then
    # _do_scoring's
    rounds = [rng.dirichlet(np.ones(4), size=n).astype(np.float32) for _ in range(5)]
    jfeed, pfeed = iter(rounds), iter(rounds)
    jeng._train_set_mean_probs = lambda *a, **k: next(jfeed)
    peng._train_set_mean_probs = lambda *a, **k: next(pfeed)
    for _ in range(4):
        jeng._forgetting_calculator(jax.random.PRNGKey(0))
        peng._forgetting_calculator()
    np.testing.assert_array_equal(peng.forgetting_events, jeng.forgetting_events)
    np.testing.assert_array_equal(peng.never_learnt, jeng.never_learnt)
    assert peng.forgetting_events.max() >= 1  # some points were forgotten
    # the embeddings' noise JAX draws from its key
    emb_eps = [params_from_jax(_np_tree(jeng.net.sample_eps(
        jax.random.fold_in(jeng.key, 0xE2B + i), jeng.mc_samples_eval)), device="cpu")
        for i in range(0, n, 1024)]
    jeng._do_scoring(jax.random.PRNGKey(1))
    peng._do_scoring(emb_eps=emb_eps)
    name = "score_psvi_four_blobs_1.csv"
    js = np.genfromtxt(tmp_path / "jax" / name, delimiter=",", names=True)
    ps = np.genfromtxt(tmp_path / "port" / name, delimiter=",", names=True)
    assert list(ps.dtype.names) == list(js.dtype.names) == HEADER
    assert len(ps) == len(js) == n
    for col in HEADER:
        np.testing.assert_allclose(ps[col], js[col], rtol=1e-6, atol=1e-7, err_msg=col)
    name = "embedding_four_blobs_1.csv"
    je = np.loadtxt(tmp_path / "jax" / name, delimiter=",")
    pe = np.loadtxt(tmp_path / "port" / name, delimiter=",")
    assert pe.shape == je.shape == (n, 8)
    np.testing.assert_allclose(pe, je, rtol=1e-5, atol=1e-5 * np.abs(je).max())


def test_scoring_run_through_run_psvi(tmp_path):
    data = read_dataset("halfmoon")
    eng = PSVI(data, device="cpu", data_folder=str(tmp_path), fused_inner=True,
               **{**KW, "architecture": "logistic_regression", "dnm": "halfmoon",
                  "num_epochs": 3, "log_every": 2})
    calls = []
    calc = eng._forgetting_calculator
    eng._forgetting_calculator = lambda *a: calls.append(1) or calc(*a)
    eng.run_psvi()
    assert len(calls) == 3  # once before every step
    scores = np.genfromtxt(tmp_path / "score_psvi_halfmoon_1.csv", delimiter=",", names=True)
    assert list(scores.dtype.names) == HEADER and len(scores) == data.N
    assert np.isfinite(scores.view((float, 4))).all()
    assert (scores["forgetting"] >= 0).all() and (scores["forgetting"] <= 3).all()
    emb = np.loadtxt(tmp_path / "embedding_halfmoon_1.csv", delimiter=",")
    # logistic regression: the penultimate activations are the inputs, × S
    np.testing.assert_allclose(emb, eng.mc_samples_eval * data.x, rtol=1e-6)
