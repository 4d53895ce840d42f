"""The port's coreset lifecycle against the JAX engine.

- ``prune_coreset`` on JAX's kept indices (recovered from u's rows) gives
  JAX's pruned state leaf for leaf, bit for bit; then one step at the new M,
  plain (``_nested_step``) and fused (``_nested_step_fused``, its plain
  versions on the CPU), matches the jitted JAX step on injected batch and
  noise, at the tolerances of ``tests/test_torch_engine.py``.
- The incremental coreset on four_blobs: the first task (classes {0, 1})
  and its pseudodata init, ``increment_coreset``'s new points (NumPy's
  ``default_rng(seed + increment_idx)``, draw for draw),
  ``_advance_increment_task`` on JAX's replay indices (train and test
  sets), then one step at three classes against JAX's.
- A checkpoint resumes ``run_psvi`` bit for bit, the step counts come back
  as ints, and a checkpoint of another M or of another package raises.
- A results file written by the JAX package's ``save_results`` (its nested
  defaultdicts included) loads here; ``load_saved_coreset`` then gives
  JAX's u, z, v and α, ablated and not.
- ``pred_on_grid`` on JAX's noise matches JAX's grid.
- ``init_dataset`` (classifier and regressor) and ``init_args='saved'``
  draw JAX's pseudodata.
- ``reseed`` after a pruned or an incremental run restores M, the class
  count, the first task and the first state; a shape the fused gate
  refuses raises under ``fused_inner=True``; ``log_pseudodata`` and
  ``profile_dir`` runs.
"""

import torch_threads  # noqa: F401  (torch on this worker's share of the cores)

import json
import os

import jax
import numpy as np
import pytest
import torch

from psvi_torch.data import read_dataset, read_regression_dataset
from psvi_torch.inference.psvi import PSVI, PSVIRegressor
from psvi_torch.utils.convert import params_from_jax, state_from_jax
from psvi_torch.utils.results import load_results, recursive_dict
from psvi_tpu.data import read_dataset as jax_read_dataset
from psvi_tpu.data import read_regression_dataset as jax_read_regression_dataset
from psvi_tpu.inference.psvi import PSVI as JPSVI
from psvi_tpu.inference.psvi import PSVIRegressor as JPSVIRegressor
from psvi_tpu.utils import results as jresults
from test_torch_engine import _capture_hypergrads, _cos, _jax_nested_step, _np_tree

TOY = dict(method="psvi_learn_v", num_pseudo=8, mc_samples=4, inner_it=3, data_minibatch=32,
           init_sd=1e-3, architecture="fn", n_hidden=8, num_epochs=1, log_every=1000, seed=0)


def _assert_tree_equal(a, b, path="state"):
    """Bit for bit, dicts matched by key (JAX sorts a dict's keys)."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        names = getattr(a, "_fields", range(len(a)))
        for name, x, y in zip(names, a, b):
            _assert_tree_equal(x, y, f"{path}.{name}")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert type(a) is type(b) and a == b, path


def _check_step_against_jax(jeng, peng, key):
    """One JAX nested step (jitted) from the JAX engine's state, and the
    port's plain and fused steps from the same state on its batch and
    noise: the tolerances of tests/test_torch_engine.py (dense nets)."""
    k_batch, k_inner, k_outer = jax.random.split(key, 3)
    xb, yb = jeng._sample_batch(k_batch)
    eps_inner = [_np_tree(jeng._sample_eps(k, jeng.mc_samples))
                 for k in jax.random.split(k_inner, jeng.inner_it)]
    eps_outer = _np_tree(jeng._sample_eps(k_outer, jeng.mc_samples))
    jstate0 = _np_tree(jeng.state)
    jstate1, jaux, jgrads = _jax_nested_step(jeng, key, (xb, yb))
    pgrads = _capture_hypergrads(peng)
    batch = (torch.tensor(np.asarray(xb)), torch.tensor(np.asarray(yb)))
    eps = ([params_from_jax(e, device="cpu") for e in eps_inner],
           params_from_jax(eps_outer, device="cpu"))
    for step in (peng._nested_step, peng._nested_step_fused):
        s1, aux = step(state_from_jax(jstate0, device="cpu"), batch=batch, eps=eps)
        assert set(pgrads) == set(jgrads) == {"u", "v"}
        for k in jgrads:
            assert _cos(pgrads[k], jgrads[k]) > 0.999, (step.__name__, k)
            assert (np.abs(pgrads[k] - jgrads[k]).max()
                    <= 1e-2 * np.abs(jgrads[k]).max()), (step.__name__, k)
        np.testing.assert_allclose(float(aux["outer_loss"]), float(jaux["outer_loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(aux["inner_losses"].numpy(),
                                   np.asarray(jaux["inner_losses"]), rtol=2e-5)
        np.testing.assert_allclose(s1.u.numpy(), np.asarray(jstate1.u), atol=1e-6)
        np.testing.assert_allclose(s1.v.numpy(), np.asarray(jstate1.v), atol=1e-5)
        for tp, jp in zip(s1.params, jstate1.params):
            for k in tp:
                np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=2e-4,
                                           atol=1e-6)


def test_prune_coreset_matches_jax():
    jeng = JPSVI(jax_read_dataset("four_blobs"), fused_inner=False, **TOY)
    jeng.state, _ = jeng._step(jeng.state, jax.random.PRNGKey(1))  # v, Adam states ≠ 0
    before = _np_tree(jeng.state)
    jeng.prune_coreset(5)
    after = _np_tree(jeng.state)
    # JAX's kept indices, from u's rows (distinct data points)
    keep = [int(np.flatnonzero((np.asarray(before.u) == row).all(1))[0])
            for row in np.asarray(after.u)]
    assert len(set(keep)) == 5
    peng = PSVI(read_dataset("four_blobs"), device="cpu", **TOY)
    peng.state = state_from_jax(before, device="cpu")
    peng.prune_coreset(5, keep=keep)
    _assert_tree_equal(peng.state, state_from_jax(after, device="cpu"))
    assert peng.num_pseudo == jeng.num_pseudo == 5
    _check_step_against_jax(jeng, peng, jax.random.PRNGKey(3))


def test_increment_coreset_matches_jax():
    kw = {**TOY, "increment": True, "increment_sizes": (4, 6, 8), "increment_interval": 1}
    jeng = JPSVI(jax_read_dataset("four_blobs"), fused_inner=False, **kw)
    peng = PSVI(read_dataset("four_blobs"), device="cpu", **kw)
    # the first task: classes {0, 1}, M = 4, drawn from that task's train set
    assert peng.nc == jeng.nc == 2 and peng.num_pseudo == jeng.num_pseudo == 4
    assert peng.N == jeng.N == read_dataset("four_blobs").N
    for k in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(peng, k).numpy(), np.asarray(getattr(jeng, k)))
    assert peng.data_minibatch == jeng.data_minibatch
    assert peng.train_data_so_far == jeng.train_data_so_far
    np.testing.assert_array_equal(peng.state.u.numpy(), np.asarray(jeng.state.u))
    assert peng.chosen_indices == jeng.chosen_indices
    # the run loop's increment: nc + 1, the net rebuilt and reset, the
    # replay drawn over the pre-increment weights, then the new points
    jeng.state, _ = jeng._step(jeng.state, jax.random.PRNGKey(1))
    jeng.nc += 1
    jeng._build_model()
    jeng.weight_reset()
    replay = np.array(jeng.sample_replay_indices(jax.random.PRNGKey(5)))
    before = _np_tree(jeng.state)
    jeng.increment_coreset(6, new_class=2, increment_idx=1)
    after = _np_tree(jeng.state)
    peng.nc += 1
    peng._build_model()
    peng.state = state_from_jax(before, device="cpu")
    peng.increment_coreset(6, new_class=2, increment_idx=1)
    _assert_tree_equal(peng.state, state_from_jax(after, device="cpu"))
    jeng._advance_increment_task(1, replay)
    peng._advance_increment_task(1, replay)
    for k in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(peng, k).numpy(), np.asarray(getattr(jeng, k)))
    assert (peng.n_train_now, peng.train_data_so_far, peng.data_minibatch) == (
        jeng.n_train_now, jeng.train_data_so_far, jeng.data_minibatch)
    assert set(np.unique(peng.y_test.numpy())) == {0.0, 1.0, 2.0}
    _check_step_against_jax(jeng, peng, jax.random.PRNGKey(7))


def test_checkpoint_resume_is_bit_exact(tmp_path):
    data = read_dataset("halfmoon")
    kw = dict(method="psvi_alpha_v", num_pseudo=8, mc_samples=4, inner_it=3,
              data_minibatch=32, num_epochs=3, log_every=2, seed=0, device="cpu",
              fused_inner=True)
    eng = PSVI(data, **kw)
    eng.run_psvi()
    path = str(tmp_path / "ckpt")  # the .npz suffix is added
    eng.save_checkpoint(path)
    assert os.path.exists(path + ".npz")
    res = eng.run_psvi()
    fresh = PSVI(data, **kw)
    fresh.load_checkpoint(path + ".npz")
    assert fresh.state.net_step == 3 and type(fresh.state.net_step) is int
    assert type(fresh.state.opt_u.count) is int and fresh.state.opt_u.count == 3
    res_fresh = fresh.run_psvi()
    _assert_tree_equal(fresh.state, eng.state)
    assert res_fresh["accs"] == res["accs"] and res_fresh["nlls"] == res["nlls"]
    with pytest.raises(ValueError, match="shape"):
        PSVI(data, **{**kw, "num_pseudo": 10}).load_checkpoint(path)
    # a file of the JAX package's layout holds no generator state
    with np.load(path + ".npz") as d:
        np.savez(tmp_path / "other.npz", **{k: d[k] for k in d.files if k.startswith("leaf_")})
    with pytest.raises(ValueError, match="generator"):
        PSVI(data, **kw).load_checkpoint(str(tmp_path / "other.npz"))


@pytest.mark.parametrize("ablated,learn_z", [(True, False), (False, False), (False, True)])
def test_load_saved_coreset_matches_jax(tmp_path, ablated, learn_z):
    rng = np.random.default_rng(11)
    data = read_dataset("halfmoon")
    M = 8
    chosen = rng.choice(data.N, size=M, replace=False)
    run = {"accs": [0.5, 0.8], "chosen_indices": [int(i) for i in chosen],
           "vs": [np.zeros(M, np.float32), rng.standard_normal(M).astype(np.float32)],
           "alpha": [np.zeros(1, np.float32), np.array([0.3], np.float32)],
           "zs": [np.asarray(data.y[chosen], np.float32),
                  rng.integers(0, 2, M).astype(np.float32)],
           "us": [np.asarray(data.x[chosen], np.float32)] * 2}
    # the JAX package's own nested defaultdicts, pickled by its save_results
    results = jresults.recursive_dict()
    results["halfmoon"]["psvi_alpha_v"][M][0] = run
    jresults.save_results(results, str(tmp_path / "run1"), config={"num_epochs": 2})
    loaded = load_results(str(tmp_path / "run1"))
    assert loaded.default_factory is recursive_dict
    assert loaded["halfmoon"]["psvi_alpha_v"][M][0]["accs"] == run["accs"]
    kw = dict(method="psvi_alpha_v", num_pseudo=M, mc_samples=4, inner_it=3, seed=2,
              results_folder=str(tmp_path), learn_z=learn_z)
    flags = dict(ablated_weights=ablated, ablated_alpha=ablated, ablated_labels=ablated)
    jeng = JPSVI(jax_read_dataset("halfmoon"), fused_inner=False, **kw)
    peng = PSVI(data, device="cpu", **kw)
    peng.state = state_from_jax(_np_tree(jeng.state), device="cpu")  # the same net
    jeng.load_saved_coreset("run1", "halfmoon", "psvi_alpha_v", M, **flags)
    peng.load_saved_coreset("run1", "halfmoon", "psvi_alpha_v", M, **flags)
    assert peng.chosen_indices == jeng.chosen_indices
    _assert_tree_equal(peng.state, state_from_jax(_np_tree(jeng.state), device="cpu"))
    if not ablated:
        np.testing.assert_array_equal(peng.state.v.numpy(), run["vs"][-1])


def test_pred_on_grid_matches_jax():
    jeng = JPSVI(jax_read_dataset("four_blobs"), fused_inner=False, **TOY)
    rng = np.random.default_rng(0)
    jstate = _np_tree(jeng.state)
    params = jax.tree_util.tree_map(
        lambda a: (0.5 * rng.standard_normal(a.shape)).astype(np.float32), jstate.params)
    v = rng.standard_normal(jstate.v.shape).astype(np.float32)
    jeng.state = jeng.state._replace(params=jax.tree_util.tree_map(jax.numpy.asarray, params),
                                     v=jax.numpy.asarray(v))
    # the noise JAX's pred_on_grid draws from its key
    _, k = jax.random.split(jeng.key)
    eps = params_from_jax(_np_tree(jeng.net.sample_eps(k, jeng.mc_samples_eval)), device="cpu")
    jgrid = jeng.pred_on_grid(n_test_per_dim=40)
    peng = PSVI(read_dataset("four_blobs"), device="cpu", **TOY)
    peng.state = state_from_jax(_np_tree(jeng.state), device="cpu")
    pgrid = peng.pred_on_grid(n_test_per_dim=40, eps=eps)
    assert pgrid.shape == jgrid.shape == (4, 1600)
    assert np.abs(pgrid - jgrid).max() <= 1e-5 * np.abs(jgrid).max()


@pytest.mark.parametrize("case", ["classifier init_dataset", "classifier saved",
                                  "regressor init_dataset"])
def test_init_pool_matches_jax(case):
    rng = np.random.default_rng(4)
    if case.startswith("regressor"):
        pdata, jdata = read_regression_dataset("sinus"), jax_read_regression_dataset("sinus")
        pcls, jcls, method = PSVIRegressor, JPSVIRegressor, "psvi_learn_v_regressor"
        kw = dict(architecture="regressor_net", n_hidden=8)
    else:
        pdata, jdata = read_dataset("halfmoon"), jax_read_dataset("halfmoon")
        pcls, jcls, method = PSVI, JPSVI, "psvi_learn_v"
        kw = {}
    kw.update(method=method, num_pseudo=8, mc_samples=4, inner_it=3, seed=3)
    if case.endswith("init_dataset"):  # a disturbed copy of the train set
        x = (pdata.x + 0.1 * rng.standard_normal(pdata.x.shape)).astype(np.float32)
        kw["init_dataset"] = (x, pdata.y)
    else:
        kw["init_args"] = "saved"
    jeng = jcls(jdata, fused_inner=False, **kw)
    peng = pcls(pdata, device="cpu", **kw)
    np.testing.assert_array_equal(peng.state.u.numpy(), np.asarray(jeng.state.u))
    np.testing.assert_array_equal(peng.state.z.numpy(), np.asarray(jeng.state.z))
    assert peng.chosen_indices == jeng.chosen_indices
    if "init_dataset" in kw:  # the points come from the pool, not the train set
        assert not np.isin(peng.state.u.numpy()[:, 0], pdata.x[:, 0]).all()


@pytest.mark.parametrize("mode", ["prune", "increment"])
def test_reseed_restores_the_first_state(mode):
    data = read_dataset("four_blobs")
    kw = {**TOY, "device": "cpu", "fused_inner": True, "num_epochs": 7}
    if mode == "prune":
        kw.update(prune=True, prune_interval=2, prune_sizes=(6, 4))
    else:
        kw.update(increment=True, increment_sizes=(4, 6, 8), increment_interval=3)
    eng = PSVI(data, **kw)
    res = eng.run_psvi()
    if mode == "prune":
        assert res["csizes"] == [8] and eng.state.u.shape == (4, 2) and eng.num_pseudo == 4
    else:
        assert eng.nc == 4 and eng.state.u.shape == (8, 2)
        assert set(np.unique(eng.y_test.numpy())) == {0.0, 1.0, 2.0, 3.0}
    assert eng._step.__name__ == "_nested_step_fused"
    eng.reseed(0)
    first = PSVI(data, **kw)
    _assert_tree_equal(eng.state, first.state)
    assert (eng.num_pseudo, eng.nc, eng.n_train_now) == (first.num_pseudo, first.nc,
                                                          first.n_train_now)
    assert torch.equal(eng.x_train, first.x_train) and torch.equal(eng.y_test, first.y_test)
    assert eng.results == {} and eng.elbos == []


def test_fused_gate_rechecked_after_a_change_of_shape():
    data = read_dataset("four_blobs")
    kw = {**TOY, "device": "cpu", "data_minibatch": 128}
    # fused_inner=True raises where the gate refuses (M + B > 2048), as at
    # construction
    eng = PSVI(data, fused_inner=True, **kw)
    with pytest.raises(ValueError, match="fused_inner=True"):
        eng.increment_coreset(1930, new_class=3, increment_idx=1)
    with pytest.raises(ValueError, match="fused_inner=True"):
        PSVI(data, fused_inner=True, **{**kw, "num_pseudo": 1930})
    # "auto" re-chooses: the plain step on the CPU, at every M
    eng = PSVI(data, **kw)
    eng.prune_coreset(5)
    assert eng._step.__name__ == "_nested_step" and eng.state.u.shape == (5, 2)


def test_log_pseudodata_and_profile_dir_run(tmp_path):
    data = read_dataset("four_blobs")
    eng = PSVI(data, device="cpu", log_pseudodata=True, profile_dir=str(tmp_path / "prof"),
               dnm="four_blobs", **{**TOY, "num_epochs": 3, "log_every": 2})
    res = eng.run_psvi()
    assert len(res["us"]) == len(res["zs"]) == len(res["grid_preds"]) == 2
    assert res["us"][0].shape == (8, 2) and res["grid_preds"][0].shape == (4, 250 * 250)
    np.testing.assert_allclose(res["grid_preds"][-1].sum(0), 1.0, atol=1e-5)
    trace = tmp_path / "prof" / "psvi_four_blobs_0.trace.json"
    assert json.loads(trace.read_text())["traceEvents"]
