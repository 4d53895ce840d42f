"""The port's multi-rank paths against JAX's unsharded step: one spawn of two
gloo ranks on the CPU (``psvi_torch.parallel.distributed.spawn``) runs
every check of ``tests/torch_dist_worker.py`` and sends the results back:

- a nested step with ``shard_batch`` (psvi_alpha_v, 16 + 16 rows) and with
  ``shard_mc`` (psvi_learn_v, 4 + 4 samples), each on JAX's whole batch and
  noise from JAX's state, against JAX's unsharded ``_nested_step``: the
  loss and inner losses at rtol 1e-4, the hypergradients (after their mean
  over the axis) at cosine > 0.9999 and max|Δ| ≤ 1e-3·max|ref| (α, one
  number, at rtol 1e-3 against the same step unsharded and at
  ``test_torch_engine.py``'s 0.05 against JAX), u, v and the parameters as
  ``test_torch_engine.py`` holds the unsharded step; then the evaluation
  of JAX's next state on JAX's evaluation noise: the accuracy equal, the
  NLL and the IW diagnostics at rtol 1e-4. Both ranks return the same
  numbers;
- ``run_mfvi(mesh=..., shard_batch=True)`` against the unsharded run from
  one seed (JAX's ``tests/test_parallel.py`` tolerances: accuracies atol
  1e-6, ELBOs rtol 1e-4);
- 3 trials over a trial axis of 2 (padded to 4, two a rank): every rank
  returns the 3 requested trials, equal to one process running all three
  (accuracies atol 1e-6, NLLs rtol 1e-5);
- the body of ``dryrun_multichip(2)`` (``_dryrun_rank``) in each rank;
- each rank's slice of an identical host array (``make_global_array``)
  and of a tree (``shard_pytree_leading``), as JAX's sharding helpers
  place it.

The ``shard_mc`` validation errors, ``initialize_distributed`` in one
process, the mesh's size check and both fused gates' refusal of a sharded
batch and of sharded samples (on a one-rank axis) need no second rank.
"""

import torch_threads  # noqa: F401  (torch on this worker's share of the cores)

import types

import jax
import numpy as np
import pytest
import torch

from psvi_torch.data import read_dataset
from psvi_torch.inference.psvi import PSVI
from psvi_torch.ops import fused_lenet as FL
from psvi_torch.ops import fused_nested as FN
from psvi_torch.parallel.distributed import initialize_distributed, spawn
from psvi_torch.parallel.mesh import make_mesh
from psvi_torch.parallel.trials import TrialParallelPSVI
from psvi_torch.utils.convert import params_from_jax, state_from_jax
from psvi_tpu.data import read_dataset as jax_read_dataset
from psvi_tpu.inference.psvi import PSVI as JPSVI
from test_torch_engine import _cos, _jax_nested_step, _np_tree
from torch_dist_worker import run_checks

NET = dict(num_pseudo=8, architecture="fn", n_hidden=16, inner_it=3, num_epochs=2,
           data_minibatch=32, log_every=1, init_sd=1e-3, seed=0)
SHARDED = {"shard_batch": ("psvi_alpha_v", "data", 4), "shard_mc": ("psvi_learn_v", "mc", 8)}
MFVI_KW = dict(nc=2, architecture="fn", n_hidden=16, mc_samples=4, data_minibatch=32,
               num_epochs=5, log_every=2, mul_fact=1, seed=0, lr0net=1e-3)
TRIAL_KW = dict(method="psvi_learn_v", num_pseudo=6, mc_samples=4,
                architecture="logistic_regression", inner_it=2, num_epochs=4,
                data_minibatch=32, log_every=2, init_sd=1e-3)


def _t(x):
    return torch.tensor(np.asarray(x))


def _jax_case(method, axis, S):
    """JAX's unsharded nested step and evaluation, with the draws they took,
    as a case for the ranks."""
    kw = dict(NET, method=method, mc_samples=S)
    jeng = JPSVI(jax_read_dataset("halfmoon"), fused_inner=False, **kw)
    key = jax.random.PRNGKey(5)
    k_batch, k_inner, k_outer = jax.random.split(key, 3)
    xb, yb = jeng._sample_batch(k_batch)
    eps_inner = [params_from_jax(_np_tree(jeng._sample_eps(k, S)), device="cpu")
                 for k in jax.random.split(k_inner, jeng.inner_it)]
    eps_outer = params_from_jax(_np_tree(jeng._sample_eps(k_outer, S)), device="cpu")
    jstate0 = _np_tree(jeng.state)
    jstate1, jaux, jgrads = _jax_nested_step(jeng, key, (xb, yb))
    k_eval = jax.random.PRNGKey(11)
    n_test, B = int(jeng.x_test.shape[0]), min(jeng.data_minibatch, int(jeng.x_test.shape[0]))
    n_batches = -(-n_test // B)
    eval_eps = [params_from_jax(_np_tree(jeng._sample_eps(k, jeng.mc_samples_eval)), device="cpu")
                for k in jax.random.split(k_eval, n_batches)]
    jeval = [float(x) for x in jeng._evaluate_fn(jstate1, k_eval, True)]
    case = {"check": "sharded_step", "axis": axis, "dataset": "halfmoon", "kw": kw,
            "state0": state_from_jax(jstate0, device="cpu"),
            "state1": state_from_jax(_np_tree(jstate1), device="cpu"),
            "batch": (_t(xb), _t(yb)), "eps": (eps_inner, eps_outer), "eval_eps": eval_eps}
    ref = {"loss": float(jaux["outer_loss"]), "inner_losses": np.asarray(jaux["inner_losses"]),
           "state1": _np_tree(jstate1), "grads": jgrads, "eval": jeval}
    return case, ref


@pytest.fixture(scope="module")
def ranks():
    """Both ranks' results of every check, and the JAX references."""
    cases, refs = {}, {}
    for name, (method, axis, S) in SHARDED.items():
        cases[name], refs[name] = _jax_case(method, axis, S)
    cases["mfvi"] = {"check": "mfvi", "dataset": "halfmoon", "kw": MFVI_KW}
    cases["trials"] = {"check": "trials", "dataset": "halfmoon", "num_trials": 3,
                       "kw": TRIAL_KW}
    cases["dryrun"] = {"check": "dryrun"}
    cases["helpers"] = {"check": "helpers"}
    out = spawn(run_checks, 2, cases, backend="gloo", timeout=600)
    return out, refs


def _same_on_both_ranks(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same_on_both_ranks(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_on_both_ranks(x, y)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(SHARDED))
def test_sharded_step_matches_jax_unsharded(ranks, name):
    out, refs = ranks
    got, ref = out[0][name], refs[name]
    _same_on_both_ranks(got, out[1][name])
    assert got["batch_rows"] == NET["data_minibatch"]  # 32 rounds to itself over 2
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["inner_losses"], ref["inner_losses"], rtol=1e-4)
    assert set(got["grads"]) == set(ref["grads"])
    for k, g in got["grads"].items():
        if k == "alpha":
            # α against the same step unsharded at 1e-3, and against JAX at
            # test_torch_engine.py's rtol 0.05 (JAX's own fp32 spread: the
            # port's unsharded step lies 3.4e-3 from it here)
            np.testing.assert_allclose(g, got["grads_unsharded"][k], rtol=1e-3)
            np.testing.assert_allclose(g, ref["grads"][k], rtol=0.05)
            continue
        assert _cos(g, ref["grads"][k]) > 0.9999, k
        assert np.abs(g - ref["grads"][k]).max() <= 1e-3 * np.abs(ref["grads"][k]).max(), k
    s1 = ref["state1"]
    np.testing.assert_allclose(got["u"], np.asarray(s1.u), atol=1e-6)
    np.testing.assert_allclose(got["v"], np.asarray(s1.v), atol=1e-5)
    np.testing.assert_allclose(got["alpha"], np.asarray(s1.alpha), atol=1e-5)
    for tp, jp in zip(got["params"], s1.params):
        for k in tp:
            np.testing.assert_allclose(tp[k], np.asarray(jp[k]), rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("name", sorted(SHARDED))
def test_sharded_evaluation_matches_jax(ranks, name):
    out, refs = ranks
    got, ref = out[0][name]["eval"], refs[name]["eval"]
    assert got[0] == ref[0]
    np.testing.assert_allclose(got[1:], ref[1:], rtol=1e-4)


def test_mfvi_batch_sharded_equals_unsharded(ranks):
    out, _ = ranks
    _same_on_both_ranks(out[0]["mfvi"], out[1]["mfvi"])
    res = out[0]["mfvi"]
    np.testing.assert_allclose(res["accs"][1], res["accs"][0], atol=1e-6)
    np.testing.assert_allclose(res["nlls"][1], res["nlls"][0], rtol=1e-4)
    np.testing.assert_allclose(res["elbos"][1], res["elbos"][0], rtol=1e-4)
    assert len(res["elbos"][0]) == MFVI_KW["num_epochs"]


def test_trials_over_two_ranks_pad_and_match_one_process(ranks):
    out, _ = ranks
    assert [o["trials"]["local"] for o in out] == [[0, 1], [2, 3]]
    assert all(o["trials"]["padded"] == 4 for o in out)
    one = TrialParallelPSVI(read_dataset("halfmoon"), 3, device="cpu", **TRIAL_KW).run()
    for o in out:
        res = o["trials"]["results"]
        assert len(res) == 3
        for a, b in zip(res, one):
            assert len(a["accs"]) == 2 and np.isfinite(a["accs"]).all()
            np.testing.assert_allclose(a["accs"], b["accs"], atol=1e-6)
            np.testing.assert_allclose(a["nlls"], b["nlls"], rtol=1e-5)


def test_each_rank_takes_its_slice(ranks):
    out, _ = ranks
    x = np.arange(12.0).reshape(6, 2)
    for r, o in enumerate(out):
        h = o["helpers"]
        np.testing.assert_array_equal(h["rows"], x[3 * r:3 * r + 3])
        np.testing.assert_array_equal(h["replicated"], x)
        np.testing.assert_array_equal(h["batch"], np.arange(6)[3 * r:3 * r + 3])
        np.testing.assert_array_equal(h["same"], np.arange(6))
        np.testing.assert_array_equal(h["trials"], [2 * r, 2 * r + 1])
        np.testing.assert_array_equal(h["tree"]["a"].numpy(), [2 * r, 2 * r + 1])
        assert h["tree"]["b"][0].shape == (1, 3)


def test_dryrun_multichip_ranks(ranks):
    out, _ = ranks
    assert out[0]["dryrun"] == out[1]["dryrun"]
    d = out[0]["dryrun"]
    assert len(d["trial_accs"]) == 4
    assert all(np.isfinite(v) for k, v in d.items() if k != "trial_accs")


def test_shard_mc_validation():
    data = read_dataset("halfmoon")
    with pytest.raises(ValueError, match="mc"):
        PSVI(data, method="psvi_learn_v", num_pseudo=8, mc_samples=8, shard_mc=True,
             device="cpu")
    # a mesh of 4 ranks on its mc axis, as the engine reads one: 6 samples do
    # not divide over it (no process group is needed to refuse)
    mesh = types.SimpleNamespace(mesh_dim_names=("trial", "data", "mc"),
                                 size=lambda i: (1, 1, 4)[i])
    with pytest.raises(ValueError, match="divisible"):
        PSVI(data, method="psvi_learn_v", num_pseudo=8, mc_samples=6, mesh=mesh,
             shard_mc=True, device="cpu")


def test_one_process_needs_no_process_group(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed("gloo") is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert initialize_distributed("nccl") is False
    # the trial runner's default mesh works without torchrun's environment
    assert make_mesh(trial=1).mesh_dim_names == ("trial", "data", "mc")
    with pytest.raises(ValueError, match=r"mesh \(1x2x1\) needs 2 devices, have 1"):
        make_mesh(data=2)


@pytest.mark.parametrize("shard", ["shard_batch", "shard_mc"])
def test_gates_refuse_sharded_steps(shard):
    # a one-rank axis is still a sharded mode: both gates refuse it, as JAX's
    # do, and fused_inner=True raises
    mesh = make_mesh()
    dense = dict(num_pseudo=8, mc_samples=4, architecture="fn", n_hidden=8, inner_it=2,
                 data_minibatch=32, device="cpu")
    lenet = dict(num_pseudo=4, mc_samples=2, architecture="lenet", inner_it=2,
                 data_minibatch=8, device="cpu")
    for name, kw, gate in (("four_blobs", dense, FN.supports), ("synth_mnist", lenet, FL.supports)):
        data = read_dataset(name)
        assert gate(PSVI(data, **kw))
        eng = PSVI(data, mesh=mesh, **{shard: True}, **kw)
        assert not gate(eng) and eng._step.__name__ == "_nested_step"
        with pytest.raises(ValueError, match="fused_inner=True"):
            PSVI(data, mesh=mesh, fused_inner=True, **{shard: True}, **kw)
