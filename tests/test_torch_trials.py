"""The port's trial runner (``psvi_torch/parallel/trials.py``) against JAX's
plain step, trial by trial.

- The vmapped step (``TrialParallelPSVI.vstep``) from JAX's stacked states
  (``state_from_jax`` of two trials' states, their step counts stacked),
  on each trial's JAX draws (its batch and noise, stacked), against JAX's
  plain step of each trial: the nested trainer on four_blobs fn 2-8-4
  (psvi_alpha_v, so that g_α passes vmap too) and the joint trainer on the
  same net; the regressor (sinus regressor_net, psvi_learn_v_regressor)
  against JAX's nested closure run in float64 (``test_torch_regressor.py``:
  JAX's own fp32 g_z lies up to 1e-2 off). The hypergradients are read from
  the hyper-Adam first moments (0.1·g after the first step): cosine >
  0.9999 and max|Δ| ≤ 1e-3·max|ref|, g_α at rtol 0.05 (its N-scaled sums
  cancel, ``test_torch_engine.py``); losses at rtol 1e-4; the joint step's
  moment at ``test_torch_first_order.py``'s 5e-3 (JAX's fp32 u and v
  gradients lie up to 3e-3 off float64) and its state as one Adam step
  from the same start.
- Every trainer of JAX's runner takes the vmapped step, each trial equal to
  a plain engine of that seed fed the trial's generator (alternating,
  hyper with each solver, truncated, psvi_evaluate, the LeNet toy):
  u, v, z and the net at atol 1e-5; the lifecycle flags, ``remat_inner``
  and ``backend="pallas"`` are refused by name.
- ``state_from_jax`` takes JAX's runner's stacked states, trial for trial.
- The runner: one trial alone equals that trial among three (atol 1e-6),
  a single-process run leaves no process group behind, chained equals
  unchained bit for bit, and ``fused_inner=True`` raises
  where the gates refuse the vmapped step, which both gates do.
"""

import torch_threads  # noqa: F401  (torch on this worker's share of the cores)

import jax
import numpy as np
import pytest
import torch

from psvi_torch.data import read_dataset, read_regression_dataset
from psvi_torch.inference.psvi import PSVI, PSVIRegressor
from psvi_torch.ops import fused_lenet as FL
from psvi_torch.ops import fused_nested as FN
from psvi_torch.parallel.trials import TrialParallelPSVI, index_tree, run_trials, stack_trees
from psvi_torch.utils.convert import params_from_jax, state_from_jax
from psvi_torch.utils.prng import step_keys, trial_generator, trial_seed
from psvi_tpu.data import read_dataset as jax_read_dataset
from psvi_tpu.data import read_regression_dataset as jax_read_regression_dataset
from psvi_tpu.inference.psvi import PSVI as JPSVI
from psvi_tpu.inference.psvi import PSVIRegressor as JPSVIRegressor
from test_torch_engine import _jax_nested_step, _np_tree
from test_torch_first_order import _assert_adam_step
from test_torch_regressor import KW as REG_KW
from test_torch_regressor import _agrees, _f64, _grads_agree

FN_KW = dict(num_pseudo=8, mc_samples=4, architecture="fn", n_hidden=8, inner_it=3,
             data_minibatch=32, init_sd=1e-3, num_epochs=4, log_every=2)


def _t(x):
    return torch.tensor(np.asarray(x))


def _port_runner(data, n, jstates, **kw):
    """The port's runner over ``n`` trials, its states JAX's, stacked."""
    tp = TrialParallelPSVI(data, n, device="cpu", **kw)
    stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *jstates)
    tp.states = state_from_jax(stacked, device="cpu")
    assert tp.states.opt_u.count == 0 and tp.states.u.shape[0] == n
    return tp


def _jax_trials(trainer, n=2, method="psvi_alpha_v"):
    """Each trial's JAX engine state, draws and plain step."""
    out = []
    for t in range(n):
        jeng = JPSVI(jax_read_dataset("four_blobs"), method=method, trainer=trainer, seed=t,
                     fused_inner=False, **FN_KW)
        key = jax.random.PRNGKey(100 + t)
        S = jeng.mc_samples
        js0 = _np_tree(jeng.state)
        if trainer == "nested":
            k_batch, k_inner, k_outer = jax.random.split(key, 3)
            batch = jeng._sample_batch(k_batch)
            eps = ([params_from_jax(_np_tree(jeng._sample_eps(k, S)), device="cpu")
                    for k in jax.random.split(k_inner, jeng.inner_it)],
                   params_from_jax(_np_tree(jeng._sample_eps(k_outer, S)), device="cpu"))
            js1, jaux, _ = _jax_nested_step(jeng, key, batch)
        else:
            k_batch, k_eps = jax.random.split(key)
            batch = jeng._sample_batch(k_batch)
            eps = params_from_jax(_np_tree(jeng._sample_eps(k_eps, S)), device="cpu")
            js1, jaux = jax.jit(jeng._joint_step)(jeng.state, key, batch=batch)
        out.append({"s0": js0, "s1": _np_tree(js1), "loss": float(jaux["outer_loss"]),
                    "batch": (_t(batch[0]), _t(batch[1])), "eps": eps})
    return out


def _vstep(tp, trials):
    batches = stack_trees([r["batch"] for r in trials])
    eps = stack_trees([r["eps"] for r in trials])
    return tp.vstep(tp.states, batches, eps)


def test_vmapped_nested_step_matches_jax_per_trial():
    trials = _jax_trials("nested")
    tp = _port_runner(read_dataset("four_blobs"), 2, [r["s0"] for r in trials],
                      method="psvi_alpha_v", **FN_KW)
    assert tp._step.__name__ == "_nested_step"
    states, losses = _vstep(tp, trials)
    for i, r in enumerate(trials):
        st, js1 = index_tree(states, i), r["s1"]
        np.testing.assert_allclose(float(losses[i]), r["loss"], rtol=1e-4)
        for k in ("u", "v"):  # first moments: 0.1·g of the hypergradients
            assert _agrees(getattr(st, f"opt_{k}").mu.numpy(),
                           np.asarray(getattr(js1, f"opt_{k}").mu)), (i, k)
        np.testing.assert_allclose(st.opt_alpha.mu.numpy(), np.asarray(js1.opt_alpha.mu),
                                   rtol=0.05)
        np.testing.assert_allclose(st.u.numpy(), np.asarray(js1.u), atol=1e-6)
        np.testing.assert_allclose(st.v.numpy(), np.asarray(js1.v), atol=1e-5)
        for tp_, jp in zip(st.params, js1.params):
            for k in tp_:
                np.testing.assert_allclose(tp_[k].numpy(), np.asarray(jp[k]), rtol=2e-4,
                                           atol=1e-6)
        assert st.net_step == int(js1.net_step) == 1


def test_vmapped_joint_step_matches_jax_per_trial():
    trials = _jax_trials("joint", method="psvi_learn_v")
    tp = _port_runner(read_dataset("four_blobs"), 2, [r["s0"] for r in trials],
                      method="psvi_learn_v", trainer="joint", **FN_KW)
    assert tp._step.__name__ == "_joint_step"
    states, losses = _vstep(tp, trials)
    for i, r in enumerate(trials):
        st, js1 = index_tree(states, i), r["s1"]
        np.testing.assert_allclose(float(losses[i]), r["loss"], rtol=1e-4)
        leaves = lambda s: {"params": s.params, "u": s.u, "v": s.v}  # noqa: E731
        m, jm = st.opt_joint.mu, js1.opt_joint.mu  # {params, u, v}: 0.1·g
        for x, y in zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, m)),
                        jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jm))):
            assert _agrees(x, y, rel=5e-3)
        _assert_adam_step(leaves(st), leaves(js1), jm, tp.base.lrs["joint"], f"trial {i}")


def _jax_regressor_trial(method, kw, t):
    """Trial t's JAX regressor: its state, draws, fp32 step loss and the
    hypergradients of its nested closure in float64 (jitted)."""
    jeng = JPSVIRegressor(jax_read_regression_dataset("sinus"), method=method, seed=t,
                          fused_inner=False, **kw)
    key = jax.random.PRNGKey(200 + t)
    k_batch, k_inner, k_outer = jax.random.split(key, 3)
    xb, yb = jeng._sample_batch(k_batch)
    S, js0 = jeng.mc_samples, _np_tree(jeng.state)
    eps_inner = [_np_tree(jeng._sample_eps(k, S)) for k in jax.random.split(k_inner, jeng.inner_it)]
    eps_outer = _np_tree(jeng._sample_eps(k_outer, S))
    _, jaux, _ = _jax_nested_step(jeng, key, (xb, yb))
    lr_now = float(jeng.lr_net_sched(0))
    with jax.enable_x64(True):
        st = _f64(js0)

        def outer64(h):
            u, v = h.get("u", st.u), h.get("v", st.v)
            z, alpha = h.get("z", st.z), h.get("alpha", st.alpha)
            params, ostate = st.params, jeng.inner_opt.init(st.params)
            for e in eps_inner:
                g = jax.grad(jeng._inner_loss)(params, _f64(e), u, z, v, alpha)
                params, ostate = jeng.inner_opt.step(params, g, ostate, lr_now)
            return jeng._outer_loss(params, _f64(eps_outer), u, z, v, alpha, _f64(xb),
                                    _f64(yb))

        grads64 = _np_tree(jax.jit(jax.grad(outer64))(jeng._hyper_tree(st)))
    return {"s0": js0, "loss": float(jaux["outer_loss"]), "grads64": grads64,
            "batch": (_t(xb), _t(yb)),
            "eps": ([params_from_jax(e, device="cpu") for e in eps_inner],
                    params_from_jax(eps_outer, device="cpu"))}


def test_vmapped_regressor_step_matches_jax_float64():
    method, kw = "psvi_learn_v_regressor", {k: v for k, v in REG_KW.items() if k != "seed"}
    runs = [_jax_regressor_trial(method, kw, t) for t in range(2)]
    tp = _port_runner(read_regression_dataset("sinus"), 2, [r["s0"] for r in runs],
                      method=method, **kw)
    assert isinstance(tp.base, PSVIRegressor)
    states, losses = _vstep(tp, runs)
    for i, r in enumerate(runs):
        st, jloss, jgrads64 = index_tree(states, i), r["loss"], r["grads64"]
        np.testing.assert_allclose(float(losses[i]), jloss, rtol=1e-4)
        grads = {k: getattr(st, f"opt_{k}").mu.numpy() / 0.1 for k in jgrads64}
        agree = _grads_agree(grads, jgrads64)
        assert set(agree) == {"u", "v", "z"} and all(agree.values()), (i, agree)


def _plain_trial(data, t, trainer_kw, n_steps, cls=PSVI):
    """A plain engine of seed ``t`` stepped ``n_steps`` times on trial t's
    generator: the trial runner's draws, in the same order."""
    eng = cls(data, seed=t, fused_inner=False, device="cpu", **trainer_kw)
    eng.gen = trial_generator(1000, t, "cpu")
    st = eng.state
    for _ in range(n_steps):
        st, _ = eng._step(st)
    return st


TRAINERS = {
    "alternating": dict(method="psvi_learn_v", trainer="alternating"),
    "hyper_cg": dict(method="psvi_learn_v", trainer="hyper", hyper_K=2),
    "hyper_fixed_point": dict(method="psvi_learn_v", trainer="hyper", hyper_K=2,
                              hypergrad_approx="fixed_point"),
    "hyper_neumann": dict(method="psvi_learn_v", trainer="hyper", hyper_K=2,
                          hypergrad_approx="neumann"),
    "truncated": dict(method="psvi_learn_v", truncated=True, truncated_K=1),
    "evaluate": dict(method="psvi_evaluate"),
    "soft_labels": dict(method="psvi_learn_v", learn_z=True, inner_optimizer="rmsprop"),
}


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_every_trainer_vmaps_like_its_plain_step(name):
    data = read_dataset("four_blobs")
    kw = {**FN_KW, **TRAINERS[name], "num_epochs": 2}
    tp = TrialParallelPSVI(data, 2, device="cpu", **kw)
    tp.run()
    for i, t in enumerate(tp.trials):
        st, ref = index_tree(tp.states, i), _plain_trial(data, t, kw, 2)
        for k in ("u", "v", "z"):
            np.testing.assert_allclose(getattr(st, k).numpy(), getattr(ref, k).numpy(),
                                       atol=1e-5, err_msg=f"{name} trial {t} {k}")
        for a, b in zip(st.params, ref.params):
            for k in a:
                np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=1e-5)


def test_lenet_trials_vmap_like_the_plain_step():
    kw = dict(method="psvi_learn_v", architecture="lenet", num_pseudo=4, mc_samples=2,
              inner_it=2, data_minibatch=8, init_sd=1e-3, num_epochs=1, log_every=10)
    data = read_dataset("synth_mnist")
    tp = TrialParallelPSVI(data, 2, device="cpu", **kw)
    batches, eps = tp.draw()
    states, _ = tp.vstep(tp.states, batches, eps)
    for i, t in enumerate(tp.trials):
        st, ref = index_tree(states, i), _plain_trial(data, t, kw, 1)
        np.testing.assert_allclose(st.u.numpy(), ref.u.numpy(), atol=1e-5)
        np.testing.assert_allclose(st.v.numpy(), ref.v.numpy(), atol=1e-5)


def test_one_trial_equals_that_trial_among_three():
    data = read_dataset("halfmoon")
    kw = dict(FN_KW, method="psvi_learn_v", architecture="logistic_regression")
    one = TrialParallelPSVI(data, 1, device="cpu", **kw).run()
    three = TrialParallelPSVI(data, 3, device="cpu", **kw).run()
    assert len(one) == 1 and len(three) == 3 and len(three[0]["accs"]) == 2
    np.testing.assert_allclose(one[0]["accs"], three[0]["accs"], atol=1e-6)
    np.testing.assert_allclose(one[0]["nlls"], three[0]["nlls"], rtol=1e-5)
    assert all(np.isfinite(r["accs"]).all() for r in three)


def test_single_process_run_joins_no_process_group():
    # the default one-rank mesh needs no process group, so a later
    # init_process_group in this process still works
    before = torch.distributed.is_initialized()
    kw = dict(FN_KW, method="psvi_learn_v", architecture="logistic_regression", num_epochs=2)
    res = run_trials(read_dataset("halfmoon"), 2, mesh=None, device="cpu", **kw)
    assert len(res) == 2 and all(np.isfinite(r["accs"]).all() for r in res)
    assert torch.distributed.is_initialized() == before


def test_chained_equals_unchained():
    data = read_dataset("halfmoon")
    kw = dict(FN_KW, method="psvi_learn_v", num_epochs=7, log_every=3)
    ra = TrialParallelPSVI(data, 3, device="cpu", **kw).run(chain_steps=True)
    rb = TrialParallelPSVI(data, 3, device="cpu", **kw).run(chain_steps=False)
    for a, b in zip(ra, rb):
        assert len(a["accs"]) == 3
        assert a["accs"] == b["accs"] and a["nlls"] == b["nlls"] and a["ness"] == b["ness"]


@pytest.mark.parametrize("flag", ["reset", "prune", "increment"])
def test_trial_runner_rejects_lifecycle(flag):
    with pytest.raises(ValueError, match="trial-parallel"):
        TrialParallelPSVI(read_dataset("halfmoon"), 2, method="psvi_learn_v", num_pseudo=8,
                          device="cpu", **{flag: True})


@pytest.mark.parametrize("option,named", [(dict(remat_inner=True), "remat_inner"),
                                          (dict(backend="pallas", trainer="joint"), "pallas")])
def test_trial_runner_names_what_cannot_vmap(option, named):
    with pytest.raises(ValueError, match=named):
        TrialParallelPSVI(read_dataset("halfmoon"), 2, device="cpu", **{**FN_KW, **option})


def test_gates_refuse_the_vmapped_step():
    dense = PSVI(read_dataset("four_blobs"), device="cpu", **FN_KW)
    lenet = PSVI(read_dataset("synth_mnist"), architecture="lenet", num_pseudo=4,
                 mc_samples=2, inner_it=2, data_minibatch=8, device="cpu")
    assert FN.supports(dense) and FL.supports(lenet)
    for eng, gate in ((dense, FN.supports), (lenet, FL.supports)):
        eng._in_trial_vmap = True
        assert not gate(eng)
        eng._in_trial_vmap = False
    with pytest.raises(ValueError, match="fused_inner=True"):
        TrialParallelPSVI(read_dataset("four_blobs"), 2, device="cpu", fused_inner=True,
                          **FN_KW)
    # the base engine keeps its fused step once the runner has resolved its own
    tp = TrialParallelPSVI(read_dataset("four_blobs"), 2, device="cpu", fused_inner="auto",
                           **FN_KW)
    assert not tp.base._in_trial_vmap and FN.supports(tp.base)


def test_state_from_jax_takes_the_runners_stacked_states():
    from psvi_tpu.parallel import TrialParallelPSVI as JTrialParallelPSVI
    from psvi_tpu.parallel import make_mesh as jax_make_mesh

    jtp = JTrialParallelPSVI(jax_read_dataset("halfmoon"), 3, method="psvi_learn_v",
                             mesh=jax_make_mesh(trial=1), num_pseudo=6, mc_samples=4,
                             inner_it=2, num_epochs=2, data_minibatch=32, log_every=1)
    jstates = _np_tree(jtp.states)
    st = state_from_jax(jstates, device="cpu")
    assert st.u.shape == (3, 6, 2) and st.net_step == 0 and st.opt_u.count == 0
    for i in range(3):
        one = state_from_jax(jax.tree_util.tree_map(lambda x: x[i], jstates), device="cpu")
        for a, b in zip(jax.tree_util.tree_leaves(index_tree(st, i)),
                        jax.tree_util.tree_leaves(one)):
            assert torch.equal(a, b) if torch.is_tensor(a) else a == b


def test_trial_generators():
    # a trial's stream depends on (seed, trial, stream) alone
    a = torch.randn(4, generator=trial_generator(1000, 3, "cpu"))
    b = torch.randn(4, generator=trial_generator(1000, 3, "cpu"))
    c = torch.randn(4, generator=trial_generator(1000, 3, "cpu", stream=1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert len({trial_seed(1000, t) for t in range(64)}) == 64
    g = trial_generator(1000, 0, "cpu")
    first = [torch.randn(2, generator=k) for k in step_keys(g, 5, 3)]
    torch.randn(100, generator=g)  # what was drawn before does not move them
    again = [torch.randn(2, generator=k) for k in step_keys(g, 5, 3)]
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    assert not torch.equal(first[0], first[1])
