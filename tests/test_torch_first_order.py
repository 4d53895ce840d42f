"""The port's first-order trainers against the JAX engine's, on the CPU.

Both engines run with ``backend="pallas"``: in JAX off the TPU that is
``sampled_linear``'s reference forward under its ``custom_vjp`` (so JAX's
``_bwd`` differentiates it); in the port kernel B3's Function, whose
forward on CPU tensors is the plain version and whose backward is the same
``_bwd`` in torch products.

- ``_joint_step`` (halfmoon fn 2-16-2, a small LeNet on synth_mnist and the
  sinus regressor 1-20-1), ``_alternating_step`` (the first two) and
  ``_retrain_step`` (fn) of the port, started from the JAX engine's state
  (``state_from_jax``) and given the JAX step's batch and noise: the JAX
  engine instance's ``_sample_eps`` is patched to hand out numpy draws in
  order, and the port gets the same draws through its ``eps`` seam. Each
  case compares the loss, the gradients each step hands to Adam (from each
  engine's ``_outer_loss``, or ``_inner_loss`` for retrain, at the same
  inputs; against the JAX function run in float64, whose fp32 run is itself
  up to 3e-3·max|ref| off on u and v) and the state after the step. The
  joint comparison fails when the Function's backward drops dρ_w.
- The run loop against a short JAX run: the ``register_elbos`` tags and
  counts for both trainers, ``retrain_on_coreset`` doubling the evaluation
  series, and ``reset``.
- A 101-step four_blobs fn joint run, and the port's gates.
"""

import torch_threads  # noqa: F401  (torch on this worker's share of the cores)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psvi_torch.data import read_dataset, read_regression_dataset
from psvi_torch.inference.psvi import PSVI, PSVIRegressor, run_psvi
from psvi_torch.ops import sampled_linear as SL
from psvi_torch.ops.hypergrad import value_and_grad as _value_and_grad
from psvi_torch.utils.convert import params_from_jax, state_from_jax
from psvi_tpu.data import read_dataset as jax_read_dataset
from psvi_tpu.data import read_regression_dataset as jax_read_regression_dataset
from psvi_tpu.inference.psvi import PSVI as JPSVI
from psvi_tpu.inference.psvi import PSVIRegressor as JPSVIRegressor

# tests/test_round2_features.py:49-54 (halfmoon fn 2-16-2), a small LeNet
# (S=2, M=4, B=8) and the sinus regressor 1-20-1
CONFIGS = {
    "fn": ("halfmoon", dict(method="psvi_learn_v", architecture="fn", n_hidden=16,
                            num_pseudo=8, mc_samples=4, data_minibatch=64)),
    "lenet": ("synth_mnist", dict(method="psvi_learn_v", architecture="lenet", num_pseudo=4,
                                  mc_samples=2, data_minibatch=8)),
    "regressor": ("sinus", dict(method="psvi_learn_v_regressor", architecture="regressor_net",
                                n_hidden=20, num_pseudo=12, mc_samples=5, data_minibatch=32,
                                tau=1.0)),
}
COMMON = dict(inner_it=2, num_epochs=2, log_every=10, init_sd=1e-3, seed=0)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _f64(tree):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), tree)


def _jax_grad(fn, leaves, *consts):
    """``jax.grad(fn)`` at (leaves, *consts), jitted, in float32 as the engine
    runs it and in float64 (``jax.enable_x64``; JAX's ``Sequential.apply``
    still rounds each net output to float32)."""
    g32 = _np_tree(jax.jit(jax.grad(fn))(leaves, *consts))
    with jax.enable_x64(True):
        g64 = _np_tree(jax.jit(jax.grad(fn))(_f64(leaves), *_f64(consts)))
    return g32, g64


def _assert_grads(port, ref, what, rel=1e-4):
    """Per leaf: cosine > 0.99999 and max |Δ| ≤ ``rel``·max |ref|. Against
    float64 at 1e-4: each entry sums S·(M + B) fp32 terms, and the port's
    largest gap measured is 7.9e-5 (the regressor's v). Against JAX's own
    fp32 run at 5e-3: the gap to it, up to 2.9e-3·max|ref| on the
    regressor's v, is that run's own error (its IW-ELBO's softmax VJP over
    the uncentred d, ROADMAP.md §C)."""
    p = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, port))
    r = jax.tree_util.tree_leaves(_np_tree(ref))
    assert len(p) == len(r), what
    for i, (x, y) in enumerate(zip(p, r)):
        assert x.shape == y.shape, (what, i)
        assert _cos(x, y) > 0.99999, (what, i, _cos(x, y))
        assert np.abs(x - y).max() <= rel * np.abs(y).max(), (what, i)


def _assert_grads_both(port, g32, g64, what):
    _assert_grads(port, g64, what)
    _assert_grads(port, g32, what + " (JAX fp32)", rel=5e-3)


def _assert_adam_step(port, ref, g_ref, lr, what):
    """The leaves after one Adam step from the same start. The first step is
    −lr·g/(|g| + 1e-8), so an entry whose gradient is near zero moves by an
    amount that fp32 rounding of g decides: entries with |g| above 1e-3 of
    the leaf's largest agree to 1e-3·lr, every entry to within one step (lr)."""
    p = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, port))
    r = jax.tree_util.tree_leaves(_np_tree(ref))
    g = jax.tree_util.tree_leaves(_np_tree(g_ref))
    for i, (x, y, gi) in enumerate(zip(p, r, g)):
        d = np.abs(x - y)
        big = np.abs(gi) > 1e-3 * np.abs(gi).max()
        assert d[big].max(initial=0.0) <= 1e-3 * lr, (what, i, d[big].max(initial=0.0))
        assert d.max() <= lr * (1 + 1e-3), (what, i, d.max())


class _Draws:
    """Numpy-made noise for both engines: the JAX instance's ``_sample_eps``
    hands these out in order; the port gets them through ``eps``."""

    def __init__(self, jeng, n, seed=5):
        rng = np.random.default_rng(seed)
        shapes = jeng._sample_eps(jax.random.PRNGKey(0), jeng.mc_samples)
        self.trees = [jax.tree_util.tree_map(
            lambda e: rng.standard_normal(e.shape).astype(np.float32), shapes)
            for _ in range(n)]
        it = iter(self.trees)
        jeng._sample_eps = lambda key, S: jax.tree_util.tree_map(jnp.asarray, next(it))

    def port(self, i):
        return params_from_jax(self.trees[i], device="cpu")


def _engines(name, trainer):
    dname, kw = CONFIGS[name]
    kw = {**kw, **COMMON, "trainer": trainer, "backend": "pallas"}
    if name == "regressor":
        return (JPSVIRegressor(jax_read_regression_dataset(dname), **kw),
                PSVIRegressor(read_regression_dataset(dname), device="cpu", **kw))
    return JPSVI(jax_read_dataset(dname), **kw), PSVI(read_dataset(dname), device="cpu", **kw)


def _batch(jeng, seed=7):
    idx = np.random.default_rng(seed).choice(jeng.n_train_now, jeng.data_minibatch,
                                             replace=False)
    xb, yb = np.asarray(jeng.x_train)[idx], np.asarray(jeng.y_train)[idx]
    return (jnp.asarray(xb), jnp.asarray(yb)), (torch.from_numpy(xb), torch.from_numpy(yb))


def _joint_leaves(st, learn_v=True):
    leaves = {"params": st.params, "u": st.u}
    if learn_v:
        leaves["v"] = st.v
    return leaves


def _check_joint(name):
    jeng, peng = _engines(name, "joint")
    draws = _Draws(jeng, 1)
    jb, pb = _batch(jeng)
    js0 = _np_tree(jeng.state)
    js1, jaux = jax.jit(jeng._joint_step)(jeng.state, jax.random.PRNGKey(1), batch=jb)
    ps1, paux = peng._joint_step(state_from_jax(js0, device="cpu"), batch=pb, eps=draws.port(0))
    np.testing.assert_allclose(float(paux["outer_loss"]), float(jaux["outer_loss"]), rtol=1e-5)
    # the gradients the step hands to Adam, from each engine's _outer_loss
    g32, g64 = _jax_grad(lambda lv, e, z, a, xb, yb: jeng._outer_loss(
        lv["params"], e, lv["u"], z, lv["v"], a, xb, yb),
        _joint_leaves(js0), draws.trees[0], js0.z, js0.alpha, *jb)
    p0 = state_from_jax(js0, device="cpu")
    _, g_p = _value_and_grad(lambda lv: peng._outer_loss(
        lv["params"], draws.port(0), lv["u"], p0.z, lv["v"], p0.alpha, *pb), _joint_leaves(p0))
    _assert_grads_both(g_p, g32, g64, f"{name} joint grads")
    lr = peng.lrs["joint"]
    _assert_adam_step(_joint_leaves(ps1), _joint_leaves(js1), g32, lr, f"{name} joint state")
    assert ps1.opt_joint.count == int(js1.opt_joint.count) == 1
    _assert_grads(ps1.opt_joint.mu, js1.opt_joint.mu, f"{name} joint m", rel=5e-3)
    np.testing.assert_array_equal(ps1.z.numpy(), np.asarray(js1.z))
    np.testing.assert_array_equal(ps1.alpha.numpy(), np.asarray(js1.alpha))
    assert paux["inner_losses"].shape == np.asarray(jaux["inner_losses"]).shape == (1,)


@pytest.mark.parametrize("name", ["fn", "lenet", "regressor"])
def test_joint_step_matches_jax(name):
    _check_joint(name)


def test_joint_comparison_fails_without_drho_w(monkeypatch):
    """The same comparison fails when the Function's backward returns
    dρ_w = 0: the tolerances above do not pass anything."""
    bwd = SL._bwd

    def no_drho_w(*a):
        out = list(bwd(*a))
        out[2] = None if out[2] is None else torch.zeros_like(out[2])
        return tuple(out)

    monkeypatch.setattr(SL, "_bwd", no_drho_w)
    with pytest.raises(AssertionError, match="joint grads"):
        _check_joint("fn")


@pytest.mark.parametrize("name", ["fn", "lenet"])
def test_alternating_step_matches_jax(name):
    jeng, peng = _engines(name, "alternating")
    draws = _Draws(jeng, 2)
    jb, pb = _batch(jeng)
    js0 = _np_tree(jeng.state)
    js1, jaux = jax.jit(jeng._alternating_step)(jeng.state, jax.random.PRNGKey(1), batch=jb)
    ps1, paux = peng._alternating_step(state_from_jax(js0, device="cpu"), batch=pb,
                                       eps=(draws.port(0), draws.port(1)))
    np.testing.assert_allclose(float(paux["outer_loss"]), float(jaux["outer_loss"]), rtol=1e-5)
    np.testing.assert_allclose(paux["inner_losses"].numpy(), np.asarray(jaux["inner_losses"]),
                               rtol=1e-5)
    p0 = state_from_jax(js0, device="cpu")
    # the net step's gradient at the start
    g32, g64 = _jax_grad(jeng._outer_loss, js0.params, draws.trees[0], js0.u, js0.z, js0.v,
                         js0.alpha, *jb)
    _, g_p = _value_and_grad(lambda p: peng._outer_loss(
        p, draws.port(0), p0.u, p0.z, p0.v, p0.alpha, *pb), p0.params)
    _assert_grads_both(g_p, g32, g64, f"{name} net grads")
    _assert_adam_step(ps1.params, js1.params, g32, peng.lrs["net"], f"{name} params")
    # the u step's gradient, both at JAX's new net
    params1 = _np_tree(js1.params)
    g32, g64 = _jax_grad(lambda u, p, e, z, v, a, xb, yb: jeng._outer_loss(
        p, e, u, z, v, a, xb, yb), js0.u, params1, draws.trees[1], js0.z, js0.v, js0.alpha, *jb)
    _, g_up = _value_and_grad(lambda u: peng._outer_loss(
        params_from_jax(params1, device="cpu"), draws.port(1), u, p0.z, p0.v, p0.alpha, *pb), p0.u)
    _assert_grads_both(g_up, g32, g64, f"{name} u grads")
    _assert_adam_step(ps1.u, js1.u, g32, peng.lrs["u"], f"{name} u")
    assert ps1.opt_net.count == int(js1.opt_net.count) == 1
    assert ps1.opt_u.count == int(js1.opt_u.count) == 1
    np.testing.assert_array_equal(ps1.v.numpy(), np.asarray(js1.v))


def test_retrain_step_matches_jax():
    jeng, peng = _engines("fn", "alternating")
    jeng.weight_reset()
    draws = _Draws(jeng, 1)
    js0 = _np_tree(jeng.state)
    js1, jloss = jax.jit(jeng._retrain_step)(jeng.state, jax.random.PRNGKey(1))
    ps1, ploss = peng._retrain_step(state_from_jax(js0, device="cpu"), eps=draws.port(0))
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)
    g32, g64 = _jax_grad(jeng._inner_loss, js0.params, draws.trees[0], js0.u, js0.z, js0.v,
                         js0.alpha)
    p0 = state_from_jax(js0, device="cpu")
    _, g_p = _value_and_grad(lambda p: peng._inner_loss(p, draws.port(0), p0.u, p0.z, p0.v,
                                                        p0.alpha), p0.params)
    _assert_grads_both(g_p, g32, g64, "retrain grads")
    # the retrain Adam runs at lr0joint on the net's Adam state
    _assert_adam_step(ps1.params, js1.params, g32, peng.lrs["joint"], "retrain params")
    assert ps1.opt_net.count == int(js1.opt_net.count) == 1


def test_backends_agree_on_a_joint_step():
    """With backend="xla" the same step runs the plain product and autograd;
    on the CPU it agrees with the Function's path."""
    dname, kw = CONFIGS["fn"]
    kw = {**kw, **COMMON, "trainer": "joint", "device": "cpu"}
    engs = {b: PSVI(read_dataset(dname), backend=b, **kw) for b in ("xla", "pallas")}
    gen = torch.Generator().manual_seed(3)
    eps = engs["xla"].net.sample_eps(gen, engs["xla"].mc_samples)
    batch = (engs["xla"].x_train[:64], engs["xla"].y_train[:64])
    out = {b: e._joint_step(e.state, batch=batch, eps=eps) for b, e in engs.items()}
    np.testing.assert_allclose(float(out["pallas"][1]["outer_loss"]),
                               float(out["xla"][1]["outer_loss"]), rtol=1e-6)
    for x, y in zip(jax.tree_util.tree_leaves(_joint_leaves(out["pallas"][0])),
                    jax.tree_util.tree_leaves(_joint_leaves(out["xla"][0]))):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# the run loop against a short JAX run
# ---------------------------------------------------------------------------

RUN = dict(method="psvi_learn_v", architecture="logistic_regression", num_pseudo=10,
           mc_samples=4, inner_it=2, num_epochs=6, data_minibatch=64, log_every=5,
           init_sd=1e-3, seed=0, backend="pallas")


@pytest.mark.parametrize("trainer,tag", [("joint", 2), ("alternating", 0)])
def test_register_elbos_streams_match_jax(trainer, tag):
    kw = {**RUN, "trainer": trainer, "register_elbos": True}
    jres = JPSVI(jax_read_dataset("halfmoon"), **kw).run_psvi()
    pres = run_psvi(read_dataset("halfmoon"), device="cpu", **kw)
    tags = [t for t, _ in pres["elbos"]]
    assert tags == [t for t, _ in jres["elbos"]] == [1, tag] * RUN["num_epochs"]
    assert all(np.isfinite(v) for _, v in pres["elbos"])
    if trainer == "joint":
        assert all(v == 0.0 for t, v in pres["elbos"] if t == 1)


def _count_resets(eng):
    calls = []
    reset = eng.weight_reset
    eng.weight_reset = lambda: calls.append(1) or reset()
    return calls


@pytest.mark.parametrize("trainer", ["joint", "alternating"])
def test_reset_and_retrain_match_jax(trainer):
    """tests/test_psvi_engine.py:112-116 at the port: retrain doubles the
    evaluation series; reset re-initialises the net every reset_interval
    steps, and once more before the retrain loop."""
    kw = {**RUN, "trainer": trainer, "reset": True, "reset_interval": 5,
          "retrain_on_coreset": True}
    jeng = JPSVI(jax_read_dataset("halfmoon"), **kw)
    peng = PSVI(read_dataset("halfmoon"), device="cpu", **kw)
    jcalls, pcalls = _count_resets(jeng), _count_resets(peng)
    jres, pres = jeng.run_psvi(), peng.run_psvi()
    assert len(pcalls) == len(jcalls) == 3
    for k in ("accs", "nlls", "csizes", "times", "vs"):
        assert len(pres[k]) == len(jres[k]) == 4, k
    assert len(pres["went"]) == len(jres["went"]) == 2
    # raw v while training, f(v) = softmax(v) while retraining
    np.testing.assert_allclose(pres["vs"][-1], torch.softmax(peng.state.v, 0).numpy())
    assert all(np.isfinite(pres["accs"])) and all(np.isfinite(pres["nlls"]))
    assert pres["elbos"] == []


def test_four_blobs_fn_joint_run():
    res = run_psvi(read_dataset("four_blobs"), method="psvi_learn_v", architecture="fn",
                   n_hidden=40, n_layers=1, num_pseudo=48, mc_samples=10, inner_it=10,
                   data_minibatch=128, init_sd=1e-3, num_epochs=101, log_every=50, seed=0,
                   trainer="joint", backend="pallas", device="cpu")
    assert len(res["accs"]) == 3
    assert res["accs"][-1] >= 0.85
    assert all(np.isfinite(res["nlls"]))


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("trainer", ["nested", "hyper"])
def test_pallas_backend_rejects_higher_order_trainers(trainer):
    """tests/test_round2_features.py:75-84 at the port."""
    with pytest.raises(ValueError, match="pallas"):
        PSVI(read_dataset("halfmoon"), method="psvi_learn_v", num_pseudo=8, architecture="fn",
             trainer=trainer, backend="pallas", device="cpu")


def test_trainer_gates():
    data = read_dataset("halfmoon")
    kw = dict(num_pseudo=8, device="cpu")
    with pytest.raises(ValueError, match="fused_inner=True"):
        PSVI(data, trainer="joint", fused_inner=True, **kw)
    assert PSVI(data, trainer="hyper", **kw)._step.__name__ == "_hyper_step"
    with pytest.raises(ValueError, match="backend"):
        PSVI(data, trainer="joint", backend="cuda", **kw)
    assert PSVI(data, trainer="joint", **kw)._step.__name__ == "_joint_step"
    assert PSVI(data, trainer="alternating", **kw)._step.__name__ == "_alternating_step"


def test_state_from_jax_carries_first_order_optimizers():
    jeng, _ = _engines("fn", "joint")
    step = jax.jit(jeng._joint_step)
    js = _np_tree(step(step(jeng.state, jax.random.PRNGKey(0))[0], jax.random.PRNGKey(1))[0])
    st = state_from_jax(js, device="cpu")
    assert list(st.opt_joint.mu) == list(js.opt_joint.mu) == ["params", "u", "v"]
    assert st.opt_joint.count == int(js.opt_joint.count)
    for x, y in zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                                      st.opt_joint.nu)),
                    jax.tree_util.tree_leaves(js.opt_joint.nu)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(st.opt_net.mu[0]["rho_w"].numpy(),
                                  np.asarray(js.opt_net.mu[0]["rho_w"]))
    assert st.opt_net.count == int(js.opt_net.count) == 0
