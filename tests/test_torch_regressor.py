"""The port's regression path against the JAX package's.

- ``read_regression_dataset("sinus")`` equals JAX's, array for array;
- ``set_up_model("regressor_net")`` computes JAX's function on the same
  parameters and noise;
- one ``PSVIRegressor`` step, plain (``_nested_step``) and fused
  (``_nested_step_fused``: on the CPU the plain versions of the kernels),
  started from the JAX engine's state with the JAX step's batch and noise
  injected, matches the JAX engine's nested ``outer`` closure
  (``tests/test_fused_nested.py:102-121``) on the loss and on the
  hypergradients g_u, g_v, g_z (and g_α) themselves; the same comparison
  fails when g_z is zeroed or loses its terms from the unroll;
- ``_evaluate_fn`` with injected noise matches JAX's RMSE, predictive LL
  and IW diagnostics;
- the regressor's gates (``supports()``, ``fused_inner``),
  ``state_from_jax`` with ``opt_z``, and ``run_psvi``'s results dict.
"""

import torch_threads  # noqa: F401  (torch on this worker's share of the cores)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psvi_torch.data import read_regression_dataset
from psvi_torch.inference.psvi import (PSVI, PSVIRegressor, make_psvi_engine,
                                       run_psvi)
from psvi_torch.models.networks import make_dense, set_up_model
from psvi_torch.ops import fused_nested as FN
from psvi_torch.utils.config import METHOD_SPECS
from psvi_torch.utils.convert import params_from_jax, state_from_jax
from psvi_tpu.data import read_regression_dataset as jax_read_regression_dataset
from psvi_tpu.inference.psvi import PSVIRegressor as JPSVIRegressor
from psvi_tpu.models import networks as JN

REG_METHODS = ["psvi_regressor", "psvi_learn_v_regressor", "psvi_alpha_v_regressor"]
# the regressor config of tests/test_fused_nested.py:186-213
KW = dict(num_pseudo=12, mc_samples=5, architecture="regressor_net", n_hidden=20,
          inner_it=4, num_epochs=1, data_minibatch=32, log_every=1000, init_sd=1e-3,
          tau=1.0, seed=0)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _agrees(x, ref, rel=1e-3, cos=0.9999):
    """cosine > ``cos`` and max |Δ| ≤ ``rel``·max |ref|: sums over S·M terms
    through the unroll, so an elementwise rtol is not meaningful."""
    x, ref = np.asarray(x, np.float64).ravel(), np.asarray(ref, np.float64).ravel()
    return _cos(x, ref) > cos and np.abs(x - ref).max() <= rel * np.abs(ref).max()


# ---------------------------------------------------------------------------
# data and net
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_read_regression_dataset_matches_jax(seed):
    a, b = read_regression_dataset("sinus", seed=seed), jax_read_regression_dataset(
        "sinus", seed=seed)
    for k in ("x", "y", "xt", "yt", "xv", "yv"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y), k
    assert (a.N, a.D, a.nc) == (b.N, b.D, b.nc) == (800, 1, 1)
    assert (a.y_mean, a.y_std, a.taus) == (b.y_mean, b.y_std, b.taus)


def test_unported_regression_dataset_raises(tmp_path):
    """The UCI sets are file-gated: without their file each raises
    FileNotFoundError naming it, as JAX's reader does (a file written to
    tmp_path reads: tests/test_torch_data_readers.py); scikit-learn's
    diabetes reads as JAX's."""
    for name, fname in (("boston", "housing.data"), ("concrete", "Concrete_Data.xls")):
        with pytest.raises(FileNotFoundError, match=fname):
            read_regression_dataset(name, data_dir=str(tmp_path))
    a, b = read_regression_dataset("diabetes"), jax_read_regression_dataset("diabetes")
    for k in ("x", "y", "xt", "yt", "xv", "yv"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.parametrize("n_layers", [1, 2])
def test_regressor_net_matches_jax(n_layers):
    """The same parameters and noise give the same outputs, KL and NKL."""
    jnet = JN.set_up_model("regressor_net", 1, 40, 1, 1e-3, n_layers=n_layers)
    net = set_up_model("regressor_net", 1, 40, 1, 1e-3, n_layers=n_layers)
    params = _np_tree(jnet.init(jax.random.PRNGKey(0)))
    eps = _np_tree(jnet.sample_eps(jax.random.PRNGKey(1), 4))
    x = np.linspace(-2, 2, 7, dtype=np.float32)[:, None]
    tp, te = params_from_jax(params, device="cpu"), params_from_jax(eps, device="cpu")
    np.testing.assert_allclose(net.apply(tp, te, torch.tensor(x)).numpy(),
                               np.asarray(jnet.apply(params, eps, x)), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(net.kl(tp)), float(jnet.kl(params)), rtol=1e-5)
    np.testing.assert_allclose(net.nkl(tp, te).numpy(), np.asarray(jnet.nkl(params, eps)),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# one engine step against the JAX engine's outer closure
# ---------------------------------------------------------------------------


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.float64) if np.asarray(x).dtype.kind == "f" else x, tree)


def _jax_step(method, kw):
    """The JAX engine, the batch and noise its step draws from PRNGKey(11),
    and the loss and hypergradients of its nested ``outer`` closure
    (value_and_grad over the hyper tree), in float32 as the engine runs and
    in float64 (the same closure, written out over the drawn noise, under
    ``jax.enable_x64``)."""
    jeng = JPSVIRegressor(jax_read_regression_dataset("sinus"), method=method,
                          fused_inner=False, **kw)
    k_batch, k_inner, k_outer = jax.random.split(jax.random.PRNGKey(11), 3)
    xb, yb = jeng._sample_batch(k_batch)
    state = jeng.state
    lr_now = jeng.lr_net_sched(state.net_step)

    def outer(h):
        u, v = h.get("u", state.u), h.get("v", state.v)
        z, alpha = h.get("z", state.z), h.get("alpha", state.alpha)
        paramsT, _, _ = jeng._run_inner(state.params, u, z, v, alpha, k_inner, lr_now)
        eps = jeng._sample_eps(k_outer, jeng.mc_samples)
        return jeng._outer_loss(paramsT, eps, u, z, v, alpha, xb, yb)

    loss, grads = jax.value_and_grad(outer)(jeng._hyper_tree(state))
    keys = jax.random.split(k_inner, jeng.inner_it)
    eps_inner = [_np_tree(jeng._sample_eps(k, jeng.mc_samples)) for k in keys]
    eps_outer = _np_tree(jeng._sample_eps(k_outer, jeng.mc_samples))
    state_np, xb, yb = _np_tree(state), np.asarray(xb), np.asarray(yb)

    with jax.enable_x64(True):
        st = _f64(state_np)

        def outer64(h):
            u, v = h.get("u", st.u), h.get("v", st.v)
            z, alpha = h.get("z", st.z), h.get("alpha", st.alpha)
            params, ostate = st.params, jeng.inner_opt.init(st.params)
            for e in eps_inner:
                g = jax.grad(jeng._inner_loss)(params, _f64(e), u, z, v, alpha)
                params, ostate = jeng.inner_opt.step(params, g, ostate, float(lr_now))
            return jeng._outer_loss(params, _f64(eps_outer), u, z, v, alpha, _f64(xb),
                                    _f64(yb))

        grads64 = _np_tree(jax.grad(outer64)(jeng._hyper_tree(st)))
    batch = (torch.tensor(xb), torch.tensor(yb))
    eps = ([params_from_jax(e, device="cpu") for e in eps_inner],
           params_from_jax(eps_outer, device="cpu"))
    return jeng, float(loss), _np_tree(grads), grads64, batch, eps


def _port_step(peng, step, jeng, batch, eps):
    """One port step from the JAX engine's state; returns the outer loss and
    the hypergradients handed to the hyper-Adam update."""
    seen = {}
    apply = peng._apply_hyper_updates

    def capture(state, grads):
        seen.update({k: g.detach().numpy() for k, g in grads.items()})
        return apply(state, grads)

    peng._apply_hyper_updates = capture
    try:
        _, aux = step(state_from_jax(_np_tree(jeng.state), device="cpu"), batch=batch, eps=eps)
    finally:
        peng._apply_hyper_updates = apply
    return float(aux["outer_loss"]), seen


def _grads_agree(pgrads, jgrads, rel=1e-3, alpha=True):
    """Which hypergradients agree with JAX's: u, v, z at cosine > 0.9999 and
    max |Δ| ≤ ``rel``·max |ref|; with ``alpha``, α at rtol 0.05 (∂/∂α sums
    N-scaled terms with heavy cancellation, tests/test_fused_nested.py:175-
    183)."""
    out = {k: _agrees(pgrads[k], jgrads[k], rel) for k in ("u", "v", "z") if k in jgrads}
    if alpha and "alpha" in jgrads:
        out["alpha"] = bool(np.isclose(float(pgrads["alpha"][0]), float(jgrads["alpha"][0]),
                                       rtol=0.05, atol=1e-6))
    return out


# (method, n_layers, n_hidden, lr0net): the config above at the engine's
# inner lr, where the T iterations carry under 1e-3 of g_z, and at 1e-2,
# where they carry half of it
STEP_CASES = ([(m, 1, 20, 1e-3) for m in REG_METHODS]
              + [("psvi_alpha_v_regressor", 2, 40, 1e-3), ("psvi_learn_v_regressor", 1, 20, 1e-2)])


@pytest.mark.parametrize("method,n_layers,n_hidden,lr0net", STEP_CASES,
                         ids=[f"{m}-{n}x{h}-lr{lr:g}" for m, n, h, lr in STEP_CASES])
def test_regressor_step_matches_jax_outer(method, n_layers, n_hidden, lr0net):
    kw = {**KW, "n_layers": n_layers, "n_hidden": n_hidden, "lr0net": lr0net}
    jeng, jloss, jgrads, jgrads64, batch, eps = _jax_step(method, kw)
    spec = jeng.spec
    assert set(jgrads) == {"u", "z"} | ({"v"} if spec.learn_v else set()) | (
        {"alpha"} if spec.learn_alpha else set())
    peng = PSVIRegressor(read_regression_dataset("sinus"), method=method, device="cpu", **kw)
    assert FN.supports(peng)
    for step in (peng._nested_step, peng._nested_step_fused):
        loss, pgrads = _port_step(peng, step, jeng, batch, eps)
        assert set(pgrads) == set(jgrads), step.__name__
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
        # against the JAX closure in float64 at the kernels' tolerances; and
        # against its float32 run, whose own g_z sits up to 1e-2·max|ref| and
        # g_α up to 15 % from float64 (the IW-ELBO's uncentred fp32 softmax
        # VJP, ROADMAP.md §C), at twice that on u, v, z
        agree = _grads_agree(pgrads, jgrads64)
        agree32 = _grads_agree(pgrads, jgrads, rel=2e-2, alpha=False)
        assert all(agree.values()) and all(agree32.values()), (step.__name__, agree, agree32)


@pytest.mark.parametrize("mutation", ["g_z zeroed", "no unroll terms in g_z"])
def test_regressor_step_check_fails_on_broken_g_z(mutation, monkeypatch):
    """The step comparison above can fail: with g_z zeroed, or with g_z
    missing the T iterations' terms, the fused step no longer agrees with
    JAX on z while u and v still do (at lr0net 1e-2)."""
    method, kw = "psvi_learn_v_regressor", {**KW, "lr0net": 1e-2}
    jeng, _, _, jgrads64, batch, eps = _jax_step(method, kw)
    if mutation == "g_z zeroed":
        flat = FN.fused_nested_flat

        def zeroed(*args, **kw):
            out = flat(*args, **kw)
            return out[:-1] + (torch.zeros_like(out[-1]),)

        monkeypatch.setattr(FN, "fused_nested_flat", zeroed)
    else:
        rev = FN.nested_rev_torch

        def outer_term_only(*args):  # g_z keeps the outer IW-ELBO's z̄ alone
            return rev(*args)[:3] + (args[4],)

        monkeypatch.setattr(FN, "nested_rev_torch", outer_term_only)
    peng = PSVIRegressor(read_regression_dataset("sinus"), method=method, device="cpu", **kw)
    _, pgrads = _port_step(peng, peng._nested_step_fused, jeng, batch, eps)
    agree = _grads_agree(pgrads, jgrads64)
    assert agree["u"] and agree["v"] and not agree["z"], agree


# ---------------------------------------------------------------------------
# evaluation, state conversion, run loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["psvi_learn_v_regressor", "psvi_alpha_v_regressor"])
def test_evaluate_fn_matches_jax(method):
    """From the JAX state after one step (v and α moved), with JAX's noise
    draw injected."""
    jeng = JPSVIRegressor(jax_read_regression_dataset("sinus"), method=method,
                          fused_inner=False, **KW)
    state, _ = jeng._nested_step(jeng.state, jax.random.PRNGKey(4))
    key = jax.random.PRNGKey(5)
    jout = jeng._evaluate_fn(state, key)
    eps = params_from_jax(_np_tree(jeng.net.sample_eps(key, jeng.mc_samples_eval)), device="cpu")
    peng = PSVIRegressor(read_regression_dataset("sinus"), method=method, device="cpu", **KW)
    pout = peng._evaluate_fn(state_from_jax(_np_tree(state), device="cpu"), eps=eps)
    for name, p, j in zip(("rmse", "ll", "iw_entropy", "ness", "v_entropy"), pout, jout):
        np.testing.assert_allclose(float(p), float(j), rtol=1e-5, err_msg=name)


def test_state_from_jax_carries_opt_z():
    jeng = JPSVIRegressor(jax_read_regression_dataset("sinus"),
                          method="psvi_learn_v_regressor", fused_inner=False, **KW)
    state, _ = jeng._nested_step(jeng.state, jax.random.PRNGKey(4))
    st = state_from_jax(_np_tree(state), device="cpu")
    assert st.opt_z.count == int(np.asarray(state.opt_z.count)) == 1
    np.testing.assert_array_equal(st.opt_z.mu.numpy(), np.asarray(state.opt_z.mu))
    np.testing.assert_array_equal(st.opt_z.nu.numpy(), np.asarray(state.opt_z.nu))
    np.testing.assert_array_equal(st.z.numpy(), np.asarray(state.z))
    # the port's own init draws the same pseudodata as the JAX engine
    peng = PSVIRegressor(read_regression_dataset("sinus"), method="psvi_learn_v_regressor",
                         device="cpu", **KW)
    np.testing.assert_array_equal(peng.state.u.numpy(), np.asarray(jeng.state.u))
    np.testing.assert_array_equal(peng.state.z.numpy(), np.asarray(jeng.state.z))


# the JAX regressor's results-dict keys (psvi_tpu/inference/psvi.py:1915-1918)
REG_RESULT_KEYS = {"rmses", "lls", "csizes", "times", "vs", "went", "ness", "vent"}


@pytest.mark.parametrize("method", REG_METHODS)
def test_run_psvi_regressor_results(method):
    res = run_psvi(read_regression_dataset("sinus"), method=method,
                   **{**KW, "num_epochs": 3, "log_every": 2}, device="cpu", fused_inner=True)
    alpha = METHOD_SPECS[method].learn_alpha
    assert set(res) == REG_RESULT_KEYS | ({"alpha"} if alpha else set())
    assert len(res["rmses"]) == len(res["lls"]) == len(res["vs"]) == 2
    assert all(np.isfinite(res["rmses"])) and all(np.isfinite(res["lls"]))
    assert res["went"] == res["ness"] == res["vent"] == []
    # vs holds f(v), which sums to one without α (softmax(v), or v = 1/M)
    for fv in res["vs"]:
        assert fv.shape == (KW["num_pseudo"],)
        if not alpha:
            np.testing.assert_allclose(fv.sum(), 1.0, rtol=1e-5)
    if alpha:
        assert len(res["alpha"]) == 2


def test_run_psvi_sinus_learns():
    """The slice's main path at a quarter of its run, through the fused
    step's plain versions: the test RMSE falls from about 0.7 (JAX on the
    CPU: 0.712 at step 0, 0.274 at step 50 for seed 0)."""
    res = run_psvi(read_regression_dataset("sinus"), method="psvi_learn_v_regressor",
                   architecture="regressor_net", n_hidden=40, n_layers=1, num_pseudo=10,
                   mc_samples=10, inner_it=10, data_minibatch=64, tau=0.1, init_sd=1e-3,
                   lr0u=1e-2, lr0v=1e-2, lr0z=1e-2, num_epochs=51, log_every=25, seed=0,
                   device="cpu", fused_inner=True)
    assert len(res["rmses"]) == 3
    assert res["rmses"][0] > 0.6 and res["rmses"][-1] < 0.45, res["rmses"]
    assert all(np.isfinite(res["lls"]))


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------

GATE_KW = {**KW, "device": "cpu"}


def test_supports_admits_gaussian():
    data = read_regression_dataset("sinus")
    for method in REG_METHODS:
        eng = make_psvi_engine(data, method=method, **GATE_KW)
        assert isinstance(eng, PSVIRegressor) and FN.supports(eng)
        assert eng._fused_cfg(32).likelihood == "gaussian" and eng._fused_cfg(32).learn_z
    # the plain path on the CPU under 'auto'; the fused one when asked
    assert PSVIRegressor(data, **GATE_KW)._step.__name__ == "_nested_step"
    assert PSVIRegressor(data, fused_inner=True, **GATE_KW)._step.__name__ == \
        "_nested_step_fused"
    # two hidden layers of 40: the 1-40-40-1 net
    assert FN.supports(PSVIRegressor(data, **{**GATE_KW, "n_layers": 2, "n_hidden": 40}))


def test_supports_refuses_gaussian_outside_the_design():
    data = read_regression_dataset("sinus")
    assert not FN.supports(PSVIRegressor(data, **{**GATE_KW, "mc_samples": 33}))
    assert not FN.supports(PSVIRegressor(data, **{**GATE_KW, "mc_samples": 1}))
    assert not FN.supports(PSVIRegressor(data, **{**GATE_KW, "n_layers": 8}))
    eng = PSVIRegressor(data, **GATE_KW)
    eng.net = make_dense((1, 20, 2))  # a Gaussian head reads one output
    assert not FN.supports(eng)


@pytest.mark.parametrize("over", [dict(mc_samples=33), dict(mc_samples=1),
                                  dict(n_hidden=500)])
def test_fused_inner_true_raises_for_unsupported_regressor(over):
    with pytest.raises(ValueError, match="fused_inner=True"):
        PSVIRegressor(read_regression_dataset("sinus"), fused_inner=True,
                      **{**GATE_KW, **over})


def test_categorical_learn_z_is_refused():
    """The fused gate refuses learned soft labels (the KLDiv NLL), which the
    plain step serves, as JAX's gate does; learned Gaussian targets pass
    it."""
    from psvi_torch.data import read_dataset

    assert METHOD_SPECS["psvi_learn_v_regressor"].learn_z
    kw = dict(num_pseudo=8, mc_samples=4, inner_it=2, device="cpu")
    soft = PSVI(read_dataset("halfmoon"), method="psvi_learn_v", learn_z=True, **kw)
    assert not FN.supports(soft) and soft._step.__name__ == "_nested_step"
    assert soft.state.z.shape == (8, 2)
    with pytest.raises(ValueError, match="fused_inner=True"):
        PSVI(read_dataset("halfmoon"), method="psvi_evaluate", fused_inner=True, **kw)
    eng = PSVI(read_dataset("halfmoon"), method="psvi_learn_v", **kw)
    assert FN.supports(eng)
    eng.spec = dataclasses.replace(eng.spec, learn_z=True)
    assert not FN.supports(eng)


if __name__ == "__main__":
    # The gaps behind the step test's tolerances: JAX's fp32 engine closure
    # and the port's two fp32 steps, each against the JAX closure in float64
    # (max |Δ|/max |ref|; α relative).
    for method, n_layers, n_hidden, lr0net in STEP_CASES:
        kw = {**KW, "n_layers": n_layers, "n_hidden": n_hidden, "lr0net": lr0net}
        jeng, _, jgrads, jgrads64, batch, eps = _jax_step(method, kw)
        peng = PSVIRegressor(read_regression_dataset("sinus"), method=method, device="cpu", **kw)
        rows = {"jax fp32": jgrads}
        for step in (peng._nested_step, peng._nested_step_fused):
            rows["port " + step.__name__] = _port_step(peng, step, jeng, batch, eps)[1]
        for name, g in rows.items():
            gaps = {k: float(np.abs(g[k] - jgrads64[k]).max() / np.abs(jgrads64[k]).max())
                    for k in jgrads64}
            print(method, f"{n_layers}x{n_hidden}", f"lr0net={lr0net:g}", name,
                  {k: f"{v:.3g}" for k, v in gaps.items()})
