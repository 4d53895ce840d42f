"""The engine's remaining options against the JAX engine and against the
port's own nested step.

- ``truncated``: T − K warm-up steps at a fresh Adam(1e-4) that are not
  differentiated, then K that are, on JAX's injected warm-up and inner
  noise (T=5, K=2), against the jitted JAX step;
- ``remat_inner``: each differentiated inner iteration recomputed in the
  backward pass (``torch.utils.checkpoint``) gives the plain step's
  hypergradients and state;
- ``ops/hypergrad.reverse_unroll`` over the port's differentiable
  ``_run_inner`` gives ``_nested_step``'s hypergradients;
- the evaluation of ``psvi_no_iw`` (five samples, not one) and of learned
  soft labels against JAX's ``_evaluate_fn`` on the same draws;
- every method of ``METHOD_SPECS`` constructs and takes a step, and both
  fused gates refuse the new methods, ``truncated`` and the hyper trainer,
  as JAX's do.
"""

import torch_threads  # noqa: F401  (torch on this worker's share of the cores)

import jax
import numpy as np
import pytest
import torch

from psvi_torch.data import read_dataset, read_regression_dataset
from psvi_torch.inference.psvi import PSVI, make_psvi_engine
from psvi_torch.ops import fused_lenet as FL
from psvi_torch.ops import fused_nested as FN
from psvi_torch.ops import hypergrad as H
from psvi_torch.utils.config import METHOD_SPECS
from psvi_torch.utils.convert import params_from_jax, state_from_jax
from psvi_torch.utils.tree import tree_map
from psvi_tpu.data import read_dataset as jax_read_dataset
from psvi_tpu.inference.psvi import PSVI as JPSVI

KW = dict(num_pseudo=20, mc_samples=6, inner_it=5, data_minibatch=64, init_sd=1e-3,
          num_epochs=1, log_every=1000, seed=0)
FN_KW = dict(architecture="fn", n_hidden=20)
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cv(tree):
    return params_from_jax(tree, device="cpu")


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _capture(eng):
    """The hypergradients each step hands to the hyper-Adam update."""
    seen = {}
    apply = eng._apply_hyper_updates

    def capture(state, grads):
        seen.clear()
        seen.update({k: g.detach().clone() for k, g in grads.items()})
        return apply(state, grads)

    eng._apply_hyper_updates = capture
    return seen


def _rel(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


# ---------------------------------------------------------------------------
# the truncated nested step
# ---------------------------------------------------------------------------


def test_truncated_step_matches_jax():
    T, K = 5, 2
    kw = {**KW, **FN_KW, "truncated": True, "truncated_K": K}
    jeng = JPSVI(jax_read_dataset("four_blobs"), method="psvi_learn_v", fused_inner=False, **kw)
    key = jax.random.PRNGKey(3)
    # the batch and the noise the JAX step draws from this key: the warm-up
    # from fold_in(k_inner, 1), the differentiated steps from k_inner
    k_batch, k_inner, k_outer = jax.random.split(key, 3)
    xb, yb = jeng._sample_batch(k_batch)
    S = jeng.mc_samples
    warm = [_np_tree(jeng._sample_eps(k, S))
            for k in jax.random.split(jax.random.fold_in(k_inner, 1), T - K)]
    inner = [_np_tree(jeng._sample_eps(k, S)) for k in jax.random.split(k_inner, K)]
    eps_outer = _np_tree(jeng._sample_eps(k_outer, S))
    jstate0 = _np_tree(jeng.state)
    apply = jeng._apply_hyper_updates

    def step(state, key, batch):
        seen = {}

        def capture(s, g):
            seen.update(g)
            return apply(s, g)

        jeng._apply_hyper_updates = capture
        try:
            out = jeng._nested_step(state, key, batch)
        finally:
            jeng._apply_hyper_updates = apply
        return out, seen

    batch = (xb, yb)
    (jstate1, jaux), jgrads = jax.jit(step).lower(jeng.state, key, batch).compile(
        compiler_options=FAST_COMPILE)(jeng.state, key, batch)
    jstate1, jaux, jgrads = _np_tree(jstate1), _np_tree(jaux), _np_tree(jgrads)

    peng = PSVI(read_dataset("four_blobs"), method="psvi_learn_v", device="cpu", **kw)
    assert peng._step.__name__ == "_nested_step"
    pgrads = _capture(peng)
    s1, aux = peng._nested_step(
        state_from_jax(jstate0, device="cpu"),
        batch=(torch.tensor(np.asarray(xb)), torch.tensor(np.asarray(yb))),
        eps=([_cv(e) for e in warm + inner], _cv(eps_outer)))
    np.testing.assert_allclose(float(aux["outer_loss"]), float(jaux["outer_loss"]), rtol=1e-5)
    assert aux["inner_losses"].shape == (K,)  # the differentiated steps' losses
    np.testing.assert_allclose(aux["inner_losses"].numpy(), jaux["inner_losses"], rtol=2e-5)
    assert set(pgrads) == set(jgrads) == {"u", "v"}
    for k in ("u", "v"):
        g = pgrads[k].numpy()
        assert _cos(g, jgrads[k]) > 0.999, k
        assert np.abs(g - jgrads[k]).max() <= 1e-2 * np.abs(jgrads[k]).max(), k
    np.testing.assert_allclose(s1.u.numpy(), jstate1.u, atol=1e-6)
    np.testing.assert_allclose(s1.v.numpy(), jstate1.v, atol=1e-5)
    for tp, jp in zip(s1.params, jstate1.params):
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), jp[k], rtol=2e-4, atol=1e-6)
    assert s1.net_step == int(jstate1.net_step) == 1


# ---------------------------------------------------------------------------
# remat_inner and reverse_unroll against the plain step
# ---------------------------------------------------------------------------


def _step_inputs(eng):
    """A batch and the step's noise from the engine's own generator."""
    xb, yb = eng._sample_batch()
    eps_inner = [eng._sample_eps(eng.mc_samples) for _ in range(eng.inner_it)]
    return (xb, yb), (eps_inner, eng._sample_eps(eng.mc_samples))


@pytest.mark.parametrize("dataset,arch", [("four_blobs", "fn"), ("synth_mnist", "lenet")])
def test_remat_inner_equals_plain_step(dataset, arch):
    kw = {**KW, "architecture": arch}
    if arch == "lenet":
        kw.update(num_pseudo=4, mc_samples=2, inner_it=2, data_minibatch=16)
    data = read_dataset(dataset)
    plain = PSVI(data, method="psvi_alpha_v", device="cpu", **kw)
    remat = PSVI(data, method="psvi_alpha_v", device="cpu", remat_inner=True, **kw)
    batch, eps = _step_inputs(plain)
    g_plain, g_remat = _capture(plain), _capture(remat)
    s_p, aux_p = plain._nested_step(plain.state, batch=batch, eps=eps)
    s_r, aux_r = remat._nested_step(plain.state, batch=batch, eps=eps)
    assert set(g_plain) == set(g_remat) == {"u", "v", "alpha"}
    for k in g_plain:
        assert _rel(g_remat[k], g_plain[k]) <= 1e-6, k
    assert float(aux_r["outer_loss"]) == float(aux_p["outer_loss"])
    for k in ("u", "v", "alpha"):
        torch.testing.assert_close(getattr(s_r, k), getattr(s_p, k), rtol=0, atol=1e-7)


def test_reverse_unroll_equals_nested_step():
    eng = PSVI(read_dataset("four_blobs"), method="psvi_learn_v", device="cpu", **KW, **FN_KW)
    (xb, yb), (eps_inner, eps_outer) = _step_inputs(eng)
    st = eng.state
    grads = _capture(eng)
    _, aux = eng._nested_step(st, batch=(xb, yb), eps=(eps_inner, eps_outer))
    lr = eng.lr_net_sched(st.net_step)
    params0 = tree_map(lambda x: x.detach().requires_grad_(True), st.params)
    hg = H.reverse_unroll(
        lambda h: eng._run_inner(params0, h["u"], st.z, h["v"], st.alpha, lr, eps_inner)[0],
        lambda p, h: eng._outer_loss(p, eps_outer, h["u"], st.z, h["v"], st.alpha, xb, yb),
        {"u": st.u, "v": st.v})
    assert float(hg.outer_loss) == float(aux["outer_loss"])
    for k in ("u", "v"):
        assert _rel(hg.hyper_grads[k], grads[k]) <= 1e-6, k


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method,learn_z", [("psvi_no_iw", False), ("psvi_learn_v", True)])
def test_evaluation_matches_jax(method, learn_z):
    kw = {**KW, **FN_KW, "learn_z": learn_z}
    jeng = JPSVI(jax_read_dataset("four_blobs"), method=method, fused_inner=False, **kw)
    state = jeng.state
    if learn_z:  # soft labels away from one-hot
        rng = np.random.default_rng(0)
        z = np.asarray(state.z) + rng.standard_normal(np.shape(state.z)).astype(np.float32)
        state = state._replace(z=jax.numpy.asarray(z))
    key = jax.random.PRNGKey(9)
    n_test = int(jeng.x_test.shape[0])
    B = min(jeng.data_minibatch, n_test)
    n_batches = -(-n_test // B)
    draws = [_cv(_np_tree(jeng._sample_eps(k, jeng.mc_samples_eval)))
             for k in jax.random.split(key, n_batches)]
    jout = [float(x) for x in jeng._evaluate_fn(state, key, True)]

    peng = PSVI(read_dataset("four_blobs"), method=method, device="cpu", **kw)
    assert (peng.mc_samples, peng.mc_samples_eval) == (
        (1, 5) if method == "psvi_no_iw" else (6, 6))
    sizes = []

    def sample(S):
        sizes.append(S)
        return draws[len(sizes) - 1]

    peng._sample_eps = sample
    pout = [float(x) for x in peng._evaluate_fn(state_from_jax(_np_tree(state), device="cpu"))]
    assert sizes == [jeng.mc_samples_eval] * n_batches
    assert abs(pout[0] - jout[0]) <= 1.0 / n_test  # accuracy: one tie at most
    np.testing.assert_allclose(pout[1:], jout[1:], rtol=1e-4)


def test_regressor_evaluation_draws_mc_samples_eval():
    eng = make_psvi_engine(read_regression_dataset("sinus"), method="psvi_learn_v_regressor",
                           architecture="regressor_net", num_pseudo=4, mc_samples=3,
                           inner_it=1, device="cpu")
    eng.mc_samples_eval = 7
    sizes = []
    draw = eng._sample_eps
    eng._sample_eps = lambda S: sizes.append(S) or draw(S)
    eng._evaluate_fn(eng.state)
    assert sizes == [7]


# ---------------------------------------------------------------------------
# every method runs; the gates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", sorted(METHOD_SPECS))
def test_every_method_takes_a_step(method):
    spec = METHOD_SPECS[method]
    data = read_regression_dataset("sinus") if spec.regressor else read_dataset("halfmoon")
    arch = "regressor_net" if spec.regressor else "fn"
    eng = make_psvi_engine(data, method=method, architecture=arch, n_hidden=8, num_pseudo=6,
                           mc_samples=3, inner_it=2, data_minibatch=16, device="cpu")
    s0 = eng.state
    s1, aux = eng._step(s0)
    assert torch.isfinite(aux["outer_loss"])
    if spec.evaluate_only:
        assert eng._hyper_names() == []
        for k in ("u", "v", "z"):
            assert torch.equal(getattr(s1, k), getattr(s0, k))
    else:
        assert not torch.equal(s1.u if spec.learn_u else s1.v, s0.u if spec.learn_u else s0.v)
    assert s1.net_step == 1


@pytest.mark.parametrize("trainer", ["hyper", "joint"])
def test_evaluate_only_takes_the_net_only_step(trainer):
    """psvi_evaluate runs the plain nested step whatever the trainer, with no
    hyperparameters (JAX psvi.py:1263-1264, _hyper_tree :720-730)."""
    eng = PSVI(read_dataset("halfmoon"), method="psvi_evaluate", trainer=trainer,
               num_pseudo=6, mc_samples=3, inner_it=2, device="cpu")
    assert eng._step.__name__ == "_nested_step" and eng._hyper_names() == []
    assert eng.state.z.shape == (6, 2)  # one-hot soft labels
    batch, eps = _step_inputs(eng)
    s1, _ = eng._step(eng.state, batch=batch, eps=eps)
    # the net moves as a detached unroll of the same noise would move it
    params, _ = eng._run_inner(eng.state.params, eng.state.u, eng.state.z, eng.state.v,
                               eng.state.alpha, eng.lr_net_sched(0), eps[0], create_graph=False)
    for a, b in zip(s1.params, params):
        for k in a:
            assert torch.equal(a[k], b[k]) and not a[k].requires_grad


NEW_METHODS = [("psvi_ablated", {}), ("psvi_no_iw", {}), ("psvi_evaluate", {}),
               ("psvi_learn_v", {"learn_z": True}),
               ("psvi_learn_v", {"truncated": True, "truncated_K": 1}),
               ("psvi_learn_v", {"trainer": "hyper"})]


@pytest.mark.parametrize("method,extra", NEW_METHODS,
                         ids=["ablated", "no_iw", "evaluate", "learn_z", "truncated", "hyper"])
def test_fused_gates_refuse_the_new_paths(method, extra):
    dense = dict(num_pseudo=6, mc_samples=3, inner_it=2, device="cpu", architecture="fn")
    lenet = dict(num_pseudo=4, mc_samples=2, inner_it=2, data_minibatch=16, device="cpu",
                 architecture="lenet")
    for data, kw, gate in ((read_dataset("halfmoon"), dense, FN.supports),
                           (read_dataset("synth_mnist"), lenet, FL.supports)):
        base = PSVI(data, method="psvi_learn_v", **kw)
        assert gate(base)  # the same engine without the change is served
        assert not gate(PSVI(data, method=method, **kw, **extra))
        with pytest.raises(ValueError, match="fused_inner=True"):
            PSVI(data, method=method, fused_inner=True, **kw, **extra)


def test_engine_rejects_bad_options():
    data = read_dataset("halfmoon")
    kw = dict(num_pseudo=6, inner_it=3, device="cpu")
    with pytest.raises(ValueError, match="hypergrad_approx"):
        PSVI(data, trainer="hyper", hypergrad_approx="not_a_solver", **kw)
    for K in (0, 4):
        with pytest.raises(ValueError, match="truncated_K"):
            PSVI(data, truncated=True, truncated_K=K, **kw)
    with pytest.raises(ValueError, match="trainer"):
        PSVI(data, trainer="nope", **kw)
    with pytest.raises(ValueError, match="pallas"):
        PSVI(data, trainer="hyper", backend="pallas", **kw)
