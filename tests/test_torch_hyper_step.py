"""The hyper trainer's step (``PSVI._hyper_step``) against the JAX engine's.

One port step from the JAX engine's state, with the JAX step's batch and
every noise draw of its inner solve, its outer loss and its solver's
Jacobian products injected (the solvers' tags name JAX's keys: see
``psvi_torch/ops/hypergrad.py``), against the jitted JAX step, for each
solver at ``hyper_K=5`` on the dense four_blobs fn, on halfmoon logistic
regression with α, and on the sinus regressor (whose hyper tree holds z),
and for CG on the normal equations at a LeNet toy size. Compared: the
outer loss, the hypergradients handed to the hyper-Adam update, the inner
solution and the post-step u, v, z, α. In fp32 on both sides the
hypergradients lie at most 5.1e-5·max|ref| apart (LeNet's g_v; the dense
cases under 1.8e-5), so the float32 run is the reference here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psvi_torch.data import read_dataset, read_regression_dataset
from psvi_torch.inference.psvi import PSVI, PSVIRegressor
from psvi_torch.utils.convert import params_from_jax, state_from_jax
from psvi_tpu.data import read_dataset as jax_read_dataset
from psvi_tpu.data import read_regression_dataset as jax_read_regression_dataset
from psvi_tpu.inference.psvi import PSVI as JPSVI
from psvi_tpu.inference.psvi import PSVIRegressor as JPSVIRegressor

KW = dict(num_pseudo=20, mc_samples=6, inner_it=5, data_minibatch=64, init_sd=1e-3,
          num_epochs=1, log_every=1000, seed=0)
# name: (dataset, architecture, method, engine options, regression)
CASES = {
    "four_blobs-fn": ("four_blobs", "fn", "psvi_learn_v", KW, False),
    "halfmoon-logreg-alpha": ("halfmoon", "logistic_regression", "psvi_alpha_v", KW, False),
    "sinus-regressor": ("sinus", "regressor_net", "psvi_learn_v_regressor",
                        {**KW, "num_pseudo": 10, "n_hidden": 20}, True),
    "synth_mnist-lenet": ("synth_mnist", "lenet", "psvi_learn_v",
                          {**KW, "num_pseudo": 8, "mc_samples": 2, "inner_it": 2,
                           "data_minibatch": 16}, False),
}
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
SOLVERS = ("cg_normaleq", "fixed_point", "neumann")
PARAMS = [(c, s) for c in CASES if c != "synth_mnist-lenet" for s in SOLVERS] + [
    ("synth_mnist-lenet", "cg_normaleq")]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def jax_ift_keys(solver, k_ift, K):
    """The key of each noise tag of the port's solver, as JAX's solver
    derives it from the step's ``k_ift`` (psvi_tpu/ops/hypergrad.py)."""
    if solver == "cg_normaleq":
        k_vjp, k_jvp = jax.random.split(k_ift)
        return {"vjp": k_vjp,
                **{("jvp", i): jax.random.fold_in(k_jvp, jnp.int32(i)) for i in range(-1, K)}}
    if solver == "fixed_point":
        return {i: jax.random.fold_in(k_ift, jnp.int32(i)) for i in range(K + 1)}
    return {"vjp": k_ift}


def _jax_hyper_step(jeng, state, key, batch):
    """The JAX step, jitted, and the hypergradients it hands to the
    hyper-Adam update."""
    apply = jeng._apply_hyper_updates

    def step(state, key, batch):
        seen = {}

        def capture(s, g):
            seen.update(g)
            return apply(s, g)

        jeng._apply_hyper_updates = capture
        try:
            out = jeng._hyper_step(state, key, batch)
        finally:
            jeng._apply_hyper_updates = apply
        return out, seen

    # XLA's cheaper compile: the LeNet step compiles in about half the time
    compiled = jax.jit(step).lower(state, key, batch).compile(compiler_options=FAST_COMPILE)
    (state1, aux), grads = compiled(state, key, batch)
    return _np_tree(state1), _np_tree(aux), _np_tree(grads)


@pytest.mark.parametrize("case,solver", PARAMS)
def test_hyper_step_matches_jax(case, solver):
    dataset, arch, method, kw, reg = CASES[case]
    K = 2 if arch == "lenet" else 5
    kw = {**kw, "trainer": "hyper", "hypergrad_approx": solver, "hyper_K": K}
    jcls, pcls = (JPSVIRegressor, PSVIRegressor) if reg else (JPSVI, PSVI)
    jdata = (jax_read_regression_dataset if reg else jax_read_dataset)(dataset)
    jeng = jcls(jdata, method=method, architecture=arch, fused_inner=False, **kw)
    # the batch and the noise the JAX step draws from this key
    key = jax.random.PRNGKey(5)
    k_batch, k_inner, k_ift, k_outer = jax.random.split(key, 4)
    xb, yb = jeng._sample_batch(k_batch)
    S = jeng.mc_samples
    eps_inner = [_np_tree(jeng._sample_eps(k, S)) for k in jax.random.split(k_inner, jeng.inner_it)]
    eps_outer = _np_tree(jeng._sample_eps(k_outer, S))
    draws = {tag: _np_tree(jeng._sample_eps(k, S))
             for tag, k in jax_ift_keys(solver, k_ift, K).items()}
    jstate0 = _np_tree(jeng.state)
    jstate1, jaux, jgrads = _jax_hyper_step(jeng, jeng.state, key, (xb, yb))

    pdata = (read_regression_dataset if reg else read_dataset)(dataset)
    peng = pcls(pdata, method=method, architecture=arch, device="cpu", **kw)
    assert peng._step.__name__ == "_hyper_step"
    pgrads = {}
    apply = peng._apply_hyper_updates

    def capture(state, grads):
        pgrads.update({k: g.detach().numpy() for k, g in grads.items()})
        return apply(state, grads)

    peng._apply_hyper_updates = capture
    cv = lambda tree: params_from_jax(tree, device="cpu")  # noqa: E731
    s1, aux = peng._hyper_step(
        state_from_jax(jstate0, device="cpu"),
        batch=(torch.tensor(np.asarray(xb)), torch.tensor(np.asarray(yb))),
        eps=([cv(e) for e in eps_inner], cv(eps_outer), {t: cv(e) for t, e in draws.items()}))

    np.testing.assert_allclose(float(aux["outer_loss"]), float(jaux["outer_loss"]), rtol=1e-5)
    np.testing.assert_allclose(aux["inner_losses"].numpy(), jaux["inner_losses"], rtol=2e-5)
    # the hypergradients at the bars of tests/test_torch_engine.py
    assert set(pgrads) == set(jgrads) and {"u", "v"} <= set(jgrads)
    for k in sorted(set(jgrads) - {"alpha"}):
        assert _cos(pgrads[k], jgrads[k]) > 0.999, k
        assert np.abs(pgrads[k] - jgrads[k]).max() <= 1e-2 * np.abs(jgrads[k]).max(), k
    if "alpha" in jgrads:
        np.testing.assert_allclose(pgrads["alpha"], jgrads["alpha"], rtol=0.05)
    # one hyper-Adam step of size ~lr from identical starts
    for k, atol in (("u", 1e-6), ("v", 1e-5), ("z", 1e-5), ("alpha", 1e-5)):
        np.testing.assert_allclose(getattr(s1, k).numpy(), getattr(jstate1, k), atol=atol)
    # the inner solution, not differentiated, at the constant lr0net
    for tp, jp in zip(s1.params, jstate1.params):
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), jp[k], rtol=2e-4, atol=1e-6)
    assert s1.net_step == int(jstate1.net_step) == 0  # the hyper step leaves StepLR alone
