"""The port's engine against the JAX engine.

- One ``_nested_step`` (plain autograd path) and one ``_nested_step_fused``
  (the fused path; on the CPU its plain versions) of the port, started
  from the JAX engine's state (``state_from_jax``) with the JAX step's
  batch and noise injected, match the JAX ``_nested_step`` (jitted) on the loss,
  the hypergradients handed to the hyper-Adam update, u, v, α and the
  parameters; for LeNet on synth_mnist, at the JAX tests' toy size,
  ``_nested_step`` and ``_nested_step_fused_lenet``. The dense methods
  include the four that fix u, v's rescaling or v's softmax
  (``psvi_fixed_u``, ``psvi_alpha_fixed_u``, ``psvi_no_rescaling``,
  ``psvi_free_v``); ``psvi_free_v`` starts with weights below one Adam
  step, so that the v ≥ 0 clamp after the step acts. The remaining
  methods run the plain step only (both fused gates refuse them, as JAX's
  do): ``psvi_ablated`` (the outer ELBO without importance weights),
  ``psvi_no_iw`` (one training sample), ``psvi_evaluate`` (net-only: u, v
  and z leave the step bit for bit) and ``psvi_learn_v`` with
  ``learn_z=True`` (one-hot soft labels learned through the KLDiv NLL).
- ``run_psvi`` on halfmoon logistic regression (M=30, 101 outer steps)
  lands in the documented accuracy band and returns the JAX engine's
  results-dict keys.
"""

import jax
import numpy as np
import pytest
import torch

from psvi_torch.data import read_dataset
from psvi_torch.inference.psvi import PSVI, run_psvi
from psvi_torch.utils.convert import params_from_jax, state_from_jax
from psvi_tpu.data import read_dataset as jax_read_dataset
from psvi_tpu.inference.psvi import PSVI as JPSVI

KW = dict(num_pseudo=20, mc_samples=6, inner_it=5, data_minibatch=64, init_sd=1e-3,
          num_epochs=1, log_every=1000, seed=0)
# LeNet at the toy size of tests/test_fused_lenet.py:27-39
LENET_KW = {**KW, "num_pseudo": 4, "mc_samples": 3, "inner_it": 3, "data_minibatch": 16}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _capture_hypergrads(eng):
    """Record the hypergradients each step hands to the hyper-Adam update."""
    seen = {}
    apply = eng._apply_hyper_updates

    def capture(state, grads):
        seen.clear()
        seen.update({k: np.asarray(g) for k, g in grads.items()})
        return apply(state, grads)

    eng._apply_hyper_updates = capture
    return seen


# XLA's cheaper compile for the JAX reference step
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _jax_nested_step(jeng, key, batch):
    """The JAX engine's ``_nested_step``, jitted, and the hypergradients it
    hands to the hyper-Adam update (none for a net-only step)."""
    apply = jeng._apply_hyper_updates

    def step(state, key, batch):
        seen = {}

        def capture(s, g):
            seen.update(g)
            return apply(s, g)

        jeng._apply_hyper_updates = capture
        try:
            out = jeng._nested_step(state, key, batch=batch)
        finally:
            jeng._apply_hyper_updates = apply
        return out, seen

    compiled = jax.jit(step).lower(jeng.state, key, batch).compile(
        compiler_options=FAST_COMPILE)
    (state1, aux), grads = compiled(jeng.state, key, batch)
    return state1, aux, _np_tree(grads)


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


# the hypergradients each method hands to the hyper-Adam update (JAX's
# _hyper_tree: u unless fixed, v where learned, α where learned, z where
# learned; none under evaluate_only)
HYPERS = {"psvi_alpha_v": {"u", "v", "alpha"}, "psvi_learn_v": {"u", "v"},
          "psvi_fixed_u": {"v"}, "psvi_alpha_fixed_u": {"v", "alpha"},
          "psvi_no_rescaling": {"u"}, "psvi_free_v": {"u", "v"},
          "psvi_ablated": {"u", "v"}, "psvi_no_iw": {"u", "v"}, "psvi_evaluate": set(),
          "psvi_learn_v+learn_z": {"u", "v", "z"}}
# methods no fused gate serves: the plain step alone
PLAIN_ONLY = {"psvi_ablated", "psvi_no_iw", "psvi_evaluate", "psvi_learn_v+learn_z"}


@pytest.mark.parametrize("method,dataset,arch", [
    ("psvi_alpha_v", "halfmoon", "logistic_regression"),
    ("psvi_learn_v", "four_blobs", "fn"),
    ("psvi_learn_v", "synth_mnist", "lenet"),
    ("psvi_fixed_u", "four_blobs", "fn"),
    ("psvi_alpha_fixed_u", "four_blobs", "fn"),
    ("psvi_no_rescaling", "halfmoon", "logistic_regression"),
    ("psvi_free_v", "four_blobs", "fn"),
    ("psvi_ablated", "four_blobs", "fn"),
    ("psvi_no_iw", "four_blobs", "fn"),
    ("psvi_evaluate", "four_blobs", "fn"),
    ("psvi_learn_v+learn_z", "four_blobs", "fn"),
])
def test_engine_step_matches_jax(method, dataset, arch):
    lenet = arch == "lenet"
    kw = LENET_KW if lenet else KW
    case = method
    if method.endswith("+learn_z"):
        method, kw = method.split("+")[0], {**kw, "learn_z": True}
    jeng = JPSVI(jax_read_dataset(dataset), method=method, architecture=arch,
                 fused_inner=False, **kw)
    if method == "psvi_free_v":
        # every other weight below one Adam step (lr0v = 1e-3): where g_v > 0
        # the step takes it negative and the v ≥ 0 clamp sets it to 0
        v = np.asarray(jeng.state.v).copy()
        v[::2] = 1e-4
        jeng.state = jeng.state._replace(v=jax.numpy.asarray(v))
    key = jax.random.PRNGKey(3)
    # the batch and the noise the JAX step draws from this key
    k_batch, k_inner, k_outer = jax.random.split(key, 3)
    xb, yb = jeng._sample_batch(k_batch)
    keys = jax.random.split(k_inner, jeng.inner_it)
    eps_inner = [_np_tree(jeng._sample_eps(k, jeng.mc_samples)) for k in keys]
    eps_outer = _np_tree(jeng._sample_eps(k_outer, jeng.mc_samples))
    jstate0 = _np_tree(jeng.state)
    jstate1, jaux, jgrads = _jax_nested_step(jeng, key, (xb, yb))
    assert set(jgrads) == HYPERS[case]
    if method == "psvi_free_v":
        clamped = np.asarray(jstate1.v) == 0.0
        assert clamped.any() and (np.asarray(jstate1.v) >= 0).all()

    peng = PSVI(read_dataset(dataset), method=method, architecture=arch, device="cpu", **kw)
    pgrads = _capture_hypergrads(peng)
    batch = (torch.tensor(np.asarray(xb)), torch.tensor(np.asarray(yb)))
    eps = ([params_from_jax(e, device="cpu") for e in eps_inner],
           params_from_jax(eps_outer, device="cpu"))
    fused = peng._nested_step_fused_lenet if lenet else peng._nested_step_fused
    steps = (peng._nested_step,) if case in PLAIN_ONLY else (peng._nested_step, fused)
    for step in steps:
        s0 = state_from_jax(jstate0, device="cpu")
        s1, aux = step(s0, batch=batch, eps=eps)
        # the hypergradients themselves, before the hyper-Adam step that
        # normalises them away: fp32 sums in another order through the
        # T-deep unroll (largest gap measured: ū of the LeNet kernel pair's
        # plain versions, 1 − cos 2.6e-6, max|Δ| 3.3e-3·max|ref|)
        assert set(pgrads) == set(jgrads)
        for k in sorted(set(jgrads) - {"alpha"}):
            assert _cos(pgrads[k], jgrads[k]) > 0.999, (step.__name__, k)
            assert (np.abs(pgrads[k] - jgrads[k]).max()
                    <= 1e-2 * np.abs(jgrads[k]).max()), (step.__name__, k)
        if "alpha" in jgrads:
            np.testing.assert_allclose(pgrads["alpha"], jgrads["alpha"], rtol=0.05)
        # outer loss and inner losses: fp32 sums in another order
        np.testing.assert_allclose(float(aux["outer_loss"]), float(jaux["outer_loss"]),
                                   rtol=2e-5 if lenet else 1e-5)
        np.testing.assert_allclose(aux["inner_losses"].numpy(),
                                   np.asarray(jaux["inner_losses"]), rtol=2e-5)
        if lenet:
            # tolerances of tests/test_fused_lenet.py:198-214: near-zero
            # hypergradient entries make the sqrt-normalised hyper-Adam step
            # sensitive to reassociation, so u, v agree at the step's scale
            np.testing.assert_allclose(s1.u.numpy(), np.asarray(jstate1.u), atol=1e-3)
            np.testing.assert_allclose(s1.v.numpy(), np.asarray(jstate1.v), atol=1e-3)
            for tp, jp in zip(s1.params, jstate1.params):
                assert set(tp) == set(jp)
                for k in tp:
                    np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=3e-5)
        else:
            # one hyper-Adam step of size ~lr from identical starts: u, v, α
            # agree to well under the step (lr0u = 1e-4, lr0v = lr0alpha = 1e-3)
            np.testing.assert_allclose(s1.u.numpy(), np.asarray(jstate1.u), atol=1e-6)
            np.testing.assert_allclose(s1.v.numpy(), np.asarray(jstate1.v), atol=1e-5)
            np.testing.assert_allclose(s1.alpha.numpy(), np.asarray(jstate1.alpha), atol=1e-5)
            np.testing.assert_allclose(s1.z.numpy(), np.asarray(jstate1.z), atol=1e-5)
            if method == "psvi_evaluate":  # net-only: the pseudodata stay as they were
                for k in ("u", "v", "z", "alpha"):
                    assert torch.equal(getattr(s1, k), getattr(s0, k)), k
            if method == "psvi_free_v":  # the clamp, on the same entries
                np.testing.assert_array_equal(s1.v.numpy() == 0.0, clamped)
            # paramsT: tolerances of tests/test_fused_nested.py
            for tp, jp in zip(s1.params, jstate1.params):
                for k in tp:
                    np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                               rtol=2e-4, atol=1e-6)
        assert s1.net_step == int(jstate1.net_step) == 1


def test_state_from_jax_roundtrip():
    jeng = JPSVI(jax_read_dataset("halfmoon"), method="psvi_learn_v", fused_inner=False, **KW)
    st = state_from_jax(_np_tree(jeng.state), device="cpu")
    np.testing.assert_array_equal(st.u.numpy(), np.asarray(jeng.state.u))
    np.testing.assert_array_equal(st.params[0]["mu_w"].numpy(),
                                  np.asarray(jeng.state.params[0]["mu_w"]))
    assert st.opt_u.count == 0 and st.net_step == 0
    # the port's own init draws the same pseudodata as the JAX engine
    peng = PSVI(read_dataset("halfmoon"), method="psvi_learn_v", device="cpu", **KW)
    np.testing.assert_array_equal(peng.state.u.numpy(), np.asarray(jeng.state.u))
    np.testing.assert_array_equal(peng.state.z.numpy(), np.asarray(jeng.state.z))
    assert peng.chosen_indices == jeng.chosen_indices


# the results-dict keys of the JAX engine's run_psvi (psvi_tpu/inference/
# psvi.py:1713-1720), plus 'alpha' for the learn_alpha methods
JAX_RESULT_KEYS = {"accs", "nlls", "csizes", "times", "elbos", "went", "ness", "vent",
                   "vs", "avg_epoch_time", "gpu_memory", "chosen_indices"}


def test_run_psvi_halfmoon_logreg_accuracy_band():
    res = run_psvi(read_dataset("halfmoon"), method="psvi_learn_v", num_pseudo=30,
                   mc_samples=10, architecture="logistic_regression", inner_it=10,
                   data_minibatch=128, init_sd=1e-3, num_epochs=101, log_every=50,
                   seed=0, device="cpu")
    assert set(res) == JAX_RESULT_KEYS
    assert len(res["accs"]) == 3 and len(res["vs"]) == 3
    # BENCHMARKS.md: psvi_learn_v M=30 0.797 ± 0.030 (3 trials); 3 sd band
    assert abs(res["accs"][-1] - 0.797) <= 0.09
    assert all(np.isfinite(res["nlls"]))


def test_run_psvi_alpha_keys():
    res = run_psvi(read_dataset("halfmoon"), method="psvi_alpha_v", num_pseudo=8,
                   mc_samples=4, inner_it=2, data_minibatch=32, num_epochs=3,
                   log_every=2, seed=1, device="cpu", fused_inner=True)
    assert set(res) == JAX_RESULT_KEYS | {"alpha"}
    assert len(res["alpha"]) == 2
