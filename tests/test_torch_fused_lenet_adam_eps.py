"""The LeNet inner unroll at the engine's Adam ε = 1e-8, against JAX.

The other unroll comparisons with JAX run at ``UNROLL_ADAM_EPS`` = 1e-5 on
jittered parameters (``test_torch_fused_lenet.py``). Here, at 1e-8, the
engine's own ε:

- on the JAX engine's initial state (init_sd 1e-3, so every ρ at
  softplus⁻¹(1e-3)) with noise and cotangents from NumPy, the plain versions
  in ``LeNetUnroll`` and the autograd oracle match JAX
  ``make_fused_unroll(cfg, backend="xla")`` at the tolerances of
  ``test_unroll_matches_jax``;
- on the jittered inputs, the port's fp32 hypergradients are no farther
  from the float64 ones (the port's plain versions in float64, held to the
  autograd oracle in ``test_torch_fused_lenet_variants.py``) than JAX's own
  fp32 hypergradients are: the gap there is fp32 rounding that both
  implementations share, not a difference between them.
"""

import torch_threads  # noqa: F401  (torch on this worker's share of the cores)

import numpy as np

from psvi_tpu.data import read_dataset as jax_read_dataset
from psvi_tpu.inference.psvi import PSVI as JPSVI
from test_torch_fused_lenet import (_cfgs, _check_unroll_against_jax, _cos, _inputs, _jax_unroll,
                                    _port_unroll)
from test_torch_fused_lenet_variants import _grads64

ENGINE_ADAM_EPS = 1e-8


def _engine_init_inputs(cfg, seed=0):
    """The JAX engine's initial parameters, coreset and weights, with the
    noise and cotangents of ``_inputs``."""
    a = _inputs(cfg, seed)
    jeng = JPSVI(jax_read_dataset("synth_mnist"), method="psvi_learn_v", architecture="lenet",
                 num_pseudo=cfg.M, mc_samples=cfg.S, inner_it=cfg.T, data_minibatch=16,
                 init_sd=1e-3, num_epochs=1, log_every=1000, seed=0, fused_inner=False)
    st = jeng.state
    a.update(layers=[{k: np.asarray(x) for k, x in st.params[i].items()}
                     for i in jeng.net.variational_layers],
             u=np.asarray(st.u), z=np.asarray(st.z), v=np.asarray(st.v))
    return a


def test_unroll_matches_jax_at_engine_init():
    _check_unroll_against_jax(True, False, ("torch", "autograd"), seed=0,
                              adam_eps=ENGINE_ADAM_EPS, inputs=_engine_init_inputs)


def test_fp32_gap_at_engine_adam_eps_is_shared_with_jax():
    cfg, jcfg = _cfgs(adam_eps=ENGINE_ADAM_EPS)
    a = _inputs(cfg, seed=2)
    jax32 = _jax_unroll(cfg, jcfg, a)[2:]
    port32 = _port_unroll(cfg, a, "torch")[2:]
    ref64 = _grads64(cfg, a, "torch")[3:5]
    gaps = {}
    for name, x, j, r in zip("uv", port32, jax32, ref64):
        gaps[name] = 1 - _cos(j, r)
        assert 1 - _cos(x, r) <= 2 * gaps[name], name
        assert np.abs(x - r).max() <= 2 * np.abs(j - r).max(), name
    # JAX's own fp32 ū misses the 0.9999 cosine of the JAX comparisons
    # against float64 here, so those comparisons run at UNROLL_ADAM_EPS
    assert gaps["u"] > 1e-4
