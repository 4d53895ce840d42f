"""The ResNet-shaped toy (``test_torch_zoo_engine.resnet_toy``: the stem,
an identity and a strided basic block, BatchNorm throughout, the average
pool and the dense head) through the port's engine, against the JAX engine.

BatchNorm normalises with the statistics of the batch it is handed, so the
way an engine groups points into forwards is part of the function: the
outer ELBO runs one forward over cat(u, x_batch), the inner ELBO one over u
alone, the evaluation one over cat(u, x_test batch) with the last test
batch padded by repeated points. Here:

- one ``_nested_step`` against the jitted JAX step (tolerances of
  ``test_torch_zoo_engine.py``'s conv nets), plain, under ``remat_inner``
  (against JAX's remat step), and under bf16 (against JAX's bf16 step:
  u within 1e-2, as ``tests/test_torch_engine_options.py``'s bf16 LeNet
  step; the losses at rtol 2⁻⁷, two bf16 runs each within about a bf16
  unit roundoff, 2⁻⁸, of the fp32 step: here the port's second inner loss
  lies 3.8e-3 from its fp32 step's, JAX's 7.9e-4, 3.0e-3 apart);
- the evaluation and a checkpoint round trip are in
  ``test_torch_zoo_eval.py``.
"""

import torch_threads  # noqa: F401  (torch on this worker's share of the cores)

import jax
import numpy as np
import pytest
import torch

from psvi_torch.data import read_dataset
from psvi_torch.inference.psvi import PSVI
from psvi_torch.utils.convert import state_from_jax
from psvi_tpu.data import read_dataset as jax_read_dataset
from psvi_tpu.inference.psvi import PSVI as JPSVI
from test_torch_engine import _jax_nested_step, _np_tree
from test_torch_zoo_engine import TOY_KW, check_nested_step, jax_step_inputs, toy_zoo  # noqa: F401

RES_KW = {**TOY_KW, "architecture": "resnet_toy"}


@pytest.mark.parametrize("variant", ["plain", "remat_inner"])
def test_resnet_toy_nested_step_matches_jax(toy_zoo, variant):  # noqa: F811
    kw = {**RES_KW, **({"remat_inner": True} if variant == "remat_inner" else {})}
    peng, _ = check_nested_step("synth_cifar", kw, conv=True)
    assert peng.remat_inner == (variant == "remat_inner")
    assert {type(l).__name__ for l in peng.net.layers} >= {"BatchNorm2d", "Residual",
                                                           "AvgPool2d"}


def test_resnet_toy_bf16_nested_step_matches_jax(toy_zoo):  # noqa: F811
    kw = {**RES_KW, "compute_dtype": "bfloat16"}
    jeng = JPSVI(jax_read_dataset("synth_cifar"), fused_inner=False, **kw)
    key = jax.random.PRNGKey(3)
    jbatch, batch, eps = jax_step_inputs(jeng, key)
    jstate0 = _np_tree(jeng.state)
    jstate1, jaux, _ = _jax_nested_step(jeng, key, jbatch)
    peng = PSVI(read_dataset("synth_cifar"), device="cpu", **kw)
    convs = [l for l in peng.net.modules() if hasattr(l, "compute_dtype")]
    assert len(convs) == 7 and all(l.compute_dtype == "bfloat16" for l in convs)
    s1, aux = peng._nested_step(state_from_jax(jstate0, device="cpu"), batch=batch, eps=eps)
    assert all(torch.isfinite(x).all() for x in (s1.u, s1.v, aux["outer_loss"]))
    assert np.abs(s1.u.numpy() - np.asarray(jstate1.u)).max() < 1e-2
    np.testing.assert_allclose(float(aux["outer_loss"]), float(jaux["outer_loss"]),
                               rtol=2.0 ** -7)
    np.testing.assert_allclose(aux["inner_losses"].numpy(), np.asarray(jaux["inner_losses"]),
                               rtol=2.0 ** -7)
