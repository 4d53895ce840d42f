"""The ResNet-shaped toy of ``test_torch_zoo_engine.py`` through the
port's evaluation and checkpoints, against the JAX engine.

BatchNorm normalises with the statistics of the batch it is handed, so the
evaluation's grouping (one forward over cat(u, x_test batch), the last
test batch padded by repeated points) is part of the function:

- the evaluation against JAX's on JAX's noise, from a state off its init,
  with a padded last batch: the accuracy equal, the NLL and the IW
  diagnostics at rtol 1e-5; and a split forward is another function;
- a checkpoint round trip of a state carried across from JAX: every leaf
  bit for bit, and the next step from the loaded engine bit for bit;
- a checkpoint of the older leaf order (no ``layout`` entry, dicts in the
  order the layers built them) is refused by name.
"""

import jax
import numpy as np
import pytest
import torch

from psvi_torch.data import read_dataset
from psvi_torch.inference.psvi import PSVI
from psvi_torch.utils.convert import params_from_jax, state_from_jax
from psvi_torch.utils.tree import tree_leaves
from psvi_tpu.data import read_dataset as jax_read_dataset
from psvi_tpu.inference.psvi import PSVI as JPSVI
from test_torch_engine import _np_tree
from test_torch_zoo_engine import TOY_KW, toy_zoo  # noqa: F401

RES_KW = {**TOY_KW, "architecture": "resnet_toy"}


def _moved(state, seed=0):
    """The state with every parameter moved off its init."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        _np_tree(state.params))
    return _np_tree(state)._replace(params=params)


def test_resnet_toy_evaluation_matches_jax(toy_zoo):  # noqa: F811
    kw = {**RES_KW, "data_minibatch": 48, "mc_samples": 3}
    jeng = JPSVI(jax_read_dataset("synth_cifar"), fused_inner=False, **kw)
    peng = PSVI(read_dataset("synth_cifar"), device="cpu", **kw)
    # 100 test points in batches of 48: the last batch padded by 44 repeats
    jeng.x_test, jeng.y_test = jeng.x_test[:100], jeng.y_test[:100]
    peng.x_test, peng.y_test = peng.x_test[:100], peng.y_test[:100]
    # a state off its init, so that the predictions are not uniform
    jstate1 = _moved(jeng.state)
    k_eval = jax.random.PRNGKey(11)
    S, n_batches = jeng.mc_samples_eval, 3
    draws = [params_from_jax(_np_tree(jeng._sample_eps(k, S)), device="cpu")
             for k in jax.random.split(k_eval, n_batches)]
    jout = [float(x) for x in jeng._evaluate_fn(jax.tree_util.tree_map(jax.numpy.asarray, jstate1),
                                                 k_eval, True)]
    it = iter(draws)
    peng._sample_eps = lambda S: next(it)
    pstate = state_from_jax(_np_tree(jstate1), device="cpu")
    pout = [float(x) for x in peng._evaluate_fn(pstate)]
    assert next(it, None) is None  # one draw a batch, as JAX's scan
    assert pout[0] == jout[0] and 0.0 < jout[0] < 1.0
    np.testing.assert_allclose(pout[1:], jout[1:], rtol=1e-5)
    # under BatchNorm a forward over u and the batch apart is another function
    u, xb = pstate.u, peng.x_test[:48]
    whole = peng.net.apply(pstate.params, draws[0], torch.cat([u, xb]))
    split = torch.cat([peng.net.apply(pstate.params, draws[0], u),
                       peng.net.apply(pstate.params, draws[0], xb)], dim=1)
    assert (whole - split).abs().max() > 1e-3 * whole.abs().max()


def test_resnet_toy_checkpoint_roundtrip(toy_zoo, tmp_path):  # noqa: F811
    jeng = JPSVI(jax_read_dataset("synth_cifar"), fused_inner=False, **RES_KW)
    jstate1 = _moved(jeng.state)
    first = PSVI(read_dataset("synth_cifar"), device="cpu", **RES_KW)
    # JAX's trees arrive with their dict keys sorted ({beta, gamma}), the
    # port's layers build theirs in another order ({gamma, beta})
    first.state = state_from_jax(_np_tree(jstate1), device="cpu")
    assert list(first.state.params[1]) == ["beta", "gamma"]
    assert list(first.net.init(torch.Generator())[1]) == ["gamma", "beta"]
    first.state, _ = first._step(first.state)
    path = str(tmp_path / "ckpt.npz")
    first.save_checkpoint(path)
    resumed = PSVI(read_dataset("synth_cifar"), device="cpu", **RES_KW)
    resumed.load_checkpoint(path)
    la, lb = tree_leaves(first.state), tree_leaves(resumed.state)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b
    for k in ("gamma", "beta"):  # by name, whatever the dicts' order
        assert torch.equal(first.state.params[4]["body"][1][k], resumed.state.params[4]["body"][1][k])
    sa, _ = first._step(first.state)
    sb, _ = resumed._step(resumed.state)
    for a, b in zip(tree_leaves(sa), tree_leaves(sb)):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b


def test_resnet_toy_checkpoint_old_layout_refused(toy_zoo, tmp_path):  # noqa: F811
    eng = PSVI(read_dataset("synth_cifar"), device="cpu", **RES_KW)
    path = tmp_path / "ckpt.npz"
    eng.save_checkpoint(str(path))
    with np.load(path) as d:
        arrays = {k: d[k] for k in d.files if k != "layout"}
    assert "extra_gen" in arrays
    np.savez(tmp_path / "other.npz", **arrays)
    with pytest.raises(ValueError, match="older leaf layout"):
        PSVI(read_dataset("synth_cifar"), device="cpu", **RES_KW).load_checkpoint(
            str(tmp_path / "other.npz"))
