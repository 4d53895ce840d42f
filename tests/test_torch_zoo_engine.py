"""The model zoo through the port's engine, against the JAX engine.

- One ``_nested_step`` of each family at toy sizes against the jitted JAX
  step, from the JAX engine's state (``state_from_jax``) with the JAX
  step's batch and noise injected: ``fn2`` (full covariance) on halfmoon,
  and an AlexNet-shaped toy (the same layer types as ``make_alexnet`` at
  narrow widths: conv, 3/2 max-pool with padding, LRN, dense heads) on
  synth_cifar. The ResNet-shaped toy is in ``test_torch_zoo_resnet.py``.
  One step only: AlexNet diverges at tiny configs in JAX too.
- One ``fn2`` hyper step (CG on the normal equations, K=3) against JAX's.
- One joint step on the AlexNet-shaped toy with ``backend="pallas"``:
  its dense heads through B3's plain version (the CPU), against JAX's.
- The gates: B1 refuses ``fn2`` and the full-covariance logreg, B2 refuses
  AlexNet and ResNet, ``packed=True`` is refused where JAX refuses it, and
  under ``backend="pallas"`` every dense head of AlexNet and ResNet takes
  B3.

The toy nets enter both engines through their ``set_up_model``, patched
for the test. Tolerances are those of ``tests/test_torch_engine.py``: the
hypergradients handed to the hyper-Adam update at cosine > 0.999 and max
|Δ| ≤ 1e-2·max |ref| (fp32 sums in another order through the unroll); the
losses at rtol 1e-5 (2e-5 for the conv nets, as LeNet's); after the step
u, v at 1e-6 and 1e-5 on the dense nets and 1e-3 on the conv nets, the
parameters at rtol 2e-4, atol 1e-6 on the dense nets and atol 3e-5 on the
conv nets.
"""

import jax
import numpy as np
import pytest
import torch

import psvi_torch.inference.psvi as TP
import psvi_tpu.inference.psvi as JP
from psvi_torch.data import read_dataset
from psvi_torch.inference.psvi import PSVI
from psvi_torch.models import layers as TL
from psvi_torch.models import networks as TN
from psvi_torch.ops import fused_lenet as FL
from psvi_torch.ops import fused_nested as FN
from psvi_torch.utils.convert import params_from_jax, state_from_jax
from psvi_tpu.data import read_dataset as jax_read_dataset
from psvi_tpu.inference.psvi import PSVI as JPSVI
from psvi_tpu.models import layers as JL
from psvi_tpu.models import networks as JN
from test_torch_engine import _capture_hypergrads, _cos, _jax_nested_step, _np_tree
from test_torch_hyper_step import _jax_hyper_step, jax_ift_keys

# the conv families' toy size: LeNet's of tests/test_torch_engine.py
TOY_KW = dict(method="psvi_learn_v", num_pseudo=4, mc_samples=2, inner_it=2,
              data_minibatch=8, init_sd=1e-3, num_epochs=1, log_every=1000, seed=0)
FN2_KW = dict(method="psvi_learn_v", architecture="fn2", n_hidden=5, num_pseudo=10,
              mc_samples=4, inner_it=3, data_minibatch=32, init_sd=1e-3, num_epochs=1,
              log_every=1000, seed=0)


def alexnet_toy(L):
    """``make_alexnet``'s layer types at narrow widths, for 3×32×32 inputs."""
    lrn = dict(alpha=0.001 / 9.0, beta=0.75, k=1.0)
    return L.Sequential((
        L.VIConv2d(3, 4, 5, stride=1, padding=2), L.MaxPool2d(3, 2, padding=1), L.ReLU(),
        L.LocalResponseNorm(4, **lrn), L.VIConv2d(4, 4, 5, padding=2), L.ReLU(),
        L.LocalResponseNorm(4, **lrn), L.MaxPool2d(3, 2, padding=1), L.Flatten(),
        L.VILinear(256, 16, init_sd=1e-3), L.ReLU(), L.VILinear(16, 8, init_sd=1e-3),
        L.ReLU(), L.VILinear(8, 10),
    ))


def resnet_toy(L, N):
    """``make_resnet``'s layer types at planes 4-8: the stem, an identity
    basic block and a strided one with its projection shortcut, the 4×4
    average pool and the dense head, for 3×32×32 inputs."""
    b1, _ = N._basic_block(4, 4, 1, 0.1)
    b2, _ = N._basic_block(4, 8, 2, 0.1)
    return L.Sequential((
        N._conv3x3(3, 4, 1, 0.1), L.BatchNorm2d(4), L.ReLU(), b1, b2,
        L.AvgPool2d(4), L.Flatten(), L.VILinear(128, 10, init_sd=0.1),
    ))


TOYS = {"alexnet_toy": lambda L, N: alexnet_toy(L), "resnet_toy": resnet_toy}


@pytest.fixture
def toy_zoo(monkeypatch):
    """Both engines' ``set_up_model`` also builds the toy nets by name."""
    def patched(real, L, N):
        def set_up(architecture, *args, **kw):
            if architecture in TOYS:
                return TOYS[architecture](L, N)
            return real(architecture, *args, **kw)
        return set_up

    monkeypatch.setattr(JP, "set_up_model", patched(JP.set_up_model, JL, JN))
    monkeypatch.setattr(TP, "set_up_model", patched(TP.set_up_model, TL, TN))


def _t(x):
    return torch.tensor(np.asarray(x, dtype=np.float32))


def jax_step_inputs(jeng, key):
    """The batch and noise the JAX nested step draws from ``key``, as the
    port's injected batch and noise."""
    k_batch, k_inner, k_outer = jax.random.split(key, 3)
    xb, yb = jeng._sample_batch(k_batch)
    cv = lambda tree: params_from_jax(_np_tree(tree), device="cpu")  # noqa: E731
    eps_inner = [cv(jeng._sample_eps(k, jeng.mc_samples))
                 for k in jax.random.split(k_inner, jeng.inner_it)]
    return (xb, yb), (_t(xb), _t(yb)), (eps_inner, cv(jeng._sample_eps(k_outer,
                                                                      jeng.mc_samples)))


def check_nested_step(dataset, kw, conv):
    """One port ``_nested_step`` against the jitted JAX step (module
    docstring's tolerances; ``conv`` picks the conv nets')."""
    jeng = JPSVI(jax_read_dataset(dataset), fused_inner=False, **kw)
    key = jax.random.PRNGKey(3)
    jbatch, batch, eps = jax_step_inputs(jeng, key)
    jstate0 = _np_tree(jeng.state)
    jstate1, jaux, jgrads = _jax_nested_step(jeng, key, jbatch)
    peng = PSVI(read_dataset(dataset), device="cpu", **kw)
    assert peng._step.__name__ == "_nested_step"
    pgrads = _capture_hypergrads(peng)
    s1, aux = peng._nested_step(state_from_jax(jstate0, device="cpu"), batch=batch, eps=eps)
    assert set(pgrads) == set(jgrads) == {"u", "v"}
    for k in jgrads:
        assert _cos(pgrads[k], jgrads[k]) > 0.999, k
        assert np.abs(pgrads[k] - jgrads[k]).max() <= 1e-2 * np.abs(jgrads[k]).max(), k
    rtol = 2e-5 if conv else 1e-5
    np.testing.assert_allclose(float(aux["outer_loss"]), float(jaux["outer_loss"]), rtol=rtol)
    np.testing.assert_allclose(aux["inner_losses"].numpy(), np.asarray(jaux["inner_losses"]),
                               rtol=2e-5)
    np.testing.assert_allclose(s1.u.numpy(), np.asarray(jstate1.u), atol=1e-3 if conv else 1e-6)
    np.testing.assert_allclose(s1.v.numpy(), np.asarray(jstate1.v), atol=1e-3 if conv else 1e-5)
    tl = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda x: x.numpy(), s1.params))
    jl = jax.tree_util.tree_leaves(jstate1.params)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        if conv:
            np.testing.assert_allclose(a, np.asarray(b), atol=3e-5)
        else:
            np.testing.assert_allclose(a, np.asarray(b), rtol=2e-4, atol=1e-6)
    assert s1.net_step == int(jstate1.net_step) == 1
    return peng, s1


def test_fn2_nested_step_matches_jax():
    peng, _ = check_nested_step("halfmoon", FN2_KW, conv=False)
    assert [type(l).__name__ for l in peng.net.layers] == [
        "VILinearFullCov", "ReLU", "VILinearFullCov"]


def test_alexnet_toy_nested_step_matches_jax(toy_zoo):
    peng, _ = check_nested_step("synth_cifar", {**TOY_KW, "architecture": "alexnet_toy"},
                                conv=True)
    assert not FL.supports(peng) and not FN.supports(peng)


def test_fn2_hyper_step_matches_jax():
    K = 3
    kw = {**FN2_KW, "trainer": "hyper", "hypergrad_approx": "cg_normaleq", "hyper_K": K}
    jeng = JPSVI(jax_read_dataset("halfmoon"), fused_inner=False, **kw)
    key = jax.random.PRNGKey(5)
    k_batch, k_inner, k_ift, k_outer = jax.random.split(key, 4)
    xb, yb = jeng._sample_batch(k_batch)
    S = jeng.mc_samples
    cv = lambda tree: params_from_jax(_np_tree(tree), device="cpu")  # noqa: E731
    eps = ([cv(jeng._sample_eps(k, S)) for k in jax.random.split(k_inner, jeng.inner_it)],
           cv(jeng._sample_eps(k_outer, S)),
           {t: cv(jeng._sample_eps(k, S))
            for t, k in jax_ift_keys("cg_normaleq", k_ift, K).items()})
    jstate0 = _np_tree(jeng.state)
    jstate1, jaux, jgrads = _jax_hyper_step(jeng, jeng.state, key, (xb, yb))
    peng = PSVI(read_dataset("halfmoon"), device="cpu", **kw)
    assert peng._step.__name__ == "_hyper_step"
    pgrads = _capture_hypergrads(peng)
    s1, aux = peng._hyper_step(state_from_jax(jstate0, device="cpu"), batch=(_t(xb), _t(yb)),
                               eps=eps)
    np.testing.assert_allclose(float(aux["outer_loss"]), float(jaux["outer_loss"]), rtol=1e-5)
    assert set(pgrads) == set(jgrads) == {"u", "v"}
    for k in jgrads:
        assert _cos(pgrads[k], jgrads[k]) > 0.999, k
        assert np.abs(pgrads[k] - jgrads[k]).max() <= 1e-2 * np.abs(jgrads[k]).max(), k
    np.testing.assert_allclose(s1.u.numpy(), jstate1.u, atol=1e-6)
    np.testing.assert_allclose(s1.v.numpy(), jstate1.v, atol=1e-5)
    for tp, jp in zip(s1.params, jstate1.params):
        for k in jp:
            np.testing.assert_allclose(tp[k].numpy(), jp[k], rtol=2e-4, atol=1e-6)


def test_alexnet_toy_joint_step_through_plain_b3_matches_jax(toy_zoo):
    """One joint step with ``backend="pallas"`` on both sides: the port's
    three dense heads through B3's plain version, JAX's through its Pallas
    kernel in interpret mode; JAX's first step's Adam tolerances of
    ``tests/test_torch_first_order.py``."""
    from test_torch_first_order import _assert_adam_step, _batch, _Draws, _joint_leaves

    kw = {**TOY_KW, "architecture": "alexnet_toy", "trainer": "joint", "backend": "pallas",
          "mc_samples": 3, "num_pseudo": 6, "data_minibatch": 10}
    jeng = JPSVI(jax_read_dataset("synth_cifar"), **kw)
    peng = PSVI(read_dataset("synth_cifar"), device="cpu", **kw)
    heads = [l for l in peng.net.layers if isinstance(l, TL.VILinear)]
    assert len(heads) == 3 and all(l.backend == "pallas" for l in heads)
    draws = _Draws(jeng, 1)
    jb, pb = _batch(jeng)
    js0 = _np_tree(jeng.state)
    js1, jaux = jax.jit(jeng._joint_step)(jeng.state, jax.random.PRNGKey(1), batch=jb)
    g32 = _np_tree(jax.jit(jax.grad(lambda lv: jeng._outer_loss(
        lv["params"], jax.tree_util.tree_map(jax.numpy.asarray, draws.trees[0]), lv["u"],
        js0.z, lv["v"], js0.alpha, *jb)))(_joint_leaves(js0)))
    ps1, paux = peng._joint_step(state_from_jax(js0, device="cpu"), batch=pb, eps=draws.port(0))
    np.testing.assert_allclose(float(paux["outer_loss"]), float(jaux["outer_loss"]), rtol=2e-5)
    _assert_adam_step(_joint_leaves(ps1), _joint_leaves(js1), g32, peng.lrs["joint"],
                      "alexnet_toy joint state")
    assert ps1.opt_joint.count == int(js1.opt_joint.count) == 1


@pytest.mark.parametrize("arch", ["fn2", "logistic_regression_fullcov"])
def test_fullcov_nets_refused_by_the_dense_kernel(arch):
    kw = {**FN2_KW, "architecture": arch}
    eng = PSVI(read_dataset("halfmoon"), device="cpu", **kw)
    assert not FN.supports(eng) and not FL.supports(eng)
    assert eng._step.__name__ == "_nested_step"
    with pytest.raises(ValueError, match="fused_inner=True"):
        PSVI(read_dataset("halfmoon"), device="cpu", fused_inner=True, **kw)


@pytest.mark.parametrize("arch", ["alexnet", "resnet"])
def test_cifar_nets_refused_by_lenet_kernel_and_heads_take_b3(arch):
    data = read_dataset("synth_cifar")
    kw = dict(architecture=arch, num_pseudo=4, mc_samples=2, inner_it=1, data_minibatch=8,
              seed=0, device="cpu")
    eng = PSVI(data, **kw)
    assert not FL.supports(eng) and not FN.supports(eng)
    assert eng._step.__name__ == "_nested_step"
    with pytest.raises(ValueError, match="fused_inner=True"):
        PSVI(data, fused_inner=True, **kw)
    joint = PSVI(data, trainer="joint", backend="pallas", **kw)
    heads = [l for l in joint.net.modules() if isinstance(l, TL.VILinear)]
    assert [(l.in_dim, l.out_dim) for l in heads] == (
        [(4096, 384), (384, 192), (192, 10)] if arch == "alexnet" else [(512, 10)])
    assert all(l.backend == "pallas" for l in heads)
    # the convs keep their own formulation
    assert all(not hasattr(l, "backend") for l in joint.net.modules()
               if isinstance(l, TL.VIConv2d))


@pytest.mark.parametrize("arch", ["fn2", "logistic_regression_fullcov", "resnet", "alexnet"])
def test_packed_zoo_follows_jax(arch):
    """``packed=True`` raises the JAX engine's ValueError where a net holds a
    full-covariance layer, BatchNorm or a Residual; AlexNet's layers are all
    mean-field or stateless, and both engines pack it."""
    name = "halfmoon" if arch in ("fn2", "logistic_regression_fullcov") else "synth_cifar"
    kw = dict(architecture=arch, n_hidden=5, num_pseudo=4, mc_samples=2, inner_it=1,
              data_minibatch=8, seed=0, packed=True)
    if arch == "alexnet":
        eng = PSVI(read_dataset(name), device="cpu", **kw)
        assert set(eng.state.params) == {"mu", "rho"}
        assert int(eng.state.params["mu"].numel()) == sum(
            l.size for l in jax.tree_util.tree_leaves(
                JN.make_alexnet().init(jax.random.PRNGKey(0)))) // 2
        return
    with pytest.raises(ValueError) as terr:
        PSVI(read_dataset(name), device="cpu", **kw)
    with pytest.raises(ValueError) as jerr:
        JPSVI(jax_read_dataset(name), **kw)
    assert str(terr.value) == str(jerr.value)
