"""The port's conv layers and LeNet against the JAX package, with the JAX
parameters carried across by ``params_from_jax`` and the same NumPy noise
and inputs handed to both sides, at LeNet's real 28×28 widths."""

import jax
import numpy as np
import pytest
import torch

from psvi_torch.data import read_dataset
from psvi_torch.inference.psvi import PSVI
from psvi_torch.models import layers as TL
from psvi_torch.models.networks import make_lenet, set_up_model
from psvi_torch.utils.convert import params_from_jax, state_from_jax
from psvi_tpu.data import read_dataset as jax_read_dataset
from psvi_tpu.inference.psvi import PSVI as JPSVI
from psvi_tpu.models import layers as JL
from psvi_tpu.models import networks as JN

# fp32 on both sides, the same products summed in another order
RTOL, ATOL = 1e-5, 1e-5
S = 3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.tensor(np.asarray(x, dtype=np.float32))


def _close(a, b, rtol=RTOL, atol=ATOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


def _layer_pair(jl, seed):
    """JAX params with spread sds, noise, and the port's copies of both."""
    rng = np.random.default_rng(seed)
    jp = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.3 * rng.standard_normal(np.shape(a)).astype(np.float32),
        jl.init(jax.random.PRNGKey(seed)))
    je = _np_tree(jl.sample_eps(jax.random.PRNGKey(seed + 1), S))
    return jp, je, params_from_jax(jp, device="cpu"), params_from_jax(je, device="cpu"), rng


CONV_CASES = [  # (C, K, k, padding, input side)
    (1, 6, 5, 2, 28),
    (6, 16, 5, 0, 14),
    (3, 4, 3, 1, 9),
]


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("C,K,k,pad,side", CONV_CASES)
def test_viconv2d_apply_kl_nkl(C, K, k, pad, side, batched):
    kw = dict(padding=pad, init_sd=0.05, prior_sd=0.7)
    jl, tl = JL.VIConv2d(C, K, k, **kw), TL.VIConv2d(C, K, k, **kw)
    jp, je, tp, te, rng = _layer_pair(jl, 0)
    x = rng.standard_normal((S, 5, C, side, side) if batched else (5, C, side, side))
    x = x.astype(np.float32)
    _close(tl.apply(tp, te, _t(x)), jl.apply(jp, je, x))
    _close(tl.kl(tp), jl.kl(jp))
    _close(tl.nkl(tp, te), jl.nkl(jp, je), rtol=1e-4)
    assert not tl.count_kl and tl.config() == dict(
        in_channels=C, out_channels=K, kernel_size=k, stride=1, padding=pad, init_sd=0.05,
        prior_sd=0.7, use_bias=True, count_kl=False, compute_dtype="float32")


@pytest.mark.parametrize("form", ["parity", "prepatched", "batched", "ragged"])
def test_viconvpool2d_matches_jax(form):
    C, K, k, pad, side = (6, 16, 5, 0, 15) if form == "ragged" else (1, 6, 5, 2, 28)
    kw = dict(padding=pad, init_sd=0.05, pool_k=2)
    jl, tl = JL.VIConvPool2d(C, K, k, **kw), TL.VIConvPool2d(C, K, k, **kw)
    jp, je, tp, te, rng = _layer_pair(jl, 1)
    shape = (S, 4, C, side, side) if form == "batched" else (4, C, side, side)
    x = rng.standard_normal(shape).astype(np.float32)
    assert tl.supports_parity(shape) == jl.supports_parity(shape) == (form in ("parity", "prepatched"))
    if form == "prepatched":
        jx = JL.PrePatched(jl.extract_patches(x), x.shape)
        tx = TL.PrePatched(tl.extract_patches(_t(x)), x.shape)
        _close(tx.pr, jx.pr, rtol=0, atol=0)
    else:
        jx, tx = x, _t(x)
    _close(tl.apply(tp, te, tx), jl.apply(jp, je, jx))


@pytest.mark.parametrize("shape,k,s,p", [
    ((S, 4, 6, 28, 28), 2, 2, 0),
    ((4, 6, 10, 10), 2, 2, 0),
    ((S, 2, 3, 9, 9), 3, 2, 1),
])
def test_maxpool_and_flatten(shape, k, s, p):
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    jy = JL.MaxPool2d(k, s, p).apply({}, {}, x)
    ty = TL.MaxPool2d(k, s, p).apply({}, {}, _t(x))
    _close(ty, jy, rtol=0, atol=0)
    _close(TL.Flatten().apply({}, {}, ty), JL.Flatten().apply({}, {}, jy), rtol=0, atol=0)
    # the argmax backend: the same values (its gradient: test_torch_engine_options.py)
    _close(TL.MaxPool2d(k, s, p, backend="argmax").apply({}, {}, _t(x)), jy, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown pool backend"):
        TL.MaxPool2d(2, 2, backend="int8")


@pytest.mark.parametrize("fused", [True, False])
def test_lenet_apply_kl_nkl(fused):
    jnet, tnet = JN.make_lenet(init_sd=0.05), make_lenet(init_sd=0.05)
    if fused:
        jnet, tnet = JL.fuse_conv_pool(jnet), TL.fuse_conv_pool(tnet)
    assert [type(l).__name__ for l in tnet.layers] == [type(l).__name__ for l in jnet.layers]
    assert tnet.variational_layers == jnet.variational_layers
    jp = _np_tree(jnet.init(jax.random.PRNGKey(3)))
    je = _np_tree(jnet.sample_eps(jax.random.PRNGKey(4), S))
    tp, te = params_from_jax(jp, device="cpu"), params_from_jax(je, device="cpu")
    # the parameter and noise trees line up leaf for leaf, {} included
    gen = torch.Generator().manual_seed(0)
    for a, b in ((tnet.init(gen), jp), (tnet.sample_eps(gen, S), je)):
        assert len(a) == len(b)
        for da, db in zip(a, b):
            assert {k: tuple(v.shape) for k, v in da.items()} == \
                {k: tuple(np.shape(v)) for k, v in db.items()}
    # the last classifier keeps the default init_sd (the reference's quirk)
    assert tnet.layers[-1].init_sd == jnet.layers[-1].init_sd == 0.01
    x = np.random.default_rng(5).standard_normal((6, 1, 28, 28)).astype(np.float32)
    out = tnet.apply(tp, te, _t(x))
    assert tuple(out.shape) == (S, 6, 10)
    _close(out, jnet.apply(jp, je, x), rtol=1e-4, atol=1e-4)
    _close(tnet.apply(tp, te, tnet.prep_input(_t(x))), jnet.apply(jp, je, jnet.prep_input(x)),
           rtol=1e-4, atol=1e-4)
    assert isinstance(tnet.prep_input(_t(x)), TL.PrePatched) == fused
    _close(tnet.kl(tp), jnet.kl(jp))
    _close(tnet.nkl(tp, te), jnet.nkl(jp, je), rtol=1e-4)


def test_set_up_model_lenet_dispatch():
    net = set_up_model("lenet", 784, None, 10, 1e-3, n_channels=1)
    assert [type(l).__name__ for l in net.layers] == [
        "VIConv2d", "MaxPool2d", "ReLU", "VIConv2d", "MaxPool2d", "ReLU", "Flatten",
        "VILinear", "ReLU", "VILinear", "ReLU", "VILinear"]
    assert net.layers[0].init_sd == 1e-3 and net.layers[-1].init_sd == 0.01
    assert set_up_model("lenet", 784, None, 10, 1e-3, n_channels=3).layers[0].in_channels == 3


def test_lenet_engine_state_from_jax():
    """The JAX engine's LeNet state carries across whole (empty dicts
    included), the port's engine builds the same fused net, and it draws the
    same image-shaped pseudodata for the same seed."""
    kw = dict(method="psvi_learn_v", architecture="lenet", num_pseudo=4, mc_samples=3,
              inner_it=3, data_minibatch=16, init_sd=1e-3, seed=0, num_epochs=1)
    jeng = JPSVI(jax_read_dataset("synth_mnist"), fused_inner=False, log_every=1000, **kw)
    st = state_from_jax(_np_tree(jeng.state), device="cpu")
    assert len(st.params) == len(jeng.state.params) == 12
    for tp_, jp_ in zip(st.params, jeng.state.params):
        assert set(tp_) == set(jp_)
        for key in tp_:
            np.testing.assert_array_equal(tp_[key].numpy(), np.asarray(jp_[key]))
    peng = PSVI(read_dataset("synth_mnist"), device="cpu", **kw)
    assert [type(l).__name__ for l in peng.net.layers] == \
        [type(l).__name__ for l in jeng.net.layers]
    assert tuple(peng.state.u.shape) == (4, 1, 28, 28)
    np.testing.assert_array_equal(peng.state.u.numpy(), np.asarray(jeng.state.u))
    np.testing.assert_array_equal(peng.state.z.numpy(), np.asarray(jeng.state.z))
    for tp_, pp_ in zip(st.params, peng.state.params):
        assert {k: tuple(v.shape) for k, v in tp_.items()} == \
            {k: tuple(v.shape) for k, v in pp_.items()}
