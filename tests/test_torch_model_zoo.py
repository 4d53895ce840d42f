"""The port's model zoo against the JAX package: the full-covariance dense
layer, AvgPool2d, BatchNorm2d, LocalResponseNorm, Residual and the
builders (``make_logreg_fullcov``, ``make_fc2net``, ``make_alexnet``,
``make_resnet`` with its basic and bottleneck blocks, ``set_up_model``),
with the JAX parameters carried across by ``params_from_jax`` and the same
NumPy noise and inputs handed to both sides.

Tolerances: the same fp32 formulas summed in another order, so outputs,
KL and NKL at rtol 2e-5 against max |ref| for the layers (RTOL); the
full-width nets at 1e-5·max |ref| on the forward and 2e-5 on KL and NKL
(sums over up to 11M terms); gradients at cosine > 0.99999 and max |Δ| ≤
1e-4·max |ref| per leaf.
"""

import torch_threads  # noqa: F401  (torch on this worker's share of the cores)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from psvi_torch.models import layers as TL
from psvi_torch.models import networks as TN
from psvi_torch.utils.convert import params_from_jax
from psvi_tpu.models import layers as JL
from psvi_tpu.models import networks as JN

RTOL = 2e-5
S = 3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.tensor(np.asarray(x, dtype=np.float32))


def _rel_close(a, b, rel=RTOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rel * max(np.abs(b).max(), 1e-30), (np.abs(a - b).max(),
                                                                      np.abs(b).max())


def _grads_close(tgrads, jgrads):
    """Each leaf's gradient: cosine > 0.99999, max |Δ| ≤ 1e-4·max |ref|."""
    tl = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda g: g.numpy(), tgrads))
    jl = jax.tree_util.tree_leaves(_np_tree(jgrads))
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
        if not np.abs(b).max():
            assert np.abs(a).max() <= 1e-6
            continue
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos > 0.99999 and np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), cos


def _spread(tree, rng, scale=0.3):
    """Parameters moved off their init, so that every term is exercised."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(np.shape(a)).astype(np.float32),
        _np_tree(tree))


def _pair(jlayer, tlayer, seed=0, scale=0.3):
    """JAX's params (spread) and noise, and the port's copies of both."""
    rng = np.random.default_rng(seed)
    jp = _spread(jlayer.init(jax.random.PRNGKey(seed)), rng, scale)
    je = _np_tree(jlayer.sample_eps(jax.random.PRNGKey(seed + 1), S))
    return jp, je, params_from_jax(jp, device="cpu"), params_from_jax(je, device="cpu"), rng


def _torch_grad(fn, tp):
    leaves = jax.tree_util.tree_map(lambda x: x.clone().requires_grad_(True), tp)
    flat = jax.tree_util.tree_leaves(leaves)
    g = torch.autograd.grad(fn(leaves), flat)
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(leaves), list(g))


# ---------------------------------------------------------------------------
# VILinearFullCov
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batched", [False, True])
def test_fullcov_layer_apply_kl_nkl_grad(batched):
    kw = dict(init_sd=0.05, prior_sd=0.7)
    jl, tl = JL.VILinearFullCov(3, 4, **kw), TL.VILinearFullCov(3, 4, **kw)
    jp, je, tp, te, rng = _pair(jl, tl)
    # a correlation of every entry, so that the triangle's order matters
    assert tl.num_params == 16 and tp["corr"].shape == (120,)
    x = rng.standard_normal((S, 7, 3) if batched else (7, 3)).astype(np.float32)
    _rel_close(tl.apply(tp, te, _t(x)), jl.apply(jp, je, x))
    _rel_close(tl.kl(tp), jl.kl(jp))
    _rel_close(tl.nkl(tp, te), jl.nkl(jp, je))
    c = rng.standard_normal((S, 7, 4)).astype(np.float32)

    def scalar(lib, layer, p, e, x, c):
        s = lib.sum(layer.apply(p, e, x) * c)
        return s + 0.01 * layer.kl(p) + 0.01 * lib.sum(layer.nkl(p, e))

    jg = jax.grad(lambda p: scalar(jnp, jl, p, je, x, c))(jp)
    tg = _torch_grad(lambda p: scalar(torch, tl, p, te, _t(x), _t(c)), tp)
    _grads_close(tg, jg)


def test_fullcov_init_and_triangle_order():
    tl = TL.VILinearFullCov(2, 3, init_sd=1e-3, use_bias=False)
    p = tl.init(torch.Generator().manual_seed(0))
    jp = _np_tree(JL.VILinearFullCov(2, 3, init_sd=1e-3, use_bias=False).init(
        jax.random.PRNGKey(0)))
    for k in ("mean", "corr"):
        np.testing.assert_array_equal(p[k].numpy(), jp[k])
    # softplus⁻¹(init_sd): the two packages' formulas, one fp32 ulp apart
    np.testing.assert_allclose(p["rho"].numpy(), jp["rho"], rtol=2e-7)
    # corr fills the strictly-lower triangle in jnp.tril_indices' order
    n = tl.num_params
    p["corr"] = torch.arange(1.0, n * (n - 1) // 2 + 1)
    L = tl._scale_tril(p).numpy()
    i, j = np.asarray(jnp.tril_indices(n, k=-1))
    np.testing.assert_array_equal(L[i, j], p["corr"].numpy())
    assert np.all(np.triu(L, 1) == 0)


# ---------------------------------------------------------------------------
# AvgPool2d, BatchNorm2d, LocalResponseNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,stride", [(4, None), (3, 2)])
def test_avgpool_matches_jax(k, stride):
    x = np.random.default_rng(0).standard_normal((S, 2, 5, 9, 9)).astype(np.float32)
    jl, tl = JL.AvgPool2d(k, stride), TL.AvgPool2d(k, stride)
    _rel_close(tl.apply({}, {}, _t(x)), jl.apply({}, {}, x))
    _rel_close(tl.apply({}, {}, _t(x[0])), jl.apply({}, {}, x[0]))


@pytest.mark.parametrize("shape", [(1, 4, 6, 5, 5), (S, 4, 6, 5, 5), (4, 6, 5, 5)])
def test_batchnorm_matches_jax(shape):
    jl, tl = JL.BatchNorm2d(6), TL.BatchNorm2d(6)
    jp, _, tp, _, rng = _pair(jl, tl)
    x = (2.0 + 3.0 * rng.standard_normal(shape)).astype(np.float32)
    _rel_close(tl.apply(tp, {}, _t(x)), jl.apply(jp, {}, x))
    # the current batch's statistics over every axis but the channel, with
    # the biased variance: S·N·H·W values a channel together
    y = tl.apply({"gamma": torch.ones(6), "beta": torch.zeros(6)}, {}, _t(x)).numpy()
    yc = np.moveaxis(y, -3, 0).reshape(6, -1)
    np.testing.assert_allclose(yc.mean(axis=1), 0.0, atol=1e-5)
    np.testing.assert_allclose(yc.var(axis=1), 1.0, rtol=1e-4)
    c = rng.standard_normal(shape).astype(np.float32)
    jg = jax.grad(lambda p: jnp.sum(jl.apply(p, {}, x) * c))(jp)
    tg = _torch_grad(lambda p: torch.sum(tl.apply(p, {}, _t(x)) * _t(c)), tp)
    _grads_close(tg, jg)
    tl.init(torch.Generator())  # parameters only: no running statistics
    assert set(tl.init(torch.Generator())) == {"gamma", "beta"} and not list(tl.buffers())


def test_local_response_norm_window_is_jaxs():
    kw = dict(alpha=0.001 / 9.0, beta=0.75, k=1.0)
    jl, tl = JL.LocalResponseNorm(4, **kw), TL.LocalResponseNorm(4, **kw)
    x = (3.0 * np.random.default_rng(0).standard_normal((2, 3, 64, 6, 6))).astype(np.float32)
    jy = np.asarray(jl.apply({}, {}, x))
    ty = tl.apply({}, {}, _t(x))
    _rel_close(ty, jy)
    _rel_close(tl.apply({}, {}, _t(x[0])), jl.apply({}, {}, x[0]))
    # torch's own layer centres an even window one channel lower: another
    # function, far outside the tolerance (here 1.4e-3·max |ref|)
    fy = F.local_response_norm(_t(x).reshape(6, 64, 6, 6), 4, **kw).reshape(x.shape).numpy()
    assert np.abs(fy - jy).max() > 10 * RTOL * np.abs(jy).max()
    # the same window as JAX's at an odd size, where both centre it
    j5, t5 = JL.LocalResponseNorm(5, **kw), TL.LocalResponseNorm(5, **kw)
    f5 = F.local_response_norm(_t(x).reshape(6, 64, 6, 6), 5, **kw).reshape(x.shape)
    _rel_close(f5, j5.apply({}, {}, x))
    _rel_close(t5.apply({}, {}, _t(x)), j5.apply({}, {}, x))
    c = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    xt = _t(x).requires_grad_(True)
    (tg,) = torch.autograd.grad(torch.sum(tl.apply({}, {}, xt) * _t(c)), xt)
    jg = jax.grad(lambda a: jnp.sum(jl.apply({}, {}, a) * c))(x)
    _grads_close([tg], [jg])


# ---------------------------------------------------------------------------
# Residual and the ResNet blocks
# ---------------------------------------------------------------------------


def _blocks(which):
    """(JAX block, port block) from each package's own builder, at planes
    4-8 (the bottleneck's 4 expands to 16)."""
    if which == "basic strided shortcut":
        return JN._basic_block(4, 8, 2, 0.1)[0], TN._basic_block(4, 8, 2, 0.1)[0]
    if which == "basic identity":
        return JN._basic_block(8, 8, 1, 0.1)[0], TN._basic_block(8, 8, 1, 0.1)[0]
    return JN._bottleneck_block(8, 4, 1, 0.1)[0], TN._bottleneck_block(8, 4, 1, 0.1)[0]


@pytest.mark.parametrize("which", ["basic strided shortcut", "basic identity", "bottleneck"])
def test_resnet_block_matches_jax(which):
    jb, tb = _blocks(which)
    assert len(tb.shortcut.layers) == (0 if which == "basic identity" else 2)
    jp, je, tp, te, rng = _pair(jb, tb, scale=0.05)
    cin = 4 if which.endswith("shortcut") else 8
    x = rng.standard_normal((S, 2, cin, 8, 8)).astype(np.float32)
    jy = np.asarray(jb.apply(jp, je, x))
    _rel_close(tb.apply(tp, te, _t(x)), jy)
    # the builders' convs do not count their KL: neither does the block
    assert not tb.is_variational and not tb.count_kl and not jb.is_variational
    c = rng.standard_normal(jy.shape).astype(np.float32)
    jg = jax.grad(lambda p: jnp.sum(jb.apply(p, je, x) * c))(jp)
    tg = _torch_grad(lambda p: torch.sum(tb.apply(p, te, _t(x)) * _t(c)), tp)
    _grads_close(tg, jg)


def test_residual_with_counted_layers_kl_nkl():
    """A block whose convs count their KL: the block is variational, and its
    KL and NKL are the sums of its body's and shortcut's."""
    def conv(mod, cin, cout, k, stride):
        return mod.VIConv2d(cin, cout, k, stride=stride, padding=k // 2, init_sd=0.1,
                            count_kl=True)

    jb = JL.Residual(JL.Sequential((conv(JL, 3, 5, 3, 2), JL.BatchNorm2d(5))),
                     JL.Sequential((conv(JL, 3, 5, 1, 2),)))
    tb = TL.Residual(TL.Sequential([conv(TL, 3, 5, 3, 2), TL.BatchNorm2d(5)]),
                     TL.Sequential([conv(TL, 3, 5, 1, 2)]))
    jp, je, tp, te, rng = _pair(jb, tb, scale=0.05)
    assert tb.is_variational and tb.count_kl and jb.is_variational
    x = rng.standard_normal((S, 2, 3, 6, 6)).astype(np.float32)
    _rel_close(tb.apply(tp, te, _t(x)), jb.apply(jp, je, x))
    _rel_close(tb.kl(tp), jb.kl(jp))
    _rel_close(tb.nkl(tp, te), jb.nkl(jp, je))
    # the noise is drawn body first, then shortcut
    gen = torch.Generator().manual_seed(3)
    e = tb.sample_eps(gen, 2)
    gen.manual_seed(3)
    body = tb.body.sample_eps(gen, 2)
    assert torch.equal(e["body"][0]["w"], body[0]["w"])


def test_rewrites_recurse_into_residuals():
    net = TN.make_resnet("resnet18", init_sd=0.1)
    half = TL.with_compute_dtype(net, "bfloat16")
    convs = [l for l in half.modules() if isinstance(l, TL.VIConv2d)]
    assert len(convs) == 20 and all(l.compute_dtype == "bfloat16" for l in convs)
    assert half.layers[-1].compute_dtype == "bfloat16"
    assert all(l.compute_dtype == "float32" for l in net.modules() if hasattr(l, "compute_dtype"))
    fc2 = TL.with_compute_dtype(TN.make_fc2net(2, 5, 2), "bfloat16")
    assert all(l.compute_dtype == "bfloat16" for l in fc2.layers[0::2])
    # a VILinear inside a block takes the dense backend too
    res = TL.Sequential([TL.Residual(TL.Sequential([TL.VILinear(3, 3)]), TL.Sequential([])),
                         TL.VILinear(3, 2)])
    pal = TL.with_dense_backend(res, "pallas")
    assert pal.layers[0].body.layers[0].backend == "pallas" == pal.layers[1].backend
    assert res.layers[0].body.layers[0].backend == "xla"


def test_sequential_nkl_without_counted_layers():
    net = TL.Sequential([TL.VIConv2d(1, 2, 3), TL.ReLU()])
    eps = net.sample_eps(torch.Generator().manual_seed(0), 4)
    eps64 = jax.tree_util.tree_map(lambda e: e.double(), eps)
    out = net.nkl(net.init(torch.Generator()), eps64)
    assert out.shape == (4,) and out.dtype == torch.float64 and not out.any()
    with pytest.raises(ValueError, match="empty eps"):
        TL.Sequential([TL.ReLU()]).nkl(({},), ({},))


# ---------------------------------------------------------------------------
# the builders
# ---------------------------------------------------------------------------


def net_pair_check(jnet, tnet, x, seed=0, rel=1e-5):
    """A net's forward at S = 2, KL and NKL against JAX's, from JAX's init
    and noise; returns both parameter trees."""
    jp = _np_tree(jnet.init(jax.random.PRNGKey(seed)))
    je = _np_tree(jnet.sample_eps(jax.random.PRNGKey(seed + 1), 2))
    tp, te = params_from_jax(jp, device="cpu"), params_from_jax(je, device="cpu")
    assert [type(l).__name__ for l in tnet.layers] == [type(l).__name__ for l in jnet.layers]
    _rel_close(tnet.apply(tp, te, _t(x)), jnet.apply(jp, je, x), rel)
    _rel_close(tnet.kl(tp), jnet.kl(jp), 2e-5)
    _rel_close(tnet.nkl(tp, te), jnet.nkl(jp, je), 2e-5)
    return tp, jp


@pytest.mark.parametrize("arch", ["resnet34", "resnet50", "resnet101", "resnet152"])
def test_resnet_depths_build_as_jax(arch):
    jnet, tnet = JN.make_resnet(arch), TN.make_resnet(arch)

    def shapes(net, mod):
        out = []
        for l in net.layers:
            if isinstance(l, mod.Residual):
                out.append(("res", shapes(l.body, mod), shapes(l.shortcut, mod)))
            elif isinstance(l, mod.VIConv2d):
                out.append((l.in_channels, l.out_channels, l.kernel_size, l.stride, l.padding,
                            l.use_bias))
            else:
                out.append(type(l).__name__)
        return out

    assert shapes(tnet, TL) == shapes(jnet, JL)
    assert tnet.layers[-1].in_dim == jnet.layers[-1].in_dim


@pytest.mark.parametrize("kind", ["fc2net", "logreg_fullcov"])
def test_fullcov_builders_match_jax(kind):

    x = np.random.default_rng(0).standard_normal((7, 3)).astype(np.float32)
    if kind == "fc2net":
        pair = (JN.make_fc2net(3, 5, 4, n_layers=2, init_sd=0.1),
                TN.make_fc2net(3, 5, 4, n_layers=2, init_sd=0.1))
    else:
        pair = JN.make_logreg_fullcov(3, 4), TN.make_logreg_fullcov(3, 4)
    net_pair_check(*pair, x, rel=RTOL)


def test_set_up_model_builds_the_zoo():
    def kinds(net):
        return [type(l).__name__ for l in net.layers]

    assert kinds(TN.set_up_model("logistic_regression_fullcov", 2, None, 2, 1e-3)) == [
        "VILinearFullCov"]
    assert kinds(TN.set_up_model("fn2", 2, 50, 2, 1e-3)) == [
        "VILinearFullCov", "ReLU", "VILinearFullCov"]
    alex = TN.set_up_model("alexnet", 3072, None, 10, 1e-3, n_channels=3)
    assert kinds(alex) == kinds(JN.set_up_model("alexnet", 3072, None, 10, 1e-3, n_channels=3))
    # resnet: resnet18, on n_channels or 3 channels, with nc classes
    for n_channels, cin in ((0, 3), (1, 1)):
        res = TN.set_up_model("resnet", 3072, None, 7, 0.1, n_channels=n_channels)
        jres = JN.set_up_model("resnet", 3072, None, 7, 0.1, n_channels=n_channels)
        assert res.layers[0].in_channels == jres.layers[0].in_channels == cin
        assert res.layers[-1].out_dim == 7 and len(res.layers) == len(jres.layers) == 14
    with pytest.raises(ValueError):
        TN.set_up_model("nope", 2, 4, 2, 1e-3)


def test_zoo_packing_follows_jax():
    """pack_net refuses a full-covariance layer, BatchNorm and Residual, as
    JAX's does; AlexNet's layers are all mean-field or stateless, and both
    packages pack it."""
    from psvi_torch.models.packed import pack_net
    from psvi_tpu.models.packed import pack_net as jax_pack_net

    for arch, kw in (("fn2", {}), ("logistic_regression_fullcov", {}),
                     ("resnet", {"n_channels": 3}), ("alexnet", {"n_channels": 3})):
        args = (arch, 3072, 5, 10, 1e-3)
        packs = jax_pack_net(JN.set_up_model(*args, **kw)) is not None
        assert (pack_net(TN.set_up_model(*args, **kw)) is not None) == packs
        assert packs == (arch == "alexnet"), arch


def test_fullcov_compute_dtype_bf16_matches_jax():
    jl = dataclasses.replace(JL.VILinearFullCov(3, 4, init_sd=0.05), compute_dtype="bfloat16")
    tl = TL.with_compute_dtype(TL.Sequential([TL.VILinearFullCov(3, 4, init_sd=0.05)]),
                               "bfloat16").layers[0]
    jp, je, tp, te, rng = _pair(jl, tl)
    x = rng.standard_normal((S, 7, 3)).astype(np.float32)
    jy = np.asarray(jl.apply(jp, je, x).astype(jnp.float32))
    ty = tl.apply(tp, te, _t(x))
    assert ty.dtype == torch.bfloat16
    # bf16 products of the same bf16 operands: within a bf16 ulp of the output
    _rel_close(ty.float(), jy, 1e-2)
