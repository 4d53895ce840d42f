"""The engine options against the JAX package (and, where the option has
no JAX-side counterpart to compare, against the port's own plain step).

- ``inner_optimizer``: the registry's error and one nested step under a
  non-Adam inner optimizer against the JAX step on the same noise.
- ``compute_dtype="bfloat16"``: every variational layer's forward, and
  LeNet's (folded and literal), against JAX's bf16 forward at ≤ 2e-2·max|ref|;
  the net's output back in float32; KL and NKL equal to the float32 net's;
  one LeNet nested step against JAX's bf16 step within JAX's own bound
  (``tests/test_mixed_precision.py``: max|Δu| < 1e-2).
- ``pool_backend="argmax"``: the values bit for bit those of ``"reshape"``;
  on tied windows the gradient equals JAX's ``_argmax_pool`` (the first
  index takes it), where ``"reshape"`` splits it, and so does the
  grad-of-grad, except the pooled value's derivative inside a backward pass
  on a tied window, where JAX splits and the port keeps the argmax, as
  torch's ``max_pool2d`` does (held against it).
- The literal LeNet (``fuse_convpool=False``) and the argmax-pooled one:
  both fused gates' verdicts, and a nested step, plain and through the
  LeNet pair's plain versions, against JAX's ``fuse_convpool=False`` step
  on injected noise, at ``tests/test_torch_engine.py``'s LeNet tolerances.
- ``fused_eps="stream"``: from one generator state the fused step (its
  plain versions) and ``_nested_step`` see the same ε; dense, regression and
  LeNet agree at the kernels' gate.
- The gates: every option JAX's gates refuse the port's refuse, and
  ``fused_inner=True`` raises there. ``inner_unroll`` changes nothing.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psvi_torch.data import read_dataset, read_regression_dataset
from psvi_torch.inference.psvi import PSVI, make_psvi_engine
from psvi_torch.models import layers as TL
from psvi_torch.models.networks import make_lenet
from psvi_torch.ops import fused_lenet as FL
from psvi_torch.ops import fused_nested as FN
from psvi_torch.utils.convert import params_from_jax, state_from_jax
from psvi_tpu.data import read_dataset as jax_read_dataset
from psvi_tpu.inference.psvi import PSVI as JPSVI
from psvi_tpu.models import layers as JL
from psvi_tpu.models import networks as JN
from psvi_tpu.ops import fused_lenet as JFL
from psvi_tpu.ops import fused_nested as JFN
from test_torch_engine import (KW, LENET_KW, _capture_hypergrads, _cos, _jax_nested_step,
                               _np_tree)

S = 3


def _t(x):
    return torch.tensor(np.asarray(x, dtype=np.float32))


def _jax_step_inputs(jeng, key):
    """The batch and noise the JAX nested step draws from ``key``, as the
    port's injected batch and noise."""
    k_batch, k_inner, k_outer = jax.random.split(key, 3)
    xb, yb = jeng._sample_batch(k_batch)
    keys = jax.random.split(k_inner, jeng.inner_it)
    eps_inner = [params_from_jax(_np_tree(jeng._sample_eps(k, jeng.mc_samples)), device="cpu")
                 for k in keys]
    eps_outer = params_from_jax(_np_tree(jeng._sample_eps(k_outer, jeng.mc_samples)),
                                device="cpu")
    return (xb, yb), (_t(xb), _t(yb)), (eps_inner, eps_outer)


# ---------------------------------------------------------------------------
# inner_optimizer
# ---------------------------------------------------------------------------

def test_inner_optimizer_option_validates_like_jax():
    data = read_dataset("halfmoon")
    with pytest.raises(ValueError) as terr:
        PSVI(data, inner_optimizer="lbfgs", device="cpu", **KW)
    with pytest.raises(ValueError) as jerr:
        JPSVI(jax_read_dataset("halfmoon"), inner_optimizer="lbfgs", **KW)
    assert str(terr.value) == str(jerr.value)
    eng = PSVI(data, inner_optimizer="RMSprop", device="cpu", **KW)
    assert eng.inner_optimizer == "rmsprop"
    with pytest.raises(ValueError, match="unknown fused_eps 'prng'"):
        PSVI(data, fused_eps="prng", device="cpu", **KW)


@pytest.mark.parametrize("name", ["rmsprop", "heavy_ball"])
def test_nested_step_inner_optimizer_matches_jax(name):
    kw = dict(method="psvi_learn_v", architecture="fn", inner_optimizer=name, **KW)
    jeng = JPSVI(jax_read_dataset("four_blobs"), fused_inner=False, **kw)
    key = jax.random.PRNGKey(3)
    jbatch, batch, eps = _jax_step_inputs(jeng, key)
    jstate0 = _np_tree(jeng.state)
    jstate1, jaux, jgrads = _jax_nested_step(jeng, key, jbatch)
    peng = PSVI(read_dataset("four_blobs"), device="cpu", **kw)
    assert not FN.supports(peng) and peng._step.__name__ == "_nested_step"
    pgrads = _capture_hypergrads(peng)
    s1, aux = peng._nested_step(state_from_jax(jstate0, device="cpu"), batch=batch, eps=eps)
    for k in jgrads:
        assert _cos(pgrads[k], jgrads[k]) > 0.9999, k
        assert np.abs(pgrads[k] - jgrads[k]).max() <= 1e-3 * np.abs(jgrads[k]).max(), k
    np.testing.assert_allclose(aux["inner_losses"].numpy(), np.asarray(jaux["inner_losses"]),
                               rtol=2e-5)
    np.testing.assert_allclose(float(aux["outer_loss"]), float(jaux["outer_loss"]), rtol=1e-5)
    for tp, jp in zip(s1.params, jstate1.params):
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=2e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# compute_dtype
# ---------------------------------------------------------------------------

BF16_LAYERS = {
    "linear unbatched": (lambda m: m.VILinear(7, 5, init_sd=0.05), (9, 7)),
    "linear batched": (lambda m: m.VILinear(7, 5, init_sd=0.05), (S, 9, 7)),
    "conv patches": (lambda m: m.VIConv2d(1, 6, 5, padding=2, init_sd=0.05), (4, 1, 12, 12)),
    "conv batched": (lambda m: m.VIConv2d(6, 4, 3, init_sd=0.05), (S, 2, 6, 9, 9)),
    "convpool parity": (lambda m: m.VIConvPool2d(1, 6, 5, padding=2, init_sd=0.05),
                        (4, 1, 12, 12)),
    "convpool fallback": (lambda m: m.VIConvPool2d(6, 4, 3, init_sd=0.05), (S, 2, 6, 10, 10)),
}


def _bf16_close(ty, jy):
    ref = np.asarray(jy, np.float32)
    out = ty.detach().float().numpy()
    assert np.abs(out - ref).max() <= 2e-2 * np.abs(ref).max()


@pytest.mark.parametrize("case", sorted(BF16_LAYERS))
def test_bf16_layer_forward_matches_jax(case):
    make, shape = BF16_LAYERS[case]
    jl = dataclasses.replace(make(JL), compute_dtype="bfloat16")
    tl = make(TL)
    tl.compute_dtype = "bfloat16"
    jp = _np_tree(jl.init(jax.random.PRNGKey(0)))
    je = _np_tree(jl.sample_eps(jax.random.PRNGKey(1), S))
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    jy = jl.apply(jp, je, x)
    ty = tl.apply(params_from_jax(jp, device="cpu"), params_from_jax(je, device="cpu"), _t(x))
    assert ty.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    _bf16_close(ty, jy)


@pytest.mark.parametrize("fused", [True, False])
def test_bf16_lenet_forward_kl_nkl(fused):
    jnet = JL.with_compute_dtype(JN.make_lenet(init_sd=0.05), "bfloat16")
    tnet = TL.with_compute_dtype(make_lenet(init_sd=0.05), "bfloat16")
    if fused:
        jnet, tnet = JL.fuse_conv_pool(jnet), TL.fuse_conv_pool(tnet)
    assert all(l.compute_dtype == "bfloat16" for l in tnet.layers if l.is_variational)
    jp = _np_tree(jnet.init(jax.random.PRNGKey(0)))
    je = _np_tree(jnet.sample_eps(jax.random.PRNGKey(1), S))
    tp, te = params_from_jax(jp, device="cpu"), params_from_jax(je, device="cpu")
    x = np.random.default_rng(3).standard_normal((5, 1, 28, 28)).astype(np.float32)
    ty = tnet.apply(tp, te, tnet.prep_input(_t(x)))
    assert ty.dtype == torch.float32 and ty.shape == (S, 5, 10)
    _bf16_close(ty, jnet.apply(jp, je, x))
    # KL and NKL are parameter-space: equal to the float32 net's
    t32 = make_lenet(init_sd=0.05)
    assert float(tnet.kl(tp)) == float(t32.kl(tp))
    assert torch.equal(tnet.nkl(tp, te), t32.nkl(tp, te))
    np.testing.assert_allclose(tnet.nkl(tp, te).numpy(), np.asarray(jnet.nkl(jp, je)), rtol=1e-5)


def test_bf16_lenet_nested_step_matches_jax():
    kw = dict(method="psvi_learn_v", architecture="lenet", compute_dtype="bfloat16",
              **LENET_KW)
    jeng = JPSVI(jax_read_dataset("synth_mnist"), fused_inner=False, **kw)
    key = jax.random.PRNGKey(3)
    jbatch, batch, eps = _jax_step_inputs(jeng, key)
    jstate0 = _np_tree(jeng.state)
    jstate1, jaux, _ = _jax_nested_step(jeng, key, jbatch)
    peng = PSVI(read_dataset("synth_mnist"), device="cpu", **kw)
    assert not FL.supports(peng) and not FN.supports(peng)
    s1, aux = peng._nested_step(state_from_jax(jstate0, device="cpu"), batch=batch, eps=eps)
    assert all(torch.isfinite(x).all() for x in (s1.u, s1.v, aux["outer_loss"]))
    # JAX's own bound between its bf16 and fp32 runs
    assert np.abs(s1.u.numpy() - np.asarray(jstate1.u)).max() < 1e-2
    np.testing.assert_allclose(float(aux["outer_loss"]), float(jaux["outer_loss"]), rtol=2e-3)
    np.testing.assert_allclose(aux["inner_losses"].numpy(), np.asarray(jaux["inner_losses"]),
                               rtol=2e-3)


def test_bf16_pallas_layer_takes_the_plain_product():
    lin = TL.VILinear(4, 3, backend="pallas", compute_dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    p, e = lin.init(gen), lin.sample_eps(gen, 2)
    x = torch.randn(2, 5, 4, generator=gen)
    lin32 = TL.VILinear(4, 3, compute_dtype="bfloat16")
    assert torch.equal(lin.apply(p, e, x), lin32.apply(p, e, x))


# ---------------------------------------------------------------------------
# argmax pooling
# ---------------------------------------------------------------------------

def _tied(shape, seed):
    """Inputs on a coarse grid, so that many windows hold tied maxima."""
    return np.random.default_rng(seed).integers(-2, 3, shape).astype(np.float32)


def test_argmax_pool_values_equal_reshape_pool():
    for x in (np.random.default_rng(0).standard_normal((3, 2, 4, 8, 8)).astype(np.float32),
              _tied((3, 2, 4, 8, 8), 1)):
        a = TL.MaxPool2d(2, 2, backend="argmax").apply({}, {}, _t(x))
        r = TL.MaxPool2d(2, 2).apply({}, {}, _t(x))
        assert torch.equal(a, r)


def test_argmax_pool_gradients_on_ties_match_jax():
    """f(x, w) = Σ w·pool(x)² on inputs with tied windows: ∂f/∂x equals
    JAX's ``_argmax_pool`` (each window's first maximal index takes the
    whole gradient); the grad-of-grad ∂⟨∂f/∂x, r⟩/∂w equals JAX's, and
    ∂⟨∂f/∂x, r⟩/∂x equals JAX's on every untied window. On a tied window
    the pooled value's derivative inside a backward pass differs by
    design: JAX's custom JVP differentiates its own ``jnp.max`` there, which
    splits over the tie, where the port keeps the argmax, as torch's
    ``max_pool2d`` double backward does (held against it on every
    window)."""
    import torch.nn.functional as F

    x = _tied((2, 3, 6, 6), 2)
    w = np.random.default_rng(3).standard_normal((2, 3, 3, 3)).astype(np.float32)
    r = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    def jf(x, w):
        return jnp.sum(w * JL._argmax_pool(x, 2) ** 2)

    jg = jax.grad(jf)(x, w)
    jh_x, jh_w = jax.grad(lambda x, w: jnp.sum(jax.grad(jf)(x, w) * r), argnums=(0, 1))(x, w)

    def grads(pool):
        tx, tw = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(tw * pool(tx) ** 2), tx, create_graph=True)
        h_x, h_w = torch.autograd.grad(torch.sum(g * _t(r)), (tx, tw))
        return g.detach().numpy(), h_x.numpy(), h_w.numpy()

    tg, th_x, th_w = grads(lambda a: TL._argmax_pool(a, 2))
    np.testing.assert_array_equal(tg, np.asarray(jg))
    np.testing.assert_allclose(th_w, np.asarray(jh_w), rtol=1e-6, atol=1e-6)
    windows = x.reshape(2, 3, 3, 2, 3, 2).transpose(0, 1, 2, 4, 3, 5).reshape(2, 3, 3, 3, 4)
    tied = (windows == windows.max(-1, keepdims=True)).sum(-1) > 1
    assert tied.any() and (~tied).any()
    untied = np.repeat(np.repeat(~tied, 2, axis=2), 2, axis=3)
    np.testing.assert_allclose(th_x[untied], np.asarray(jh_x)[untied], rtol=1e-6, atol=1e-6)
    # torch's max_pool2d routes both orders by its indices: the same numbers
    for mine, ref in zip((tg, th_x, th_w), grads(lambda a: F.max_pool2d(a, 2))):
        np.testing.assert_allclose(mine, ref, rtol=1e-6, atol=1e-6)
    # the first index of each window takes the whole gradient
    g = tg.reshape(2, 3, 3, 2, 3, 2).transpose(0, 1, 2, 4, 3, 5).reshape(2, 3, 3, 3, 4)
    assert ((g != 0).sum(-1) <= 1).all()
    first = np.argmax(windows == windows.max(-1, keepdims=True), axis=-1)
    nz = g != 0
    assert (np.argmax(nz, axis=-1)[nz.any(-1)] == first[nz.any(-1)]).all()
    # the reshape backend splits it over tied positions: another gradient
    tx2 = _t(x).requires_grad_(True)
    (tr,) = torch.autograd.grad(torch.sum(_t(w) * TL.MaxPool2d(2, 2).apply({}, {}, tx2) ** 2),
                                tx2)
    assert not np.array_equal(tr.numpy(), tg)


# ---------------------------------------------------------------------------
# the literal and argmax-pooled LeNet
# ---------------------------------------------------------------------------

def test_literal_lenet_gates():
    data = read_dataset("synth_mnist")
    kw = dict(method="psvi_learn_v", architecture="lenet", device="cpu", **LENET_KW)
    for opts in (dict(fuse_convpool=False), dict(pool_backend="argmax")):
        eng = PSVI(data, **kw, **opts)
        types = [type(l) for l in eng.net.layers]
        assert types[:2] == [TL.VIConv2d, TL.MaxPool2d], opts
        assert FL.supports(eng) and not FN.supports(eng), opts
        assert PSVI(data, fused_inner=True, **kw, **opts)._step.__name__ == \
            "_nested_step_fused_lenet"
        assert FL.cfg_from_engine(eng) == FL.cfg_from_engine(PSVI(data, **kw))
    # the parameter trees of the folded and literal nets are the same
    a, b = PSVI(data, **kw), PSVI(data, fuse_convpool=False, **kw)
    assert all(torch.equal(x, y) for x, y in zip(
        [t for p in a.state.params for t in p.values()],
        [t for p in b.state.params for t in p.values()]))


def test_literal_and_argmax_lenet_step_matches_jax():
    kw = dict(method="psvi_learn_v", architecture="lenet", **LENET_KW)
    jeng = JPSVI(jax_read_dataset("synth_mnist"), fused_inner=False, fuse_convpool=False, **kw)
    assert isinstance(jeng.net.layers[1], JL.MaxPool2d)
    key = jax.random.PRNGKey(3)
    jbatch, batch, eps = _jax_step_inputs(jeng, key)
    jstate0 = _np_tree(jeng.state)
    jstate1, jaux, jgrads = _jax_nested_step(jeng, key, jbatch)
    data = read_dataset("synth_mnist")
    for opts in (dict(fuse_convpool=False), dict(pool_backend="argmax")):
        peng = PSVI(data, device="cpu", **kw, **opts)
        pgrads = _capture_hypergrads(peng)
        for step in (peng._nested_step, peng._nested_step_fused_lenet):
            s1, aux = step(state_from_jax(jstate0, device="cpu"), batch=batch, eps=eps)
            what = (step.__name__, opts)
            # tests/test_torch_engine.py's LeNet tolerances
            for k in jgrads:
                assert _cos(pgrads[k], jgrads[k]) > 0.999, what + (k,)
                assert (np.abs(pgrads[k] - jgrads[k]).max()
                        <= 1e-2 * np.abs(jgrads[k]).max()), what + (k,)
            np.testing.assert_allclose(float(aux["outer_loss"]), float(jaux["outer_loss"]),
                                       rtol=2e-5)
            np.testing.assert_allclose(aux["inner_losses"].numpy(),
                                       np.asarray(jaux["inner_losses"]), rtol=2e-5)
            np.testing.assert_allclose(s1.u.numpy(), np.asarray(jstate1.u), atol=1e-3)
            np.testing.assert_allclose(s1.v.numpy(), np.asarray(jstate1.v), atol=1e-3)
            for tp, jp in zip(s1.params, jstate1.params):
                for k in tp:
                    np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=3e-5)


# ---------------------------------------------------------------------------
# fused_eps="stream"
# ---------------------------------------------------------------------------

def _gate(a, b, what):
    """The kernels' gate: cosine > 0.9999 and max|Δ| ≤ 1e-3·max|ref|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert _cos(a, b) > 0.9999, what
    assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max(), what


STREAM_CASES = {
    "dense": ("four_blobs", dict(method="psvi_alpha_v", architecture="fn", **KW)),
    "regression": ("sinus", dict(method="psvi_learn_v_regressor", architecture="regressor_net",
                                 n_hidden=8, tau=0.1, **KW)),
    "lenet": ("synth_mnist", dict(method="psvi_learn_v", architecture="lenet", **LENET_KW)),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_stream_noise_fused_step_matches_plain_step(case):
    name, kw = STREAM_CASES[case]
    data = read_regression_dataset(name) if name == "sinus" else read_dataset(name)
    fused = make_psvi_engine(data, fused_inner=True, fused_eps="stream", device="cpu", **kw)
    plain = make_psvi_engine(data, fused_inner=False, device="cpu", **kw)
    assert fused._step.__name__.startswith("_nested_step_fused")
    assert plain._step.__name__ == "_nested_step"
    gf, gp = _capture_hypergrads(fused), _capture_hypergrads(plain)
    s0 = plain.state
    sf, af = fused._step(s0)
    sp, ap = plain._step(s0)
    # the same draws: both generators end in the same state
    assert torch.equal(fused.gen.get_state(), plain.gen.get_state())
    assert set(gf) == set(gp)
    for k in gp:
        _gate(gf[k], gp[k], k)
    np.testing.assert_allclose(float(af["outer_loss"]), float(ap["outer_loss"]), rtol=1e-5)
    for k in ("u", "v", "alpha", "z"):
        np.testing.assert_allclose(getattr(sf, k).numpy(), getattr(sp, k).numpy(), atol=1e-5)
    for tp, pp in zip(sf.params, sp.params):
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), pp[k].numpy(), rtol=2e-4, atol=1e-5)
    # the batched noise is another draw
    batched = make_psvi_engine(data, fused_inner=True, device="cpu", **kw)
    sb, _ = batched._step(s0)
    assert not torch.equal(sb.u, sf.u)


# ---------------------------------------------------------------------------
# the gates and inner_unroll
# ---------------------------------------------------------------------------

GATE_CASES = {  # option -> does JAX's gate of that family refuse it
    "inner_optimizer": dict(inner_optimizer="sgd"),
    "compute_dtype": dict(compute_dtype="bfloat16"),
    "packed": dict(packed=True),
}


@pytest.mark.parametrize("family", ["dense", "lenet"])
@pytest.mark.parametrize("option", sorted(GATE_CASES))
def test_gates_refuse_what_jax_refuses(family, option):
    opts = GATE_CASES[option]
    if family == "dense":
        name, kw, t_gate, j_gate = ("four_blobs", dict(architecture="fn", **KW), FN.supports,
                                    JFN.supports)
    else:
        name, kw, t_gate, j_gate = ("synth_mnist", dict(architecture="lenet", **LENET_KW),
                                    FL.supports, JFL.supports)
    assert t_gate(PSVI(read_dataset(name), device="cpu", **kw))
    eng = PSVI(read_dataset(name), device="cpu", **kw, **opts)
    jeng = JPSVI(jax_read_dataset(name), fused_inner=False, **kw, **opts)
    assert not t_gate(eng)
    # JAX's LeNet gate reads no compute dtype; the port's refuses bf16 too
    assert not j_gate(jeng) or (family, option) == ("lenet", "compute_dtype")
    with pytest.raises(ValueError, match="fused_inner=True"):
        PSVI(read_dataset(name), device="cpu", fused_inner=True, **kw, **opts)


def test_inner_unroll_stored_and_changes_nothing():
    data = read_dataset("four_blobs")
    kw = dict(architecture="fn", device="cpu", **KW)
    assert PSVI(data, **kw).inner_unroll is None
    assert PSVI(data, inner_unroll=0, **kw).inner_unroll == 1
    assert PSVI(data, inner_unroll="4", **kw).inner_unroll == 4
    for fused in (False, True):
        a, b = (PSVI(data, inner_unroll=u, fused_inner=fused, **kw) for u in (None, 5))
        sa, _ = a._step(a.state)
        sb, _ = b._step(b.state)
        assert all(torch.equal(x, y) for x, y in zip([sa.u, sa.v], [sb.u, sb.v]))
