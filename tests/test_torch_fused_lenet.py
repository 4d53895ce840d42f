"""The port's LeNet inner unroll against the JAX package's.

At the JAX tests' toy size (T=3, S=3, M=4, LeNet at its real 28×28 widths,
``tests/test_fused_lenet.py``), from the same NumPy inputs and noise:

- one inner iteration's hand-derived VJP (``rev_iter_torch_lenet``) matches
  ``jax.vjp`` of ``psvi_tpu.ops.fused_lenet._make_body(cfg, "xla")`` and
  ``torch.autograd`` double-backward through the port's own layers;
- the whole unroll through ``lenet_unroll`` (the plain versions of the two
  CUDA kernels in ``LeNetUnroll``, and the autograd oracle) matches JAX
  ``make_fused_unroll(cfg, backend="xla")``: paramsT, the inner losses and
  the (u, v) hypergradients (psvi_learn_v here, α-weighted in
  ``test_torch_fused_lenet_variants.py``);
- ``supports()`` admits exactly the fused LeNet the kernels compute.
"""

import torch_threads  # noqa: F401  (torch on this worker's share of the cores)

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psvi_torch.data import read_dataset
from psvi_torch.inference.psvi import PSVI
from psvi_torch.models import layers as TL
from psvi_torch.models.networks import make_lenet
from psvi_torch.ops import elbo as TE
from psvi_torch.ops import fused_lenet as FL
from psvi_torch.ops import fused_nested as FN
from psvi_tpu.ops import fused_lenet as JFL

T, S, M = 3, 3, 4
DATA = read_dataset("synth_mnist")


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


# Adam's ε of the fp32 unroll comparisons with JAX on the jittered inputs
# below. At the engine's 1e-8 the first step is −lr·g/(|g| + ε) ≈ −lr·sign(g),
# whose derivative lr·ε/(|g| + ε)² is large and hangs on the last bits of the
# few gradients with |g| near ε (conv ρ gradients σ′(ρ)·Σ G·ε carry no KL
# term and can cancel). There JAX's own fp32 ū is as far from the float64
# one as the port's is (test_torch_fused_lenet_adam_eps.py), so the
# comparison would measure fp32 rounding. Few gradients lie near 1e-5. At
# 1e-8 the port meets JAX on the engine's initial state (same file) and its
# backends meet each other in float64 (test_torch_fused_lenet_variants.py).
UNROLL_ADAM_EPS = 1e-5


def _cfgs(parameterised=True, use_alpha=False, adam_eps=1e-8):
    kw = dict(T=T, S=S, M=M, nc=10, N=float(DATA.N), parameterised=parameterised,
              use_alpha=use_alpha, prior_sd=1.0, adam_eps=adam_eps)
    return FL.LeNetCfg(**kw), JFL.LeNetCfg(eps_mode="input", **kw)


def _inputs(cfg, seed=0):
    """Engine-like parameters (U(±1/√fan_in) means, ρ near softplus⁻¹(1e-3)),
    noise per iteration, a coreset of synth_mnist images and cotangents, all
    from one NumPy generator."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    rho0 = math.log(math.expm1(1e-3))
    layers, eps = [], []
    for wshape, o in cfg.layer_shapes():
        b = 1.0 / math.sqrt(math.prod(wshape[1:]))
        layers.append({"mu_w": rng.uniform(-b, b, wshape).astype(f32),
                       "rho_w": (rho0 + 0.1 * rng.standard_normal(wshape)).astype(f32),
                       "mu_b": rng.uniform(-b, b, o).astype(f32),
                       "rho_b": (rho0 + 0.1 * rng.standard_normal(o)).astype(f32)})
        eps.append({"w": rng.standard_normal((cfg.T, cfg.S) + wshape).astype(f32),
                    "b": rng.standard_normal((cfg.T, cfg.S, o)).astype(f32)})
    iu = rng.choice(len(DATA.x), cfg.M, replace=False)
    v = (0.3 * rng.standard_normal(cfg.M)).astype(f32) if cfg.parameterised \
        else np.full(cfg.M, 1.0 / cfg.M, f32)
    return dict(layers=layers, eps=eps, u=DATA.x[iu], z=DATA.y[iu], v=v,
                alpha=np.array([0.1 if cfg.use_alpha else 0.0], f32),
                pbar=rng.standard_normal(cfg.n_params).astype(f32),
                dl=rng.standard_normal(cfg.T).astype(f32), lr=1e-3)


def _t(x):
    return torch.tensor(np.asarray(x))


def _to_jax_params(flat, jcfg, cfg):
    """Port flat (P,) → the JAX kernel layout (20-tuple)."""
    dicts = [{k: jnp.asarray(v.numpy()) for k, v in d.items()}
             for d in FL.unpack_params(_t(flat), cfg)]
    return JFL.pack_params(tuple(dicts), jcfg)


def _from_jax_params(flat20, jcfg):
    """JAX kernel layout (20-tuple) → port flat (P,) as NumPy."""
    return FL.pack_params([{k: _t(np.asarray(v)) for k, v in d.items()}
                           for d in JFL.unpack_params(flat20, jcfg)]).numpy()


def _jax_stacks(eps, jcfg, t=None):
    """Per-layer noise (T, S, ...) → the JAX kernel's stacked layout; with
    ``t``, iteration t's slice alone."""
    sel = (lambda a: a[t:t + 1]) if t is not None else (lambda a: a)
    tree = [{k: jnp.asarray(sel(v)) for k, v in e.items()} for e in eps]
    return JFL.eps_stacks_from_tree(tree, range(5), jcfg)


def _port_eps(eps):
    return FL.pack_eps([{k: _t(v) for k, v in e.items()} for e in eps], lead=(T,))


def test_layouts_roundtrip_and_match_the_net():
    cfg, jcfg = _cfgs()
    a = _inputs(cfg)
    p0 = FL.pack_params([{k: _t(v) for k, v in d.items()} for d in a["layers"]])
    assert p0.shape == (cfg.n_params,) == (123412,) and cfg.n_theta == 61706
    np.testing.assert_array_equal(_from_jax_params(_to_jax_params(p0, jcfg, cfg), jcfg),
                                  p0.numpy())
    e_in = _port_eps(a["eps"])
    assert e_in.shape == (T, cfg.n_eps)
    for (w, b), e in zip(FL.unpack_eps(e_in[1], cfg), a["eps"]):
        np.testing.assert_array_equal(w.numpy(), e["w"][1])
        np.testing.assert_array_equal(b.numpy(), e["b"][1])
    # the flat draw has exactly the shapes of the fused net's noise tree
    net = TL.fuse_conv_pool(make_lenet())
    tree = net.sample_eps(torch.Generator().manual_seed(0), S)
    flat = FL.pack_eps([tree[i] for i in net.variational_layers])
    assert flat.shape == (cfg.n_eps,)


def _one_iter_inputs(cfg, seed=1):
    a = _inputs(cfg, seed)
    rng = np.random.default_rng(seed + 100)
    P = cfg.n_params
    a.update(m=(0.1 * rng.standard_normal(P)).astype(np.float32),
             n=(0.01 * rng.random(P)).astype(np.float32),
             mbar=rng.standard_normal(P).astype(np.float32),
             nbar=rng.standard_normal(P).astype(np.float32), t=3, lr=1e-2)
    return a


def test_one_iteration_vjp_matches_jax_and_autograd():
    cfg, jcfg = _cfgs()
    a = _one_iter_inputs(cfg)
    t, lr = a["t"], a["lr"]
    p = FL.pack_params([{k: _t(v) for k, v in d.items()} for d in a["layers"]])
    e_t = _port_eps(a["eps"])[t - 1]
    jz = jax.nn.one_hot(a["z"].astype(np.int32), 10).T
    jalpha = jnp.asarray(a["alpha"]).reshape(1, 1)
    jeps = _jax_stacks(a["eps"], jcfg, t=t - 1)
    body = JFL._make_body(jcfg, "xla")
    C0 = JFL._base_mask(jcfg)

    def step(pp, mm, nn, u, v):
        return body(t - 1, pp, mm, nn, jeps, JFL.lenet_patches(u, jcfg), jz, v, jalpha, lr, C0)

    @jax.jit
    def step_vjp(primals, cotangents):
        return jax.vjp(step, *primals)[1](cotangents)

    to_j = lambda x: _to_jax_params(x, jcfg, cfg)  # noqa: E731
    jp, jm, jn, ju, jv = step_vjp(
        (to_j(p), to_j(_t(a["m"])), to_j(_t(a["n"])), jnp.asarray(a["u"]),
         jnp.asarray(a["v"]).reshape(1, M)),
        (to_j(_t(a["pbar"])), to_j(_t(a["mbar"])), to_j(_t(a["nbar"])), jnp.float32(a["dl"][0])))
    jax_out = [_from_jax_params(jp, jcfg), _from_jax_params(jm, jcfg),
               _from_jax_params(jn, jcfg), np.asarray(ju), np.asarray(jv).ravel()]

    # the port's hand-derived VJP, c̄w mapped to v̄ through core_weights
    v, alpha = _t(a["v"]), _t(a["alpha"])
    cw = FN.core_weights(v, alpha, cfg)
    pb, mb, nb, ub, cwb = FL.rev_iter_torch_lenet(
        t, p, _t(a["m"]), _t(a["n"]), _t(a["pbar"]), _t(a["mbar"]), _t(a["nbar"]),
        float(a["dl"][0]), _t(a["u"]), FN._one_hot(_t(a["z"]), 10), cw, e_t, lr, cfg)
    port = [pb, mb, nb, ub, FN._cw_vjp(cwb, cw, v, alpha, cfg)[0]]

    # torch.autograd double-backward through the port's own fused LeNet
    net = TL.fuse_conv_pool(make_lenet())
    didx = net.variational_layers
    leaves = [x.clone().requires_grad_(True) for x in (p, _t(a["m"]), _t(a["n"]), _t(a["u"]), v)]
    pp, mm, nn, uu, vv = leaves

    def full(layers):
        tree = [{} for _ in net.layers]
        for k, i in enumerate(didx):
            tree[i] = layers[k]
        return tuple(tree)

    eps_tree = full([{"w": w, "b": b} for w, b in FL.unpack_eps(e_t, cfg)])
    loss = TE.inner_elbo(net, full(FL.unpack_params(pp, cfg)), eps_tree, net.prep_input(uu),
                         _t(a["z"]), FN.core_weights(vv, alpha, cfg), nc=10)
    (g,) = torch.autograd.grad(loss, pp, create_graph=True)
    p1, m1, n1 = FN._adam(pp, mm, nn, g, t, lr, cfg)
    dot = ((p1 * _t(a["pbar"])).sum() + (m1 * _t(a["mbar"])).sum()
           + (n1 * _t(a["nbar"])).sum() + float(a["dl"][0]) * loss)
    auto = torch.autograd.grad(dot, leaves)

    for name, x, j, au in zip(["pbar", "mbar", "nbar", "ubar", "vbar"], port, jax_out, auto):
        x = x.detach().numpy()
        # one iteration in fp32: cosine and max error relative to the largest entry
        for ref in (j, au.numpy()):
            assert _cos(x, ref) > 0.99999, name
            assert np.abs(x - ref).max() <= 1e-4 * np.abs(ref).max(), name


@functools.lru_cache(maxsize=None)
def _jax_unroll_grad(jcfg):
    """One jitted value-and-grad of JAX make_fused_unroll(backend='xla')
    per config, so calls at one config share a compile."""
    fn = JFL.make_fused_unroll(jcfg, backend="xla")
    seed = jnp.zeros((1, 2), jnp.float32)

    def outer(u, v, p0, proj, stacks, jz, jalpha, lr, dl):
        pT, losses = fn(p0, JFL.lenet_patches(u, jcfg), v.reshape(1, jcfg.M), jalpha, jz, stacks,
                        lr, seed)
        obj = sum(jnp.sum(x * w) for x, w in zip(pT, proj)) + jnp.sum(losses.ravel() * dl)
        return obj, (pT, losses.ravel())

    return jax.jit(jax.value_and_grad(outer, argnums=(0, 1), has_aux=True))


def _jax_unroll(cfg, jcfg, a):
    """JAX make_fused_unroll(backend='xla'): paramsT (port flat), the inner
    losses and the gradients of ⟨p̄, pT⟩ + ⟨dl, losses⟩ w.r.t. (u, v)."""
    p0 = _to_jax_params(FL.pack_params([{k: _t(v) for k, v in d.items()} for d in a["layers"]]),
                        jcfg, cfg)
    (_, (pT, losses)), (gu, gv) = _jax_unroll_grad(jcfg)(
        jnp.asarray(a["u"]), jnp.asarray(a["v"]), p0, _to_jax_params(_t(a["pbar"]), jcfg, cfg),
        _jax_stacks(a["eps"], jcfg), jax.nn.one_hot(a["z"].astype(np.int32), 10).T,
        jnp.asarray(a["alpha"]).reshape(1, 1), jnp.full((1, 1), a["lr"], jnp.float32),
        jnp.asarray(a["dl"]))
    return _from_jax_params(pT, jcfg), np.asarray(losses), np.asarray(gu), np.asarray(gv)


def _port_unroll(cfg, a, backend):
    """The port's paramsT, inner losses and (u, v) gradients of the same
    objective through ``lenet_unroll``."""
    p0 = FL.pack_params([{k: _t(v) for k, v in d.items()} for d in a["layers"]])
    u, v = _t(a["u"]).requires_grad_(True), _t(a["v"]).requires_grad_(True)
    pT, losses = FL.lenet_unroll(p0, u, v, _t(a["alpha"]), _t(a["z"]), _port_eps(a["eps"]),
                                 a["lr"], cfg, backend=backend)
    obj = (pT * _t(a["pbar"])).sum() + (losses * _t(a["dl"])).sum()
    gu, gv = torch.autograd.grad(obj, [u, v])
    return pT.detach().numpy(), losses.detach().numpy(), gu.numpy(), gv.numpy()


def _check_unroll_against_jax(parameterised, use_alpha, backends, seed=2,
                              adam_eps=UNROLL_ADAM_EPS, inputs=_inputs):
    """paramsT, the inner losses and the (u, v) hypergradients of the unroll
    against JAX, at the tolerances of tests/test_fused_lenet.py:127-186."""
    cfg, jcfg = _cfgs(parameterised, use_alpha, adam_eps)
    a = inputs(cfg, seed=seed)
    j_pT, j_losses, j_gu, j_gv = _jax_unroll(cfg, jcfg, a)
    for backend in backends:
        pT, losses, gu, gv = _port_unroll(cfg, a, backend)
        np.testing.assert_allclose(pT, j_pT, atol=2e-5, err_msg=backend)
        np.testing.assert_allclose(losses, j_losses, rtol=2e-5, err_msg=backend)
        for name, x, ref in (("u", gu, j_gu), ("v", gv, j_gv)):
            assert _cos(x, ref) > 0.9999, (backend, name)
            np.testing.assert_allclose(x, ref, atol=5e-4 * float(np.abs(ref).max() + 1e-30),
                                       err_msg=f"{backend} {name}")


def test_unroll_matches_jax():
    _check_unroll_against_jax(True, False, ("torch", "autograd"))


ENGINE_KW = dict(method="psvi_learn_v", architecture="lenet", num_pseudo=M, mc_samples=S,
                 inner_it=T, data_minibatch=16, init_sd=1e-3, seed=0, num_epochs=1,
                 device="cpu")


def _engine(**kw):
    return PSVI(DATA, **{**ENGINE_KW, **kw})


def test_supports_admits_exactly_the_fused_lenet():
    eng = _engine()
    assert FL.supports(eng) and not FN.supports(eng)
    cfg = FL.cfg_from_engine(eng)
    assert (cfg.T, cfg.S, cfg.M, cfg.H, cfg.fc) == (T, S, M, 28, (400, 120, 84, 10))
    assert cfg.parameterised and not cfg.use_alpha
    assert FL.cfg_from_engine(_engine(method="psvi_alpha_v")).use_alpha
    assert not FL.cfg_from_engine(_engine(method="psvi")).parameterised
    # 'auto' on the CPU takes the plain path; True the LeNet pair
    assert eng._step.__name__ == "_nested_step"
    assert _engine(fused_inner=True)._step.__name__ == "_nested_step_fused_lenet"
    # a dense net is not the LeNet
    dense = PSVI(read_dataset("four_blobs"), architecture="fn", num_pseudo=4, mc_samples=3,
                 inner_it=2, device="cpu")
    assert not FL.supports(dense) and FN.supports(dense)


def _with_layers(eng, layers):
    eng.net = TL.Sequential(layers)
    return eng


@pytest.mark.parametrize("change", ["missing_relu", "extra_relu", "swapped", "unfused",
                                    "learn_z", "trainer", "float64", "one_sample", "conv_kl",
                                    "conv1_width", "fc_width", "image_side"])
def test_supports_refuses(change):
    eng = _engine()
    L = list(eng.net.layers)
    if change == "missing_relu":
        _with_layers(eng, L[:8] + L[9:])
    elif change == "extra_relu":
        _with_layers(eng, L[:11] + [TL.ReLU()] + L[11:])
    elif change == "swapped":
        _with_layers(eng, L[:1] + [L[2], L[1]] + L[3:])
    elif change == "unfused":
        # the literal net is served too; with an overlapping pool it is not
        # the function the kernels compute
        lit = list(make_lenet().layers)
        eng.net = TL.Sequential(lit[:1] + [TL.MaxPool2d(2, 1)] + lit[2:])
    elif change == "learn_z":
        eng.spec = dataclasses.replace(eng.spec, learn_z=True)
    elif change == "trainer":
        eng.trainer = "joint"
    elif change == "float64":
        eng.state = eng.state._replace(u=eng.state.u.double())
    elif change == "one_sample":
        eng.mc_samples = 1
    elif change == "conv_kl":
        eng.net.layers[3].count_kl = True
    # a geometry other than the one the kernels are checked at
    elif change == "conv1_width":
        eng.net.layers[0].out_channels = 8
    elif change == "fc_width":
        eng.net.layers[9].out_dim = 64
    elif change == "image_side":
        eng.D = 32 * 32
    assert not FL.supports(eng), change


def test_fused_true_without_support_raises_and_cuda_refuses_cpu():
    with pytest.raises(ValueError, match="fused_inner=True"):
        _engine(fused_inner=True, mc_samples=1)
    cfg, _ = _cfgs()
    z = torch.zeros
    with pytest.raises(ValueError, match="CUDA"):
        FL.lenet_unroll(z(cfg.n_params), z(M, 1, 28, 28), z(M), z(1), z(M), z(T, cfg.n_eps),
                        1e-3, cfg, backend="cuda")


@pytest.mark.parametrize("bad", ["p0", "u", "y", "eps_in", "hist", "dlosses"])
def test_cuda_wrappers_validate_shapes(bad):
    """The wrappers check every extent the kernel reads before any pointer
    is passed; a correct CPU call gets as far as the device check."""
    cfg, _ = _cfgs()
    P, E = cfg.n_params, cfg.n_eps

    def f(name, *shape):
        return torch.zeros((shape[0] + (name == bad),) + shape[1:])

    y = torch.zeros(M + (bad == "y"), dtype=torch.int32)
    inner = (f("u", M, 1, 28, 28), y, f("v", M), f("alpha", 1), f("eps_in", T, E), 1e-3, cfg)
    calls = [(FL._lenet_fwd_cuda, (f("p0", P),) + inner, ("p0", "u", "y", "eps_in")),
             (FL._lenet_rev_cuda, (f("hist", T + 1, 3, P), f("pbar", P), f("dlosses", T)) + inner,
              ("hist", "dlosses", "u", "y", "eps_in"))]
    for fn, args, takes in calls:
        match = f"{bad}: expected shape" if bad in takes else "one CUDA device"
        with pytest.raises(ValueError, match=match):
            fn(*args)


def test_lenet_engine_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PSVI(DATA, **{**ENGINE_KW, "device": None})
