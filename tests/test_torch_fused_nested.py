"""The port's fused nested step against the JAX package's.

- ``fused_nested_outer(backend="torch")`` (the plain versions of the three
  CUDA kernels, hand-derived math) and ``backend="autograd"`` (the oracle)
  each match JAX ``fused_nested_outer(..., backend="xla")`` on the six
  categorical configs of ``tests/test_fused_nested.py`` and on
  ``psvi_fixed_u``, ``psvi_alpha_fixed_u``, ``psvi_no_rescaling`` and
  ``psvi_free_v`` (g_v of unnormalised weights), from the same
  NumPy inputs, with that file's tolerances, and on the Gaussian
  (regressor) configs — the three regressor methods on sinus with the
  1-20-1 net of ``tests/test_fused_nested.py:186-213`` and a 1-40-40-1 net
  — g_z included;
- one inner iteration's hand-derived VJP (``rev_iter_torch``) matches
  ``jax.vjp`` of the same one-iteration body and ``torch.autograd``, for
  both heads (z̄ included for the Gaussian one);
- ``supports()`` gates what the CUDA design can run;
- ``_nested_plan`` gives the CUDA ``nested_fwd``/``nested_rev`` a portable
  cluster that holds every sample once, with the maps in shared memory
  where they fit (both main paths and every cap of ``chip_smoke.py``);
- the redesigned kernels' summation order (per sample over the points,
  then over the samples, in fp32) keeps one iteration's gradient, p̄ and ū
  within ``chip_smoke.py``'s gates of float64 (an emulation: no kernel
  runs here).
"""

import torch_threads  # noqa: F401  (torch on this worker's share of the cores)

import dataclasses
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psvi_torch.data import DataBundle, read_dataset, read_regression_dataset
from psvi_torch.inference.psvi import PSVI, make_psvi_engine
from psvi_torch.models.layers import softplus
from psvi_torch.models.networks import make_dense
from psvi_torch.ops import elbo as TE
from psvi_torch.ops import fused_nested as FN
from psvi_tpu.models import networks as JN
from psvi_tpu.ops import elbo as JE
from psvi_tpu.ops import fused_nested as JFN
from psvi_tpu.ops import optim as JO
from psvi_tpu.utils.config import METHOD_SPECS

# the six configs of tests/test_fused_nested.py:130-141, at its sizes, then
# the four methods that fix u, v's rescaling or v's softmax
T, S, M, B = 5, 6, 20, 64
CONFIGS = [
    ("psvi_learn_v", "halfmoon", "logistic_regression"),
    ("psvi", "halfmoon", "logistic_regression"),
    ("psvi_alpha_v", "halfmoon", "logistic_regression"),
    ("psvi_learn_v", "four_blobs", "logistic_regression"),
    ("psvi_learn_v", "halfmoon", "fn"),
    ("psvi_learn_v", "four_blobs", "fn"),
    ("psvi_fixed_u", "four_blobs", "fn"),
    ("psvi_alpha_fixed_u", "halfmoon", "fn"),
    ("psvi_no_rescaling", "halfmoon", "logistic_regression"),
    ("psvi_free_v", "four_blobs", "fn"),
]


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _inputs(method, dataset, arch, seed=0):
    data = read_dataset(dataset)
    widths = (data.D, data.nc) if arch == "logistic_regression" else (data.D, 40, data.nc)
    spec = METHOD_SPECS[method]
    parameterised = spec.parameterised
    cfg = FN.FusedCfg(T=T, S=S, widths=widths, M=M, B=B, N=float(data.N),
                      parameterised=parameterised, use_alpha=spec.learn_alpha, prior_sd=1.0)
    rng = np.random.default_rng(seed)
    rho0 = math.log(math.expm1(1e-3))
    f32 = np.float32
    layers, eps_in, eps_out = [], [], []
    for i, o in cfg.layer_dims():
        b = 1.0 / math.sqrt(i)
        layers.append({"mu_w": rng.uniform(-b, b, (o, i)).astype(f32),
                       "rho_w": (rho0 + 0.1 * rng.standard_normal((o, i))).astype(f32),
                       "mu_b": rng.uniform(-b, b, o).astype(f32),
                       "rho_b": (rho0 + 0.1 * rng.standard_normal(o)).astype(f32)})
        eps_in.append({"w": rng.standard_normal((T, S, o, i)).astype(f32),
                       "b": rng.standard_normal((T, S, o)).astype(f32)})
        eps_out.append({"w": rng.standard_normal((S, o, i)).astype(f32),
                        "b": rng.standard_normal((S, o)).astype(f32)})
    iu, ib = rng.choice(data.N, M, replace=False), rng.choice(data.N, B, replace=False)
    if parameterised:
        v = (0.1 * rng.standard_normal(M)).astype(f32)
    elif spec.no_rescaling:  # the engine's v = 1/(M·N) (psvi.py:565-566)
        v = np.full(M, 1 / (M * data.N), f32)
    elif spec.learn_v:  # free weights, drifted apart from 1/M, one of them 0
        v = (rng.uniform(0.0, 2.0, M) / M).astype(f32)
        v[0] = 0.0
    else:
        v = np.full(M, 1 / M, f32)
    arrays = dict(layers=layers, eps_in=eps_in, eps_out=eps_out, u=data.x[iu],
                  z=data.y[iu], xb=data.x[ib], yb=data.y[ib], v=v,
                  alpha=np.array([0.1 if cfg.use_alpha else 0.0], f32), lr=1e-3)
    return cfg, arrays


def _jax_fused(cfg, a):
    """JAX fused_nested_outer(backend='xla') on the same numbers, with the
    flat eps layout of tests/test_fused_nested.py::_fused_args."""
    L = cfg.L
    jcfg = JFN.FusedCfg(T=cfg.T, S=cfg.S, widths=cfg.widths, M=cfg.M, B=cfg.B, N=cfg.N,
                        parameterised=cfg.parameterised, use_alpha=cfg.use_alpha,
                        prior_sd=cfg.prior_sd, likelihood=cfg.likelihood, tau=cfg.tau,
                        learn_z=cfg.learn_z)

    def flat_w(e, lyr, lead=()):
        n = int(np.prod(lead, dtype=int)) if lead else 1
        if lyr == L - 1:
            e = np.transpose(e, tuple(range(len(lead))) + (len(lead) + 1, len(lead), len(lead) + 2))
        return jnp.asarray(e.reshape(n * cfg.S * cfg.widths[lyr + 1], cfg.widths[lyr]))

    def flat_b(e, lyr, lead=()):
        n = int(np.prod(lead, dtype=int)) if lead else 1
        if lyr == L - 1:
            e = np.transpose(e, tuple(range(len(lead))) + (len(lead) + 1, len(lead)))
        return jnp.asarray(e.reshape(n * cfg.S * cfg.widths[lyr + 1], 1))

    params0 = []
    for p in a["layers"]:
        o = p["mu_b"].shape[0]
        params0 += [p["mu_w"], p["rho_w"], p["mu_b"].reshape(o, 1), p["rho_b"].reshape(o, 1)]
    if cfg.likelihood == "gaussian":  # raw targets as (1, P) rows
        ypse, ybat = (jnp.asarray(a[k]).reshape(1, -1) for k in ("z", "yb"))
    else:
        ypse, ybat = (jax.nn.one_hot(a[k].astype(np.int32), cfg.nc).T for k in ("z", "yb"))
    out = JFN.fused_nested_outer(
        tuple(jnp.asarray(x) for x in params0), jnp.asarray(a["u"]),
        jnp.asarray(a["v"]).reshape(1, cfg.M), jnp.asarray(a["alpha"]).reshape(1, 1),
        ypse, ybat,
        tuple(flat_w(e["w"], l, (cfg.T,)) for l, e in enumerate(a["eps_in"])),
        tuple(flat_b(e["b"], l, (cfg.T,)) for l, e in enumerate(a["eps_in"])),
        tuple(flat_w(e["w"], l) for l, e in enumerate(a["eps_out"])),
        tuple(flat_b(e["b"], l) for l, e in enumerate(a["eps_out"])),
        jnp.asarray(a["xb"]), jnp.asarray([[a["lr"]]], jnp.float32), jcfg, backend="xla")
    return [np.asarray(x) if not isinstance(x, tuple) else [np.asarray(y) for y in x]
            for x in out]


def _port_fused(cfg, a, backend):
    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    tree = lambda ls: [{k: t(v) for k, v in d.items()} for d in ls]  # noqa: E731
    return FN.fused_nested_outer(
        tree(a["layers"]), t(a["u"]), t(a["v"]), t(a["alpha"]), t(a["z"]), t(a["xb"]),
        t(a["yb"]), tree(a["eps_in"]), tree(a["eps_out"]), a["lr"], cfg, backend=backend)


@pytest.mark.parametrize("backend", ["torch", "autograd"])
@pytest.mark.parametrize("method,dataset,arch", CONFIGS)
def test_fused_matches_jax(method, dataset, arch, backend):
    cfg, a = _inputs(method, dataset, arch)
    j_loss, j_il, j_pT, j_gu, j_gv, j_ga, _ = _jax_fused(cfg, a)
    loss, il, pT, g_u, g_v, g_a, g_z = _port_fused(cfg, a, backend)
    assert not g_z.any()  # class labels carry no hypergradient
    # tolerances of tests/test_fused_nested.py:156-183
    assert np.isclose(float(loss), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(il.numpy(), j_il, rtol=2e-5)
    for l, p in enumerate(pT):
        np.testing.assert_allclose(p["mu_w"].numpy(), j_pT[4 * l], rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(p["mu_b"].numpy(), j_pT[4 * l + 2].ravel(), rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(p["rho_w"].numpy(), j_pT[4 * l + 1], rtol=2e-4, atol=1e-6)
    assert _cos(g_u, j_gu) > 0.999
    np.testing.assert_allclose(g_u.numpy(), j_gu, atol=2e-5 * float(1.0 + np.abs(j_gu).max()))
    assert _cos(g_v, j_gv) > 0.999
    if not cfg.parameterised:  # g_v of the raw weights, as the v ≥ 0 clamp sees it
        assert _agrees(g_v.numpy(), j_gv.reshape(g_v.shape))
    if cfg.use_alpha:
        # ∂/∂α sums N-scaled terms with heavy cancellation: a few % in f32
        assert np.isclose(float(g_a[0]), float(j_ga.ravel()[0]), rtol=0.05, atol=1e-6)


# the regressor configs: tests/test_fused_nested.py:186-213 (sinus, M=12,
# S=5, 1-20-1, T=4, τ=1.0, B=32) and the same with a 1-40-40-1 net
REG_METHODS = ["psvi_regressor", "psvi_learn_v_regressor", "psvi_alpha_v_regressor"]
REG_WIDTHS = [(1, 20, 1), (1, 40, 40, 1)]


def _gauss_inputs(method, widths, seed=0, T=4, S=5, M=12, B=32, tau=1.0):
    """Engine-like inputs of a regressor step on sinus from
    numpy.random.default_rng(seed): the pseudo-targets are the chosen rows'
    targets, jittered so they differ from the data."""
    data = read_regression_dataset("sinus")
    parameterised = method != "psvi_regressor"
    cfg = FN.FusedCfg(T=T, S=S, widths=widths, M=M, B=B, N=float(data.N),
                      parameterised=parameterised,
                      use_alpha=method == "psvi_alpha_v_regressor", prior_sd=1.0,
                      likelihood="gaussian", tau=tau, learn_z=True)
    rng = np.random.default_rng(seed)
    rho0 = math.log(math.expm1(1e-3))
    f32 = np.float32
    layers, eps_in, eps_out = [], [], []
    for i, o in cfg.layer_dims():
        b = 1.0 / math.sqrt(i)
        layers.append({"mu_w": rng.uniform(-b, b, (o, i)).astype(f32),
                       "rho_w": (rho0 + 0.1 * rng.standard_normal((o, i))).astype(f32),
                       "mu_b": rng.uniform(-b, b, o).astype(f32),
                       "rho_b": (rho0 + 0.1 * rng.standard_normal(o)).astype(f32)})
        eps_in.append({"w": rng.standard_normal((T, S, o, i)).astype(f32),
                       "b": rng.standard_normal((T, S, o)).astype(f32)})
        eps_out.append({"w": rng.standard_normal((S, o, i)).astype(f32),
                        "b": rng.standard_normal((S, o)).astype(f32)})
    iu, ib = rng.choice(data.N, M, replace=False), rng.choice(data.N, B, replace=False)
    v = (0.1 * rng.standard_normal(M)).astype(f32) if parameterised else np.full(M, 1 / M, f32)
    z = (data.y[iu, 0] + 0.3 * rng.standard_normal(M)).astype(f32)
    arrays = dict(layers=layers, eps_in=eps_in, eps_out=eps_out, u=data.x[iu], z=z,
                  xb=data.x[ib], yb=data.y[ib, 0], v=v,
                  alpha=np.array([0.1 if cfg.use_alpha else 0.0], f32), lr=1e-2)
    return cfg, arrays


def _agrees(x, ref, rel=1e-3, cos=0.9999):
    """cosine > ``cos`` and max |Δ| ≤ ``rel``·max |ref|: sums over S·M terms
    with cancellation, so an elementwise rtol is not meaningful."""
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return _cos(x, ref) > cos and np.abs(x - ref).max() <= rel * np.abs(ref).max()


@pytest.mark.parametrize("backend", ["torch", "autograd"])
@pytest.mark.parametrize("widths", REG_WIDTHS, ids=["1-20-1", "1-40-40-1"])
@pytest.mark.parametrize("method", REG_METHODS)
def test_fused_gaussian_matches_jax(method, widths, backend):
    cfg, a = _gauss_inputs(method, widths)
    j_loss, j_il, j_pT, j_gu, j_gv, j_ga, j_gz = _jax_fused(cfg, a)
    loss, il, pT, g_u, g_v, g_a, g_z = _port_fused(cfg, a, backend)
    assert np.isclose(float(loss), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(il.numpy(), j_il, rtol=2e-5)
    for l, p in enumerate(pT):
        for k, key in enumerate(("mu_w", "rho_w", "mu_b", "rho_b")):
            np.testing.assert_allclose(p[key].numpy(), j_pT[4 * l + k].reshape(p[key].shape),
                                       rtol=2e-4, atol=1e-6)
    for name, x, ref in (("g_u", g_u, j_gu), ("g_v", g_v, j_gv), ("g_z", g_z, j_gz)):
        assert _agrees(x.numpy(), ref.reshape(x.shape)), name
    if cfg.use_alpha:
        assert np.isclose(float(g_a[0]), float(j_ga.ravel()[0]), rtol=0.05, atol=1e-6)


def test_gaussian_without_learn_z_returns_zero_g_z():
    """As in JAX, g_z is zero when the targets are not learned."""
    cfg, a = _gauss_inputs("psvi_learn_v_regressor", (1, 20, 1))
    cfg = dataclasses.replace(cfg, learn_z=False)
    for backend in ("torch", "autograd"):
        out = _port_fused(cfg, a, backend)
        assert not out[-1].any() and out[3].abs().max() > 0


def _one_iter_inputs(seed=1, likelihood="categorical"):
    """fn 2-8-4 on four_blobs-like shapes (2-8-1 with real targets for the
    Gaussian head, τ = 0.5): one iteration t=3 with nonzero incoming Adam
    moments and random output cotangents."""
    gauss = likelihood == "gaussian"
    cfg = FN.FusedCfg(T=1, S=4, widths=(2, 8, 1 if gauss else 4), M=6, B=1, N=800.0,
                      parameterised=True, use_alpha=False, prior_sd=1.0,
                      likelihood=likelihood, tau=0.5, learn_z=gauss)
    rng = np.random.default_rng(seed)
    P, E = cfg.n_params, cfg.n_eps
    f32 = np.float32
    p = torch.tensor(rng.standard_normal(P).astype(f32) * 0.5)
    for q in FN.unpack_params(p, cfg):  # ρ near softplus⁻¹(1e-2)
        q["rho_w"].mul_(0.1).add_(-4.6)
        q["rho_b"].mul_(0.1).add_(-4.6)
    z = rng.standard_normal(6) if gauss else rng.integers(0, 4, 6)
    return cfg, dict(
        p=p.numpy(), m=(0.1 * rng.standard_normal(P)).astype(f32),
        n=(0.01 * rng.random(P)).astype(f32), eps=rng.standard_normal(E).astype(f32),
        u=rng.standard_normal((6, 2)).astype(f32), z=z.astype(f32),
        cw=(800 * rng.dirichlet(np.ones(6))).astype(f32),
        pbar=rng.standard_normal(P).astype(f32), mbar=rng.standard_normal(P).astype(f32),
        nbar=rng.standard_normal(P).astype(f32), t=3, lr=1e-2)


def _split(flat, cfg):
    """Flat (P,) → the JAX net's params tuple (dense dicts, {} for ReLU)."""
    dense = [{k: jnp.asarray(v.numpy()) for k, v in d.items()}
             for d in FN.unpack_params(torch.tensor(np.asarray(flat)), cfg)]
    out = []
    for l, d in enumerate(dense):
        if l:
            out.append({})
        out.append(d)
    return tuple(out)


def _join(tree):
    return np.concatenate([np.concatenate([np.ravel(d[k]) for k in ("mu_w", "rho_w", "mu_b", "rho_b")])
                           for d in tree if d])


def _check_one_iteration(likelihood):
    """``rev_iter_torch`` against ``jax.vjp`` and ``torch.autograd`` of one
    inner iteration ``(p, m, n, u, cw[, z]) → (p', m', n')``: the Gaussian
    head also differentiates w.r.t. the targets z."""
    cfg, a = _one_iter_inputs(likelihood=likelihood)
    gauss = likelihood == "gaussian"
    lik = dict(likelihood=likelihood, nc=cfg.nc, tau=cfg.tau)
    t, lr, b1, b2, ae = a["t"], a["lr"], cfg.b1, cfg.b2, cfg.adam_eps
    bc1, bc2s = cfg.bias_corrections(t)
    eps_layers = FN.unpack_eps(torch.tensor(a["eps"]), cfg)
    jnet = JN.make_fcnet(2, 8, cfg.nc, n_layers=1)
    jeps = []
    for l, (w, b) in enumerate(eps_layers):
        if l:
            jeps.append({})
        jeps.append({"w": jnp.asarray(w.numpy()), "b": jnp.asarray(b.numpy())})
    jeps = tuple(jeps)

    def body(params, m, n, u, cw, z):
        g = jax.grad(lambda q: JE.inner_elbo(jnet, q, jeps, u, z, cw, **lik))(params)
        tm = jax.tree_util.tree_map
        m = tm(lambda mm, gg: b1 * mm + (1.0 - b1) * gg, m, g)
        n = tm(lambda nn, gg: b2 * nn + (1.0 - b2) * jnp.square(gg), n, g)
        p = tm(lambda pp, mm, nn: pp - lr * (mm / bc1) / (JO._sqrt_safe(nn) / bc2s + ae),
               params, m, n)
        return p, m, n

    if gauss:
        primals = (jnp.asarray(a["z"]),)
        jbody = body
    else:  # class labels are not differentiated
        primals = ()

        def jbody(params, m, n, u, cw):
            return body(params, m, n, u, cw, a["z"])

    (p1, m1, n1), vjp = jax.vjp(jbody, _split(a["p"], cfg), _split(a["m"], cfg),
                                _split(a["n"], cfg), jnp.asarray(a["u"]), jnp.asarray(a["cw"]),
                                *primals)
    jp0, jm0, jn0, *rest = vjp((_split(a["pbar"], cfg), _split(a["mbar"], cfg),
                                _split(a["nbar"], cfg)))
    jax_out = [_join(jp0), _join(jm0), _join(jn0)] + [np.asarray(x) for x in rest]

    tt = lambda k: torch.tensor(np.asarray(a[k]))  # noqa: E731
    Y = FN._targets(tt("z"), cfg)
    port = FN.rev_iter_torch(t, tt("p"), torch.tensor(_join(m1)), torch.tensor(_join(n1)),
                             tt("pbar"), tt("mbar"), tt("nbar"), tt("u"), Y, tt("cw"),
                             tt("eps"), lr, cfg)

    # torch.autograd of the same body (port's own ELBO and Adam)
    net = make_dense(cfg.widths)
    names = ["pbar", "mbar", "nbar", "ubar", "cwbar"] + (["zbar"] if gauss else [])
    leaves = [tt(k).requires_grad_(True) for k in ("p", "m", "n", "u", "cw", "z")[:len(names)]]
    p, m, n, u, cw = leaves[:5]

    def tree(flat):
        out = []
        for l, d in enumerate(FN.unpack_params(flat, cfg)):
            if l:
                out.append({})
            out.append(d)
        return tuple(out)

    teps = []
    for l, (w, b) in enumerate(eps_layers):
        if l:
            teps.append({})
        teps.append({"w": w, "b": b})
    z = leaves[5] if gauss else tt("z")
    loss = TE.inner_elbo(net, tree(p), tuple(teps), u, z, cw, **lik)
    (g,) = torch.autograd.grad(loss, p, create_graph=True)
    p1t, m1t, n1t = FN._adam(p, m, n, g, t, lr, cfg)
    dot = (p1t * tt("pbar")).sum() + (m1t * tt("mbar")).sum() + (n1t * tt("nbar")).sum()
    auto = torch.autograd.grad(dot, leaves)

    assert len(jax_out) == len(auto) == len(names)
    for name, x, j, au in zip(names, port, jax_out, auto):
        x, au = x.detach().numpy(), au.numpy()
        # one iteration in fp32: cosine and max error relative to the largest entry
        for ref in (j, au):
            assert _cos(x, ref) > 0.99999, name
            assert np.abs(x - ref).max() <= 1e-4 * np.abs(ref).max(), name
    if not gauss:
        assert not port[5].any()


def test_one_iteration_vjp_matches_jax_and_autograd():
    _check_one_iteration("categorical")


def test_one_iteration_vjp_gaussian_matches_jax_and_autograd():
    _check_one_iteration("gaussian")


ENGINE_KW = dict(num_pseudo=20, mc_samples=6, inner_it=5, data_minibatch=64,
                 init_sd=1e-3, seed=0, num_epochs=1, device="cpu")


def test_supports_gating():
    data = read_dataset("halfmoon")
    for arch in ("logistic_regression", "fn"):
        assert FN.supports(PSVI(data, architecture=arch, **ENGINE_KW))
    assert FN.supports(PSVI(data, architecture="fn", n_layers=2, **ENGINE_KW))
    assert not FN.supports(PSVI(data, **{**ENGINE_KW, "mc_samples": 1}))
    assert not FN.supports(PSVI(data, **{**ENGINE_KW, "mc_samples": 33}))
    assert not FN.supports(PSVI(data, architecture="fn", n_hidden=400, **ENGINE_KW))
    assert not FN.supports(PSVI(data, **{**ENGINE_KW, "num_pseudo": 1990}))
    eng = PSVI(data, architecture="fn", **ENGINE_KW)
    last = eng.net.layers[-1]
    last.prior_sd = 2.0
    assert not FN.supports(eng)
    with pytest.raises(ValueError):
        PSVI(data, fused_inner=True, **{**ENGINE_KW, "mc_samples": 1})
    # 'auto' on the CPU takes the plain path; True takes the fused one
    assert PSVI(data, **ENGINE_KW)._step.__name__ == "_nested_step"
    assert PSVI(data, fused_inner=True, **ENGINE_KW)._step.__name__ == "_nested_step_fused"


def test_unported_options_raise():
    data = read_dataset("halfmoon")
    # every JAX option is ported: parallelism (queue A item 11) takes JAX's
    # errors, and streamed batches go through the fused step, as in JAX
    assert PSVI(data, mesh=None, **ENGINE_KW).mesh is None
    eng = PSVI(data, stream_data=True, fused_inner=True, **ENGINE_KW)
    assert FN.supports(eng) and eng._step.__name__ == "_nested_step_fused"
    with pytest.raises(ValueError, match="'mc' axis"):
        PSVI(data, shard_mc=True, **ENGINE_KW)
    assert PSVI(data, pretrain_epochs=5, **ENGINE_KW).pretrain_epochs == 5
    # the engine options are ported; the dense gate refuses all but inner Adam
    # and float32 compute
    for option in (dict(inner_unroll=2), dict(inner_optimizer="sgd"),
                   dict(compute_dtype="bfloat16")):
        eng = PSVI(data, **option, **ENGINE_KW)
        assert FN.supports(eng) == ("inner_unroll" in option)
    # the hyper trainer and the ablated method are ported: the plain path serves them
    assert PSVI(data, trainer="hyper", **ENGINE_KW)._step.__name__ == "_hyper_step"
    assert PSVI(data, method="psvi_ablated", **ENGINE_KW)._step.__name__ == "_nested_step"


# ---------------------------------------------------------------------------
# the cluster plan of nested_fwd and nested_rev, and the error budget of
# their summation order
# ---------------------------------------------------------------------------

REPO = Path(__file__).resolve().parents[1]


def _chip_smoke():
    """chip_smoke.py as a module (its cap configs and input makers)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
MAIN_PATHS = {  # widths, M, B, likelihood: the dense and the regression main path
    "four_blobs fn 2-40-4 M=48": ((2, 40, 4), 48, 128, "categorical"),
    "sinus 1-40-1 M=10": ((1, 40, 1), 10, 64, "gaussian"),
}


def _plan_cfg(name):
    """The step config the engine hands the kernels at a main path or at a
    cap of chip_smoke.py (the engine built on the CPU as check_caps builds it
    on the card)."""
    if name in MAIN_PATHS:
        widths, M, B, lik = MAIN_PATHS[name]
        return FN.FusedCfg(T=10, S=10, widths=widths, M=M, B=B, N=800.0, parameterised=True,
                           use_alpha=False, prior_sd=1.0, likelihood=lik,
                           learn_z=lik == "gaussian")
    seed, (_, D, nc, kw) = next((i, c) for i, c in enumerate(CS.CAPS) if c[0] == name)
    data = (CS.regression_bundle(DataBundle, D, seed=seed) if nc == 1
            else CS.synthetic_bundle(DataBundle, D, nc, seed=seed))
    eng = make_psvi_engine(data, inner_it=10, init_sd=1e-3, seed=seed, device="cpu", **kw)
    assert FN.supports(eng)
    return eng._fused_cfg(eng.data_minibatch)


def _check_plan(name, cfg, kernel):
    """A portable cluster (C <= 8), every sample held by exactly one block
    with at most ⌈S/C⌉ a block, the shared bytes the kernel's layout takes
    (within the card's 232,448 a block), the maps in shared memory wherever
    they fit and, with 8 blocks, at both main paths."""
    plan = FN._nested_plan(cfg, kernel)
    assert 1 <= plan.blocks <= FN.MAX_CLUSTER and plan.blocks <= cfg.S
    # block r holds samples [r·S/C, (r+1)·S/C) (csrc: make_ctx)
    C = plan.blocks
    blocks = [range(r * cfg.S // C, (r + 1) * cfg.S // C) for r in range(C)]
    assert sorted(s for b in blocks for s in b) == list(range(cfg.S))
    assert max(len(b) for b in blocks) == plan.samples_per_block
    assert plan.samples_per_block == -(-cfg.S // plan.blocks)
    fixed, per = FN._plan_floats(cfg, kernel)
    fits = 4 * (fixed + plan.samples_per_block * per) <= FN.SMEM_CAP
    assert plan.shared == fits
    assert plan.smem_bytes == 4 * (fixed + (plan.samples_per_block * per if fits else 0))
    assert plan.smem_bytes <= 232448
    if name in MAIN_PATHS:
        assert plan.shared and plan.blocks == 8 and plan.samples_per_block == 2
    return plan


@pytest.mark.parametrize("name", list(MAIN_PATHS) + [c[0] for c in CS.CAPS])
def test_nested_plan(name):
    """_nested_plan of nested_fwd and nested_rev from the config alone
    (_check_plan)."""
    cfg = _plan_cfg(name)
    for kernel in ("nested_fwd", "nested_rev"):
        _check_plan(name, cfg, kernel)
    with pytest.raises(ValueError):
        FN._nested_plan(cfg, "nested_rev", blocks=FN.MAX_CLUSTER + 1)


@pytest.mark.parametrize("name", list(MAIN_PATHS) + [c[0] for c in CS.CAPS])
def test_nested_outer_plan(name):
    """_nested_plan of nested_outer (_check_plan): its layout holds θ, z and
    δ over the M + B points, the p̄_T partials, ū_s, the pseudo NLLs and four
    sums a sample (66 KB at four_blobs, 26 KB at sinus); two samples' fit at
    both main paths, and no cap's fit, so every cap runs the global maps."""
    cfg = _plan_cfg(name)
    plan = _check_plan(name, cfg, "nested_outer")
    nE, NPU = cfg.n_eps // cfg.S, (cfg.M + cfg.B) * cfg.n_units
    assert FN._plan_floats(cfg, "nested_outer") == (
        0, 3 * nE + 2 * NPU + cfg.M * cfg.D + cfg.M + 4)
    if name in MAIN_PATHS:
        kb = {"four_blobs fn 2-40-4 M=48": 66, "sinus 1-40-1 M=10": 26}[name]
        assert round(4 * FN._plan_floats(cfg, "nested_outer")[1] / 1000) == kb
    else:
        assert not plan.shared and plan.smem_bytes == 0 and plan.blocks == min(8, cfg.S)
        with pytest.raises(ValueError):
            FN._nested_plan(cfg, "nested_outer", shared=True)


def _seq(x, dim):
    """Σ over ``dim`` one term at a time in index order, in x's dtype (the
    kernels' order; each product here is rounded before it is added, where a
    kernel's fmaf rounds once)."""
    acc = torch.zeros_like(x.select(dim, 0))
    for k in range(x.shape[dim]):
        acc = acc + x.select(dim, k)
    return acc


def _kernel_order_grad(c, u, cfg):
    """The inner gradient as nested_fwd and nested_rev sum it: per sample
    over the points in order (blk_sample_sums), then over the samples in
    order (sum_peers_eps), from the maps of ``_inner_value_grad``'s cache."""
    sp2 = cfg.prior_sd ** 2
    quads = []
    for l, ((mw, rw, mb, rb), (sw, sb), (ew, eb)) in enumerate(
            zip(c["prm"], c["sds"], c["eps"])):
        d = c["deltas"][l]  # (S, M, o)
        a = FN._layer_input(c["zs"], u, l)
        a = a.expand(d.shape[0], *a.shape) if a.dim() == 2 else a
        GW = _seq(d[..., :, None] * a[..., None, :], 1)  # (S, o, i)
        Gb = _seq(d, 1)
        out = []
        for G, e, mu, rho, sd in ((GW, ew, mw, rw, sw), (Gb, eb, mb, rb, sb)):
            gs, gse = _seq(G, 0), _seq(G * e, 0)
            out += [gs + mu / sp2, torch.sigmoid(rho) * (gse - 1.0 / sd + sd / sp2)]
        quads.append((out[0], out[1], out[2], out[3]))
    return FN._pack4(quads)


def _kernel_order_rev(t, p, m_t, n_t, pbar, u, Y, cw, eps_t, lr, cfg):
    """One reverse iteration's p̄ increment H·ḡ_t (p̄_{t-1} − p̄_t) and ū, and
    the recomputed gradient, as nested_rev sums them: the
    recomputed gradient in the kernels' order, the Adam VJP, the tangent
    pass, then per sample over the points (Ġ, blk_tangent_sums) or over the
    units (ū), and over the samples in order. Zero incoming m̄, n̄."""
    sp2 = cfg.prior_sd ** 2
    _, _, c = FN._inner_value_grad(p, eps_t, u, Y, cw, cfg)
    g = _kernel_order_grad(c, u, cfg)
    bc1, bc2s = cfg.bias_corrections(t)
    den = FN._sqrt_safe(n_t) / bc2s + cfg.adam_eps
    mbar = -pbar * lr / (bc1 * den)
    pos = n_t > 0
    dsq = torch.where(pos, 0.5 / torch.sqrt(torch.where(pos, n_t, 1.0)), 0.0)
    nbar = pbar * lr * (m_t / bc1) / (den * den) * dsq / bc2s
    gbar = (1.0 - cfg.b1) * mbar + 2.0 * (1.0 - cfg.b2) * g * nbar
    # the tangent pass in direction ḡ (rev_iter_torch's)
    prm, eps, Ws, zs, hvp, deltas = (c[k] for k in ("prm", "eps", "Ws", "zs", "hvp", "deltas"))
    dirs = FN._mu_rho(gbar, cfg)
    Wd = [gmw + torch.sigmoid(rw) * grw * ew
          for (gmw, grw, _, _), (_, rw, _, _), (ew, _) in zip(dirs, prm, eps)]
    bd = [gmb + torch.sigmoid(rb) * grb * eb
          for (_, _, gmb, grb), (_, _, _, rb), (_, eb) in zip(dirs, prm, eps)]
    zd = []
    for l in range(cfg.L):
        if l == 0:
            zl = torch.einsum("pi,soi->spo", u, Wd[0])
        else:
            zl = (torch.matmul(zd[-1] * (zs[l - 1] > 0), Ws[l].transpose(1, 2))
                  + torch.matmul(torch.relu(zs[l - 1]), Wd[l].transpose(1, 2)))
        zd.append(zl + bd[l][:, None, :])
    dd = [None] * cfg.L
    dd[-1] = cw[None, :, None] * hvp(zd[-1])
    for l in range(cfg.L - 1, 0, -1):
        dd[l - 1] = (torch.matmul(dd[l], Ws[l]) + torch.matmul(deltas[l], Wd[l])) * (zs[l - 1] > 0)
    # ū_s[m, k] = Σ_oo δ̇·W + δ·Ẇ, the two terms of each unit in turn
    terms = torch.stack([dd[0][..., :, None] * Ws[0][:, None], deltas[0][..., :, None] * Wd[0][:, None]],
                        dim=3)  # (S, M, o, 2, D)
    ubar = _seq(_seq(terms.flatten(2, 3), 2), 0)
    hv = []
    for l, ((gmw, grw, gmb, grb), (mw, rw, mb, rb), (sw, sb), (ew, eb), (hw, hb)) in enumerate(
            zip(dirs, prm, c["sds"], eps, c["hs"])):
        e, d = dd[l], deltas[l]
        if l == 0:
            a = u.expand(e.shape[0], *u.shape)
            GWd = _seq(e[..., :, None] * a[..., None, :], 1)
        else:
            a, ad = torch.relu(zs[l - 1]), zd[l - 1] * (zs[l - 1] > 0)
            pair = torch.stack([e[..., :, None] * a[..., None, :], d[..., :, None] * ad[..., None, :]],
                               dim=2)  # (S, M, 2, o, i)
            GWd = _seq(pair.flatten(1, 2), 1)
        Gbd = _seq(e, 1)
        quad = []
        for G, gm, gr, rho, sd, ep, h in ((GWd, gmw, grw, rw, sw, ew, hw),
                                          (Gbd, gmb, grb, rb, sb, eb, hb)):
            sg = torch.sigmoid(rho)
            quad += [_seq(G, 0) + gm / sp2,
                     sg * (1.0 - sg) * gr * h + sg * (_seq(G * ep, 0) + (1.0 / (sd * sd) + 1.0 / sp2) * sg * gr)]
        hv.append(tuple(quad))
    return FN._pack4(hv), ubar, g


def test_kernel_summation_order_keeps_fp32_accuracy():
    """At four_blobs fn 2-40-4 (M=48, S=10, T=10, chip_smoke.py's inputs of
    the kernels phase), the summation order of the redesigned nested_fwd and
    nested_rev — each per-parameter sum over (sample, point) taken per
    sample over the points in order, then over the samples in order — run in
    fp32 on the CPU keeps one inner iteration's gradient, one reverse
    iteration's p̄ increment H·ḡ_t (p̄ itself is 10³ times larger, and its
    own rounding would hide the sums' error) and its ū (t = T) within
    chip_smoke.py's gates of the plain version run in float64: cosine >
    0.9999 and max |Δ| <= 1e-3·max |ref| (they come out near 1e-6). This is
    an error-budget model of the kernels' arithmetic, emulated here: it
    calls no kernel, and holds whatever the kernels do. Their own results
    are checked only on the card, by chip_smoke.py against the plain fp32
    versions."""
    blobs = read_dataset("four_blobs")
    cfg = CS.main_cfg(FN, blobs, [2, 40, 4], 48, True, False)
    a = CS.kernel_inputs(FN, cfg, blobs.x, blobs.y, 1, torch.device("cpu"))
    p0, u, z, xb, yb, v, al, e_in, e_out, lr = (a[k] for k in (
        "p0", "u", "z", "xb", "yb", "v", "alpha", "e_in", "e_out", "lr"))
    _, hist, cw = FN.nested_fwd_torch(p0, u, z, v, al, e_in, lr, cfg)
    pbar = FN.nested_outer_torch(hist[cfg.T, 0], u, z, cw, xb, yb, e_out, cfg)[1]
    Y = FN._targets(z, cfg)
    t = cfg.T
    args = (hist[t - 1, 0], hist[t, 1], hist[t, 2], pbar, u, Y, cw, e_in[t - 1])
    pb32, ub32, g32 = _kernel_order_rev(t, *args, lr, cfg)
    d64 = [x.double() for x in args]
    _, g64, _ = FN._inner_value_grad(d64[0], d64[7], d64[4], d64[5], d64[6], cfg)
    zero = torch.zeros_like(d64[3])
    pb64, _, _, ub64, _, _ = FN.rev_iter_torch(t, d64[0], d64[1], d64[2], d64[3], zero, zero,
                                              d64[4], d64[5], d64[6], d64[7], lr, cfg)
    for name, x, ref in (("g", g32, g64), ("pbar increment", pb32, pb64 - d64[3]),
                         ("ubar", ub32, ub64)):
        x, ref = x.double().numpy(), ref.numpy()
        assert _cos(x, ref) > 0.9999, name
        assert np.abs(x - ref).max() <= 1e-3 * np.abs(ref).max(), name


def _outer_kernel_order(pT, u, y, cw, xb, yb, eps_out, cfg):
    """nested_outer_torch's loss and cotangents as the redesigned
    nested_outer sums them, in the inputs' dtype: each sample's NLLs and NKL
    terms one at a time in order (the kernel adds them in a tree, which is
    more exact), the IW coefficients in sample order, each p̄_T term per
    sample over the M + B points in order with its NKL terms, then over the
    samples in order; ū per sample over the units, then over the samples;
    c̄w over the samples with the NLL centred; z̄ over the samples."""
    S, M, B, sp = cfg.S, cfg.M, cfg.B, cfg.prior_sd
    X = torch.cat([u, xb])
    Y = torch.cat([FN._targets(y, cfg), FN._targets(yb, cfg)])
    prm, eps = FN._mu_rho(pT, cfg), FN.unpack_eps(eps_out, cfg)
    sds = [(softplus(rw), softplus(rb)) for _, rw, _, rb in prm]
    Ws = [mw + sw * ew for (mw, _, _, _), (sw, _), (ew, _) in zip(prm, sds, eps)]
    bs = [mb + sb * eb for (_, _, mb, _), (_, sb), (_, eb) in zip(prm, sds, eps)]
    zs = FN._forward(Ws, bs, X)
    nll, G, _ = FN._head(zs[-1], Y, cfg)
    pseudo = _seq(nll[:, :M] * cw, 1)
    data = (cfg.N / B) * _seq(nll[:, M:], 1)
    hl, lsp = FN._HALF_LOG_2PI, math.log(sp)
    terms = [(-0.5 * (th / sp) ** 2 - lsp - hl) - (-0.5 * ((th - mu) / sd) ** 2 - torch.log(sd) - hl)
             for (mw, _, mb, _), (sw, sb), W, b in zip(prm, sds, Ws, bs)
             for th, mu, sd in ((W.flatten(1), mw.flatten(), sw.flatten()), (b, mb, sb))]
    nkl = _seq(torch.cat(terms, 1), 1)
    # outer_coefficients: one thread, the samples in order, d centred twice
    lw = -pseudo + nkl
    mean_lw = _seq(lw, 0) / S
    e = torch.exp(lw - lw.max())
    w = e / _seq(e, 0)
    d = data - pseudo
    dref = _seq(w * d, 0)
    dcbar = _seq(w * (d - dref), 0)
    q = w * ((d - dref) - dcbar) - 1.0 / S
    c_ps = -w - q
    coef = torch.cat([c_ps[:, None] * cw[None, :], (w * (cfg.N / B))[:, None].expand(S, B)], 1)
    deltas = FN._backward(Ws, zs, coef[..., None] * G)
    bars = []
    for l, ((mw, rw, mb, rb), (sw, sb), (ew, eb), W, b) in enumerate(zip(prm, sds, eps, Ws, bs)):
        dl = deltas[l]
        a = FN._layer_input(zs, X, l)
        a = a.expand(S, *a.shape) if a.dim() == 2 else a
        quad = []
        for Gs, th, mu, sd, rho, ep, qs in ((_seq(dl[..., :, None] * a[..., None, :], 1), W, mw,
                                             sw, rw, ew, q[:, None, None]),
                                            (_seq(dl, 1), b, mb, sb, rb, eb, q[:, None])):
            r = (th - mu) / sd
            thb = Gs + qs * (-th / sp ** 2 + r / sd)
            quad += [_seq(thb - qs * r / sd, 0),
                     _seq(ep * thb + qs * (1.0 - r * r) / sd, 0) * torch.sigmoid(rho)]
        bars.append(tuple(quad))
    ubar = _seq(_seq(deltas[0][:, :M, :, None] * Ws[0][:, None], 2), 0)
    nps = nll[:, :M]
    cwbar = _seq(c_ps[:, None] * (nps - _seq(nps, 0) / S), 0)
    zbar = -_seq(deltas[-1][:, :M, 0], 0) if cfg.gaussian else torch.zeros_like(cw)
    return dref + dcbar - mean_lw, FN._pack4(bars), ubar, cwbar, zbar


@pytest.mark.parametrize("name", list(MAIN_PATHS))
def test_outer_summation_order_keeps_fp32_accuracy(name):
    """At both main paths (four_blobs fn 2-40-4 M=48 B=128 and sinus 1-40-1
    M=10 B=64, S=10, chip_smoke.py's inputs of the kernels phase) the
    summation order of the redesigned nested_outer, run in fp32 on the CPU,
    keeps the loss within RTOL_LOSS and p̄_T, ū, c̄w and z̄ within
    chip_smoke.py's gates of nested_outer_torch run in float64: cosine >
    0.9999 and max |Δ| <= 1e-3·max |ref|. An error-budget model of the
    kernel's arithmetic: it calls no kernel; the kernel itself is held to
    the plain fp32 version on the card by chip_smoke.py."""
    widths, M_, B_, lik = MAIN_PATHS[name]
    data = read_dataset("four_blobs") if lik == "categorical" else read_regression_dataset("sinus")
    cfg = CS.main_cfg(FN, data, list(widths), M_, True, False, B=B_,
                      tau=0.1 if lik == "gaussian" else None)
    a = CS.kernel_inputs(FN, cfg, data.x, data.y, 0, torch.device("cpu"))
    p0, u, z, xb, yb, v, al, e_in, e_out, lr = (a[k] for k in (
        "p0", "u", "z", "xb", "yb", "v", "alpha", "e_in", "e_out", "lr"))
    _, hist, cw = FN.nested_fwd_torch(p0, u, z, v, al, e_in, lr, cfg)
    args = (hist[cfg.T, 0], u, z, cw, xb, yb, e_out)
    got = _outer_kernel_order(*args, cfg)
    ref = FN.nested_outer_torch(*(x.double() if x.is_floating_point() else x for x in args), cfg)
    assert abs(float(got[0]) - float(ref[0])) <= CS.RTOL_LOSS * abs(float(ref[0]))
    names = ("pbar", "ubar", "cwbar") + (("zbar",) if cfg.gaussian else ())
    for i, nm in enumerate(names, 1):
        x, r = got[i].double().numpy(), ref[i].numpy()
        assert _cos(x, r) > CS.COS_MIN, nm
        assert np.abs(x - r).max() <= CS.REL_G * np.abs(r).max(), nm
