"""The port's dense layers and ELBO functions against the JAX package, with
the JAX parameters carried across by ``params_from_jax`` and the same
NumPy noise handed to both sides."""

import torch_threads  # noqa: F401  (torch on this worker's share of the cores)

import jax
import numpy as np
import pytest
import torch

from psvi_torch.models import layers as TL
from psvi_torch.models.networks import make_fcnet, make_logreg, set_up_model
from psvi_torch.ops import elbo as TE
from psvi_torch.utils.convert import params_from_jax
from psvi_tpu.models import layers as JL
from psvi_tpu.models import networks as JN
from psvi_tpu.ops import elbo as JE

# fp32 on both sides, the same formulas summed in another order
RTOL, ATOL = 2e-5, 1e-6
S = 4


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.tensor(np.asarray(x, dtype=np.float32))


def _close(a, b, rtol=RTOL, atol=ATOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


def _nets(kind):
    if kind == "logreg":
        return JN.make_logreg(3, 4, init_sd=1e-2), make_logreg(3, 4, init_sd=1e-2)
    n_layers = 2 if kind == "fn2" else 1
    return (JN.make_fcnet(3, 5, 4, n_layers=n_layers, init_sd=0.1),
            make_fcnet(3, 5, 4, n_layers=n_layers, init_sd=0.1))


def _setup(kind, seed=0):
    jnet, tnet = _nets(kind)
    jparams = jnet.init(jax.random.PRNGKey(seed))
    # spread the sds so softplus/σ terms are not all equal
    rng = np.random.default_rng(seed)
    jparams = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.3 * rng.standard_normal(np.shape(a)).astype(np.float32),
        jparams)
    eps_np = jax.tree_util.tree_map(np.asarray, jnet.sample_eps(jax.random.PRNGKey(seed + 1), S))
    return (jnet, tnet, jparams, params_from_jax(jparams, device="cpu"), eps_np,
            params_from_jax(eps_np, device="cpu"), rng)


@pytest.mark.parametrize("batched", [False, True])
def test_vilinear_apply_kl_nkl(batched):
    jl, tl = JL.VILinear(3, 5, init_sd=0.05, prior_sd=0.7), TL.VILinear(3, 5, init_sd=0.05, prior_sd=0.7)
    jp = jax.tree_util.tree_map(np.asarray, jl.init(jax.random.PRNGKey(0)))
    e = jax.tree_util.tree_map(np.asarray, jl.sample_eps(jax.random.PRNGKey(1), S))
    x = np.random.default_rng(2).standard_normal((S, 7, 3) if batched else (7, 3)).astype(np.float32)
    tp, te = params_from_jax(jp, device="cpu"), params_from_jax(e, device="cpu")
    _close(tl.apply(tp, te, _t(x)), jl.apply(jp, e, x))
    _close(tl.kl(tp), jl.kl(jp))
    _close(tl.nkl(tp, te), jl.nkl(jp, e), rtol=1e-4)


def test_vilinear_init_matches_jax_distribution():
    gen = torch.Generator().manual_seed(0)
    tl, jl = TL.VILinear(16, 8, init_sd=1e-3), JL.VILinear(16, 8, init_sd=1e-3)
    tp, jp = tl.init(gen), jl.init(jax.random.PRNGKey(0))
    for k in tp:
        assert tuple(tp[k].shape) == tuple(jp[k].shape)
    _close(tp["rho_w"], jp["rho_w"])  # the same constant softplus⁻¹(init_sd)
    bound = 1.0 / np.sqrt(16)
    assert float(tp["mu_w"].abs().max()) <= bound
    _close(TL.inverse_softplus(1e-3), JL.inverse_softplus(np.float32(1e-3)))


@pytest.mark.parametrize("kind", ["logreg", "fn", "fn2"])
def test_sequential_apply_kl_nkl(kind):
    jnet, tnet, jp, tp, je, te, rng = _setup(kind)
    x = rng.standard_normal((9, 3)).astype(np.float32)
    _close(tnet.apply(tp, te, _t(x)), jnet.apply(jp, je, x), rtol=1e-4, atol=1e-5)
    _close(tnet.kl(tp), jnet.kl(jp))
    _close(tnet.nkl(tp, te), jnet.nkl(jp, je), rtol=1e-4)
    assert tnet.prep_input(_t(x)).shape == (9, 3)


def test_set_up_model_dense_dispatch():
    net = set_up_model("fn", 2, 40, 4, 1e-3, n_layers=1)
    assert [type(l).__name__ for l in net.layers] == ["VILinear", "ReLU", "VILinear"]
    assert [type(l).__name__ for l in set_up_model("logistic_regression", 2, None, 2, 1e-3).layers] \
        == ["VILinear"]
    # the model zoo's architectures build (tests/test_torch_model_zoo.py
    # holds them against JAX)
    assert type(set_up_model("alexnet", 3072, None, 10, 1e-3, n_channels=3).layers[0]).__name__ \
        == "VIConv2d"
    with pytest.raises(ValueError):
        set_up_model("nope", 2, 4, 2, 1e-3)


def test_categorical_and_gaussian_nll():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((S, 6, 4)).astype(np.float32) * 3
    y = rng.integers(0, 4, 6).astype(np.float32)
    _close(TE.categorical_nll(_t(logits), _t(y)), JE.categorical_nll(logits, y))
    _close(TE.nll_fn("categorical", False, 4)(_t(logits), _t(y)),
           JE.nll_fn("categorical", False, 4)(logits, y))
    preds = rng.standard_normal((S, 6)).astype(np.float32)
    tgt = rng.standard_normal(6).astype(np.float32)
    _close(TE.gaussian_nll(_t(preds), _t(tgt), 0.3), JE.gaussian_nll(preds, tgt, 0.3))
    _close(TE.nll_fn("gaussian", False, 1, 0.3)(_t(preds[..., None]), _t(tgt)),
           JE.nll_fn("gaussian", False, 1, 0.3)(preds[..., None], tgt))
    # learn_z: the soft-label KLDiv NLL over raw label logits z (N, nc)
    zl = rng.standard_normal((6, 4)).astype(np.float32)
    _close(TE.nll_fn("categorical", True, 4)(_t(logits), _t(zl)),
           JE.nll_fn("categorical", True, 4)(logits, zl), rtol=1e-5)


@pytest.mark.parametrize("kind", ["logreg", "fn"])
def test_inner_and_outer_elbo(kind):
    jnet, tnet, jp, tp, je, te, rng = _setup(kind, seed=4)
    M, B, N = 5, 7, 300
    u = rng.standard_normal((M, 3)).astype(np.float32)
    z = rng.integers(0, 4, M).astype(np.float32)
    xb = rng.standard_normal((B, 3)).astype(np.float32)
    yb = rng.integers(0, 4, B).astype(np.float32)
    cw = (N * rng.dirichlet(np.ones(M))).astype(np.float32)
    _close(TE.inner_elbo(tnet, tp, te, _t(u), _t(z), _t(cw), nc=4),
           JE.inner_elbo(jnet, jp, je, u, z, cw, nc=4), rtol=1e-5)
    _close(TE.psvi_elbo(tnet, tp, te, _t(u), _t(z), _t(cw), _t(xb), _t(yb), N, nc=4),
           JE.psvi_elbo(jnet, jp, je, u, z, cw, xb, yb, N, nc=4), rtol=1e-4)
    # gradients w.r.t. u through the outer objective
    tu = _t(u).requires_grad_(True)
    (gu,) = torch.autograd.grad(
        TE.psvi_elbo(tnet, tp, te, tu, _t(z), _t(cw), _t(xb), _t(yb), N, nc=4), tu)
    jgu = np.asarray(jax.grad(
        lambda uu: JE.psvi_elbo(jnet, jp, je, uu, z, cw, xb, yb, N, nc=4))(u))
    # The IW coefficients of the per-sample pseudo terms sum to zero, so the
    # u-gradient is a difference of terms ~40x its size: compare by cosine
    # and by max error relative to the largest entry.
    gu = gu.numpy()
    cos = float(np.sum(gu * jgu) / (np.linalg.norm(gu) * np.linalg.norm(jgu)))
    assert cos > 0.9999
    assert np.abs(gu - jgu).max() <= 1e-3 * np.abs(jgu).max()


@pytest.mark.parametrize("correction", [True, False])
def test_importance_weights_and_predictive(correction):
    jnet, tnet, jp, tp, je, te, rng = _setup("fn", seed=5)
    M = 5
    u = rng.standard_normal((M, 3)).astype(np.float32)
    z = rng.integers(0, 4, M).astype(np.float32)
    cw = (0.01 * rng.dirichlet(np.ones(M))).astype(np.float32)
    jlw = JE.importance_log_weights(jnet, jp, je, u, z, cw, nc=4)
    tlw = TE.importance_log_weights(tnet, tp, te, _t(u), _t(z), _t(cw), nc=4)
    _close(tlw, jlw, rtol=1e-4)
    logits = rng.standard_normal((S, 6, 4)).astype(np.float32)
    jprobs, jw = JE.predictive_mixture(logits, np.asarray(jlw), correction=correction)
    tprobs, tw = TE.predictive_mixture(_t(logits), _t(np.asarray(jlw)), correction=correction)
    _close(tprobs, jprobs)
    _close(tw, jw)
    fv = rng.dirichlet(np.ones(M)).astype(np.float32)
    for a, b in zip(TE.iw_diagnostics(tw, _t(fv), M), JE.iw_diagnostics(jw, fv, M)):
        _close(a, b)
