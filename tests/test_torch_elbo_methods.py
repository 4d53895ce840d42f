"""The objectives of the remaining methods against the JAX package: the
soft-label NLL of learned categorical labels (learn_z) in the inner and
outer ELBOs and the evaluation weights, and the ablated ELBO, on the same
parameters and noise (``params_from_jax``)."""

import torch_threads  # noqa: F401  (torch on this worker's share of the cores)

import jax
import numpy as np
import pytest
import torch

from psvi_torch.models.networks import make_fcnet, make_logreg
from psvi_torch.ops import elbo as TE
from psvi_torch.utils.convert import params_from_jax
from psvi_tpu.models import networks as JN
from psvi_tpu.ops import elbo as JE

S, NC, M, B, N = 4, 4, 5, 7, 300
RTOL = 1e-5


def _t(x):
    return torch.tensor(np.asarray(x, dtype=np.float32))


def _close(a, b, rtol=RTOL, atol=1e-6):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _setup(kind, seed):
    if kind == "logreg":
        jnet, tnet = JN.make_logreg(3, NC, init_sd=1e-2), make_logreg(3, NC, init_sd=1e-2)
    else:
        jnet, tnet = JN.make_fcnet(3, 5, NC, init_sd=0.1), make_fcnet(3, 5, NC, init_sd=0.1)
    rng = np.random.default_rng(seed)
    jp = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.3 * rng.standard_normal(np.shape(a)).astype(np.float32),
        jnet.init(jax.random.PRNGKey(seed)))
    je = jax.tree_util.tree_map(np.asarray, jnet.sample_eps(jax.random.PRNGKey(seed + 1), S))
    data = dict(
        u=rng.standard_normal((M, 3)).astype(np.float32),
        # raw soft-label logits; one class far below the rest, so that its
        # datapoint softmax underflows to 0 in a column (the p log p = 0 branch)
        z=np.concatenate([rng.standard_normal((M, NC - 1)),
                          np.full((M, 1), -200.0)], axis=1).astype(np.float32),
        xb=rng.standard_normal((B, 3)).astype(np.float32),
        yb=rng.integers(0, NC, B).astype(np.float32),
        cw=(N * rng.dirichlet(np.ones(M))).astype(np.float32))
    return (jnet, tnet, jp, params_from_jax(jp, device="cpu"), je,
            params_from_jax(je, device="cpu"), data)


def test_soft_label_nll():
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((S, 6, NC))).astype(np.float32)
    z = rng.standard_normal((6, NC)).astype(np.float32)
    z[2, 1] = -200.0  # softmax over the datapoint axis underflows: p = 0
    _close(TE.soft_label_nll(_t(logits), _t(z)), JE.soft_label_nll(logits, z))
    assert TE.soft_label_nll(_t(logits), _t(z)).shape == (S, 6)


@pytest.mark.parametrize("kind", ["logreg", "fn"])
def test_learn_z_inner_and_outer_elbo(kind):
    jnet, tnet, jp, tp, je, te, d = _setup(kind, seed=4)
    u, z, xb, yb, cw = (d[k] for k in ("u", "z", "xb", "yb", "cw"))
    _close(TE.inner_elbo(tnet, tp, te, _t(u), _t(z), _t(cw), learn_z=True, nc=NC),
           JE.inner_elbo(jnet, jp, je, u, z, cw, learn_z=True, nc=NC))
    _close(TE.psvi_elbo(tnet, tp, te, _t(u), _t(z), _t(cw), _t(xb), _t(yb), N, learn_z=True,
                        nc=NC),
           JE.psvi_elbo(jnet, jp, je, u, z, cw, xb, yb, N, learn_z=True, nc=NC))
    # the outer gradient in (u, z) through the centred IW sum, on labels of
    # moderate size: where p underflows to 0, JAX's fp32 gradient on the CPU
    # is NaN (its 1e-38 clip is a denormal, flushed to 0, and log 0 enters
    # the untaken branch of the where), the port's 0
    z = z.copy()
    z[:, -1] = 0.5
    tu, tz = _t(u).requires_grad_(True), _t(z).requires_grad_(True)
    gu, gz = torch.autograd.grad(TE.psvi_elbo(tnet, tp, te, tu, tz, _t(cw), _t(xb), _t(yb), N,
                                              learn_z=True, nc=NC), (tu, tz))
    jgu, jgz = jax.grad(lambda a, b: JE.psvi_elbo(jnet, jp, je, a, b, cw, xb, yb, N,
                                                  learn_z=True, nc=NC), argnums=(0, 1))(u, z)
    for g, jg in ((gu.numpy(), np.asarray(jgu)), (gz.numpy(), np.asarray(jgz))):
        assert _cos(g, jg) > 0.9999
        assert np.abs(g - jg).max() <= 1e-3 * np.abs(jg).max()


@pytest.mark.parametrize("likelihood", ["categorical", "gaussian"])
def test_ablated_elbo(likelihood):
    jnet, tnet, jp, tp, je, te, d = _setup("fn", seed=6)
    xb, yb = d["xb"], d["yb"]
    kw = dict(likelihood=likelihood, nc=NC, tau=0.5)
    if likelihood == "gaussian":  # one output per sample, real targets
        jnet, tnet = JN.make_fcnet(3, 5, 1, init_sd=0.1), make_fcnet(3, 5, 1, init_sd=0.1)
        jp = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(6)))
        je = jax.tree_util.tree_map(np.asarray, jnet.sample_eps(jax.random.PRNGKey(7), S))
        tp, te = params_from_jax(jp, device="cpu"), params_from_jax(je, device="cpu")
        yb = np.random.default_rng(6).standard_normal(B).astype(np.float32)
    _close(TE.ablated_elbo(tnet, tp, te, _t(xb), _t(yb), N, **kw),
           JE.ablated_elbo(jnet, jp, je, xb, yb, N, **kw))


@pytest.mark.parametrize("kind", ["logreg", "fn"])
def test_learn_z_importance_log_weights(kind):
    """The KLDiv term summed over S, then weighted: one scalar added to
    every sample's NKL (ref psvi_classes.py:1052-1056)."""
    jnet, tnet, jp, tp, je, te, d = _setup(kind, seed=8)
    cw = (0.01 * d["cw"] / N).astype(np.float32)
    tlw = TE.importance_log_weights(tnet, tp, te, _t(d["u"]), _t(d["z"]), _t(cw),
                                    learn_z=True, nc=NC)
    _close(tlw, JE.importance_log_weights(jnet, jp, je, d["u"], d["z"], cw, learn_z=True,
                                          nc=NC))
    assert tlw.shape == (S,)
