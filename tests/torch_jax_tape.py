"""Record the JAX package's random draws in the order it takes them, and
feed them to the port's draw functions in the same order.

``record(mp)`` patches, for the life of the monkeypatch context ``mp``:

- ``jax.jit`` to the identity and ``jax.lax.scan`` to a Python loop, so
  the closures the JAX runners build (their jitted steps, the scanned
  sweeps) run eagerly and every draw they take is a concrete array;
- ``jax.random.normal``, ``uniform`` and ``choice``, which append each
  concrete draw to ``tape.normal``, ``tape.uniform`` and ``tape.choice``;
- the JAX nets' ``Sequential.sample_eps`` and ``Sequential.init``, which
  append whole trees to ``tape.eps`` and ``tape.init`` (their own normal
  draws do not go to ``tape.normal``);
- ``models/logreg.run_laplace_from``, jitted at import, whose Laplace noise
  (``normal(key, (mc_samples, D))`` after the fit) is drawn again outside
  the jit from the same key and appended to ``tape.normal``;
- ``KmeansCluster._fit``, which appends the k-means++ centroids of each
  fit (``_kmeans_pp_init`` on the same key) to ``tape.kmeans``.

``feed(mp, tape)`` replaces the port's ``utils/draws`` functions and
``ops/kmeans._kmeans_pp_init`` by readers of the tape, each checking that
the shape it is asked for is the shape JAX drew.
"""

from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import torch

from psvi_torch.ops import kmeans as PK
from psvi_torch.utils import draws
from psvi_torch.utils.convert import params_from_jax
from psvi_tpu.models import layers as JL
from psvi_tpu.models import logreg as JLR
from psvi_tpu.ops import kmeans as JK


class Tape:
    def __init__(self):
        self.normal, self.uniform, self.choice = deque(), deque(), deque()
        self.eps, self.init, self.kmeans = deque(), deque(), deque()

    def sizes(self):
        return {k: len(getattr(self, k))
                for k in ("normal", "uniform", "choice", "eps", "init", "kmeans")}


def _concrete(x):
    return not any(isinstance(l, jax.core.Tracer) for l in jax.tree_util.tree_leaves(x))


def py_scan(f, init, xs=None, length=None, **_):
    """``lax.scan`` as a Python loop (eager, concrete values)."""
    n = length if xs is None else len(jax.tree_util.tree_leaves(xs)[0])
    carry, ys = init, []
    for i in range(n):
        carry, y = f(carry, None if xs is None else jax.tree_util.tree_map(lambda a: a[i], xs))
        ys.append(y)
    if not ys or all(l is None for l in jax.tree_util.tree_leaves(ys[0], is_leaf=lambda v: v is None)):
        return carry, None
    return carry, jax.tree_util.tree_map(lambda *a: jnp.stack(a), *ys)


def record(mp):
    tape = Tape()
    quiet = [0]
    real_normal = jax.random.normal

    def recorder(real, dest):
        def fn(*a, **k):
            out = real(*a, **k)
            if not quiet[0] and _concrete(out):
                dest.append(np.asarray(out))
            return out
        return fn

    def tree_recorder(real, dest):
        def fn(self, *a, **k):
            quiet[0] += 1
            try:
                out = real(self, *a, **k)
            finally:
                quiet[0] -= 1
            if _concrete(out):
                dest.append(jax.tree_util.tree_map(np.asarray, out))
            return out
        return fn

    real_from = JLR.run_laplace_from

    def run_laplace_from(key, theta0, x_core, *a, mc_samples=4, **k):
        out = real_from(key, theta0, x_core, *a, mc_samples=mc_samples, **k)
        if _concrete(key):
            tape.normal.append(np.asarray(real_normal(key, (mc_samples, x_core.shape[1]))))
        return out

    real_fit = JK.KmeansCluster._fit

    def kmeans_fit(self, key, X, k):
        if self.backend != "native":
            tape.kmeans.append(np.asarray(JK._kmeans_pp_init(key, jnp.asarray(X), k)))
        return real_fit(self, key, X, k)

    mp.setattr(jax, "jit", lambda f=None, **kw: f if f is not None else (lambda g: g))
    mp.setattr(jax.lax, "scan", py_scan)
    mp.setattr(jax.random, "normal", recorder(real_normal, tape.normal))
    mp.setattr(jax.random, "uniform", recorder(jax.random.uniform, tape.uniform))
    mp.setattr(jax.random, "choice", recorder(jax.random.choice, tape.choice))
    mp.setattr(JL.Sequential, "sample_eps", tree_recorder(JL.Sequential.sample_eps, tape.eps))
    mp.setattr(JL.Sequential, "init", tree_recorder(JL.Sequential.init, tape.init))
    mp.setattr(JLR, "run_laplace_from", run_laplace_from)
    mp.setattr(JK.KmeansCluster, "_fit", kmeans_fit)
    return tape


def feed(mp, tape):
    """The port's draws read from ``tape``; returns the tape."""

    def pop(queue, what):
        assert queue, f"the port asked for a {what} draw JAX did not take"
        return queue.popleft()

    def normal(gen, shape):
        a = pop(tape.normal, "normal")
        assert tuple(a.shape) == tuple(shape), (a.shape, shape)
        return torch.as_tensor(np.array(a), device=gen.device)

    def uniform(gen, shape, low=0.0, high=1.0):
        a = pop(tape.uniform, "uniform")
        assert tuple(a.shape) == tuple(shape), (a.shape, shape)
        return torch.as_tensor(np.array(a), device=gen.device)

    def choice(gen, n, size):
        a = pop(tape.choice, "choice")
        assert a.shape == (size,), (a.shape, size)
        return torch.as_tensor(np.array(a), dtype=torch.long, device=gen.device)

    mp.setattr(draws, "normal", normal)
    mp.setattr(draws, "uniform", uniform)
    mp.setattr(draws, "choice", choice)
    mp.setattr(draws, "sample_eps",
               lambda net, gen, S: params_from_jax(pop(tape.eps, "eps"), device=gen.device))
    mp.setattr(draws, "init_params",
               lambda net, gen: params_from_jax(pop(tape.init, "init"), device=gen.device))
    mp.setattr(PK, "_kmeans_pp_init",
               lambda gen, X, k: torch.as_tensor(np.array(pop(tape.kmeans, "k-means++")),
                                                 device=X.device))
    return tape


ACC_TOL, RTOL = 1.0 / 200 + 1e-6, 1e-5


def run_both(monkeypatch, jfn, pfn, **kw):
    """``jfn(**kw)`` with its draws recorded, then ``pfn(**kw,
    device="cpu")`` on them; every draw must be used. The results agree:
    ``csizes`` and ``best_tau`` exactly, the accuracies within one test
    point of 200, NLLs, RMSEs and LLs within rtol 1e-5, ELBOs within 1e-4.
    Returns both results."""
    with monkeypatch.context() as mp:
        tape = record(mp)
        rj = jfn(**kw)
    with monkeypatch.context() as mp:
        feed(mp, tape)
        rp = pfn(**kw, device="cpu")
    assert all(n == 0 for n in tape.sizes().values()), tape.sizes()
    for k in ("csizes", "best_tau"):
        if k in rj:
            assert rp[k] == rj[k], k
    for k in ("nlls", "rmses", "lls", "elbos"):
        if k in rj:
            tol = 1e-4 if k == "elbos" else RTOL
            np.testing.assert_allclose(np.asarray(rp[k], float), np.asarray(rj[k], float),
                                       rtol=tol, atol=1e-6, err_msg=k)
    if "accs" in rj:
        np.testing.assert_allclose(rp["accs"], rj["accs"], atol=ACC_TOL)
    return rj, rp
