"""The LeNet inner unroll's other coreset weightings, and the port's two
backends in float64 (the shared helpers and the Adam ε of the JAX
comparison are those of ``test_torch_fused_lenet.py``):

- α-weighted psvi_alpha_v, f(v) = e^α·softmax(v): the plain versions in
  ``LeNetUnroll`` and the autograd oracle against JAX
  ``make_fused_unroll(cfg, backend="xla")`` in fp32;
- non-parameterised psvi, f(v) = v, and psvi_alpha_v at the engine's Adam
  ε = 1e-8: the plain versions against the autograd oracle in float64,
  where the sensitivity of Adam's first step to the gradient's last bits
  (see ``UNROLL_ADAM_EPS``) is far below the tolerance: paramsT, the losses
  and every cotangent (p̄0, ū, v̄, ᾱ).
"""

import numpy as np
import pytest
import torch

from psvi_torch.ops import fused_lenet as FL
from test_torch_fused_lenet import (UNROLL_ADAM_EPS, _cfgs, _check_unroll_against_jax, _cos,
                                    _inputs)


def test_alpha_unroll_matches_jax():
    _check_unroll_against_jax(True, True, ("torch", "autograd"))


def _f64(x):
    x = np.asarray(x)
    return torch.tensor(x, dtype=torch.float64 if x.dtype.kind == "f" else None)


def _grads64(cfg, a, backend):
    """pT, the inner losses and the gradients of ⟨p̄, pT⟩ + ⟨dl, losses⟩
    w.r.t. (p0, u, v, α) through ``lenet_unroll``, all in float64."""
    p0 = FL.pack_params([{k: _f64(v) for k, v in d.items()} for d in a["layers"]])
    e_in = FL.pack_eps([{k: _f64(v) for k, v in e.items()} for e in a["eps"]], lead=(cfg.T,))
    leaves = [x.clone().requires_grad_(True) for x in (p0, _f64(a["u"]), _f64(a["v"]),
                                                        _f64(a["alpha"]))]
    pT, losses = FL.lenet_unroll(*leaves, _f64(a["z"]), e_in, a["lr"], cfg, backend=backend)
    obj = (pT * _f64(a["pbar"])).sum() + (losses * _f64(a["dl"])).sum()
    grads = torch.autograd.grad(obj, leaves, allow_unused=True)
    grads = [np.zeros(x.shape) if g is None else g.numpy() for g, x in zip(grads, leaves)]
    return [pT.detach().numpy(), losses.detach().numpy()] + grads


@pytest.mark.parametrize("parameterised,use_alpha,seed", [(False, False, 4), (True, True, 3)])
def test_plain_unroll_matches_autograd_in_float64(parameterised, use_alpha, seed):
    cfg, _ = _cfgs(parameterised, use_alpha)
    assert cfg.adam_eps == 1e-8 != UNROLL_ADAM_EPS
    a = _inputs(cfg, seed=seed)
    k, r = _grads64(cfg, a, "torch"), _grads64(cfg, a, "autograd")
    names = ["paramsT", "losses", "p0bar", "ubar", "vbar", "abar"]
    for name, x, ref in zip(names, k, r):
        if name == "abar" and not use_alpha:
            assert not np.any(x) and not np.any(ref)
            continue
        assert _cos(x, ref) > 1 - 1e-12, name
        assert np.abs(x - ref).max() <= 1e-8 * np.abs(ref).max(), name
