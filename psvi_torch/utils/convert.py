"""Carry the JAX engine's parameters and state across to the port.

The tests hand both sides the same numbers: they take the JAX engine's
parameters or ``PSVIState`` as NumPy arrays (``np.asarray`` of each leaf)
and turn them into the port's tensors here, so that both compute the same
function. Nothing here imports JAX: a JAX array converts by
``np.asarray``. Besides the engine's state: the logreg θ
(``tensor_from_jax``) and the parameters and Adam state of the selection
pretrainer, the MFVI baselines and the frequentist model
(``model_state_from_jax``).

A packed JAX net's state (``packed=True``: flat ``{'mu', 'rho'}``
parameters and their Adam moments) carries across by the same functions:
the flat dict is a tree like any other. So does the trial runner's stacked
state (JAX ``TrialParallelPSVI.states``: every leaf with a leading trial
axis): its tensors keep the axis, as the port's ``parallel/trials.py``
stacks them, and its step counts, one per trial and equal, become the one
int the port's stacked state holds.

``device=None`` means the CUDA card, as everywhere in the port; the tests
pass ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from psvi_torch.device import resolve_device
from psvi_torch.ops.optim import AdamState


def _to_tensor(x, device):
    a = np.asarray(x)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    return torch.as_tensor(np.array(a), device=device)


def params_from_jax(tree, device=None):
    """A nested tuple/list/dict of NumPy arrays → the same tree of float32
    tensors (lists become tuples, as ``Sequential.init`` returns them) on
    ``device`` (None: CUDA, or raise)."""
    device = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return tuple(conv(v) for v in t)
        return _to_tensor(t, device)

    return conv(tree)


def _shared_int(x) -> int:
    """A step count: a scalar, or a stacked one (one per trial) whose
    entries must agree."""
    a = np.asarray(x).reshape(-1)
    if (a != a[0]).any():
        raise ValueError(f"stacked trials disagree on a step count: {a}")
    return int(a[0])


def adam_from_jax(opt, device=None):
    """A JAX ``AdamState`` (count, mu, nu) → the port's ``AdamState``."""
    device = resolve_device(device)
    return AdamState(_shared_int(opt.count),
                     params_from_jax(opt.mu, device), params_from_jax(opt.nu, device))


def tensor_from_jax(x, device=None):
    """One array (the logreg θ of ``models/logreg.py``, a Laplace sample,
    pseudodata) → a tensor on ``device``; floats become float32."""
    return _to_tensor(x, resolve_device(device))


def model_state_from_jax(jmodel, pmodel):
    """Copy a JAX model's ``params`` and Adam ``opt_state`` into the port's
    counterpart, on the port model's device: ``MeanFieldVI``
    (``inference/selection.py``), the baselines' ``_MFVI`` and
    ``RunFrequentistModel``'s (W, b) layer."""
    pmodel.params = params_from_jax(jmodel.params, pmodel.device)
    pmodel.opt_state = adam_from_jax(jmodel.opt_state, pmodel.device)
    return pmodel


def state_from_jax(jstate, device=None):
    """The JAX ``PSVIState`` (leaves as NumPy arrays or anything
    ``np.asarray`` accepts), or a stacked one of the trial runner → the
    port's :class:`PSVIState` on ``device`` (None: CUDA, or raise)."""
    from psvi_torch.inference.psvi import PSVIState

    device = resolve_device(device)

    return PSVIState(
        params=params_from_jax(jstate.params, device),
        u=_to_tensor(jstate.u, device),
        z=_to_tensor(jstate.z, device),
        v=_to_tensor(jstate.v, device),
        alpha=_to_tensor(jstate.alpha, device),
        opt_u=adam_from_jax(jstate.opt_u, device),
        opt_v=adam_from_jax(jstate.opt_v, device),
        opt_z=adam_from_jax(jstate.opt_z, device),
        opt_alpha=adam_from_jax(jstate.opt_alpha, device),
        opt_net=adam_from_jax(jstate.opt_net, device),
        opt_joint=adam_from_jax(jstate.opt_joint, device),
        net_step=_shared_int(jstate.net_step),
    )
