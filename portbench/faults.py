"""Faults planted under the harness, to show that the check catches them.

``planted(kind)`` replaces the engine's fused steps (``PSVI.
_nested_step_fused_lenet`` and ``PSVI._nested_step_fused``) by broken ones
while an engine is built and run:

- ``unchanged``: the step returns the state it was given;
- ``half_batch``: the step sees the first half of its minibatch, so the
  data term is the mean over the rest;
- ``altered``: the inner losses the step reports are 1% off, an answer
  altered where it is produced;
- ``half_grad_u``: the step's hypergradient of u reaches the hyper-Adam at
  half its size.

One card runs each cell, so no exchange between cards can be left out.
"""

from __future__ import annotations

import contextlib
import functools

KINDS = ("unchanged", "half_batch", "altered", "half_grad_u")
STEPS = ("_nested_step_fused_lenet", "_nested_step_fused")


def _broken(orig, kind: str):
    @functools.wraps(orig)
    def step(self, state, batch=None, eps=None):
        if kind == "half_batch":
            xb, yb = batch if batch is not None else self._sample_batch()
            half = xb.shape[0] // 2
            batch = (xb[:half], yb[:half])
        new_state, aux = orig(self, state, batch=batch, eps=eps)
        if kind == "unchanged":
            return state, aux
        if kind == "altered":
            aux = {**aux, "inner_losses": aux["inner_losses"] * 1.01}
        return new_state, aux

    return step


def _half_grad_u(orig):
    @functools.wraps(orig)
    def apply(self, state, grads):
        if "u" in grads:
            grads = {**grads, "u": grads["u"] * 0.5}
        return orig(self, state, grads)

    return apply


@contextlib.contextmanager
def planted(kind: str):
    if kind not in KINDS:
        raise ValueError(f"unknown fault {kind!r}")
    from psvi_torch.inference.psvi import PSVI

    names = ("_apply_hyper_updates",) if kind == "half_grad_u" else STEPS
    saved = {name: getattr(PSVI, name) for name in names}
    try:
        for name, orig in saved.items():
            setattr(PSVI, name, _half_grad_u(orig) if kind == "half_grad_u"
                    else _broken(orig, kind))
        yield
    finally:
        for name, orig in saved.items():
            setattr(PSVI, name, orig)
