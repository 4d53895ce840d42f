"""Full-state checkpointing.

Counterpart of ``psvi_tpu/utils/checkpoint.py``. The whole engine state
(variational parameters, pseudodata, weights, every Adam state and the
StepLR counter) goes into one ``.npz`` of its flattened leaves, with the
caller's extra arrays beside them (the engine stores its
``torch.Generator`` state there), so a run resumes bit for bit.

Restore rebuilds the leaves onto the structure, dtypes and device of a
freshly built engine's state with the same static config. The Adam step
counts and ``net_step`` are Python ints and come back as ints.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from psvi_torch.utils.tree import tree_leaves, tree_unflatten


def _norm_path(path: str) -> str:
    # np.savez appends '.npz' when absent; normalise so save and load agree
    return path if path.endswith(".npz") else path + ".npz"


def _to_numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_state(path: str, state: Any, extra: dict = None):
    """Write ``state``'s leaves and the ``extra`` arrays to ``path`` (.npz)."""
    arrays = {f"leaf_{i}": _to_numpy(l) for i, l in enumerate(tree_leaves(state))}
    for k, v in (extra or {}).items():
        arrays[f"extra_{k}"] = _to_numpy(v)
    path = _norm_path(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)


def load_state(path: str, template: Any):
    """Restore into the structure of ``template``; returns (state, extra).
    Raises ``ValueError`` when a leaf's shape or the number of leaves
    differs from the template's (another static config)."""
    leaves = tree_leaves(template)
    with np.load(_norm_path(path)) as d:
        n_saved = sum(k.startswith("leaf_") for k in d.files)
        if n_saved != len(leaves):
            raise ValueError(f"checkpoint holds {n_saved} leaves, template {len(leaves)}; "
                             "config mismatch")
        new_leaves = []
        for i, leaf in enumerate(leaves):
            arr = d[f"leaf_{i}"]
            shape = tuple(leaf.shape) if torch.is_tensor(leaf) else ()
            if arr.shape != shape:
                raise ValueError(f"checkpoint leaf {i} shape {arr.shape} != template {shape}; "
                                 "config mismatch")
            if torch.is_tensor(leaf):
                new_leaves.append(torch.tensor(arr, dtype=leaf.dtype, device=leaf.device))
            else:  # a step counter
                new_leaves.append(type(leaf)(arr.item()))
        extra = {k[len("extra_"):]: d[k] for k in d.files if k.startswith("extra_")}
    return tree_unflatten(template, new_leaves), extra
