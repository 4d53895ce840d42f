"""The ranks of ``tests/test_torch_parallel_dist.py``: every multi-rank
check of the port, run in two gloo ranks on the CPU by one
``psvi_torch.parallel.distributed.spawn``.

This module imports no JAX: the ranks start from a fresh import of it, and
the test hands them the JAX engine's states, batches and noise already
carried across to the port's tensors. Each check returns plain numbers and
NumPy arrays; the test compares them with JAX's unsharded step.
"""

import numpy as np
import torch

from psvi_torch.data import read_dataset
from psvi_torch.inference.baselines import run_mfvi
from psvi_torch.inference.psvi import PSVI
from psvi_torch.parallel.distributed import _dryrun_rank
from psvi_torch.parallel.mesh import make_mesh
from psvi_torch.parallel.trials import TrialParallelPSVI


def _np(x):
    return x.detach().cpu().numpy()


def sharded_step(case):
    """One nested step of a sharded engine on the whole batch and noise that
    JAX's unsharded step drew, then the evaluation of JAX's next state on
    JAX's evaluation noise."""
    axis = case["axis"]
    mesh = make_mesh(**{axis: 2})
    eng = PSVI(read_dataset(case["dataset"]), mesh=mesh, shard_batch=axis == "data",
               shard_mc=axis == "mc", device="cpu", **case["kw"])
    assert eng._step.__name__ == "_nested_step"
    seen = {}
    apply = eng._apply_hyper_updates

    def capture(state, grads):  # the hypergradients after their mean over the axis
        seen.update({k: _np(g) for k, g in grads.items()})
        return apply(state, grads)

    eng._apply_hyper_updates = capture
    s1, aux = eng._nested_step(case["state0"], batch=case["batch"], eps=case["eps"])
    grads = dict(seen)
    # the same step unsharded, for the hypergradients JAX's fp32 spread
    # would hide (α: one number, N-scaled terms with cancellation)
    plain = PSVI(read_dataset(case["dataset"]), device="cpu", **case["kw"])
    plain._apply_hyper_updates = capture
    plain._nested_step(case["state0"], batch=case["batch"], eps=case["eps"])
    draws = iter(case["eval_eps"])
    eng._sample_eps = lambda S: next(draws)
    acc, nll, iw_ent, ness, vent = eng._evaluate_fn(case["state1"])
    assert next(draws, None) is None
    return {"loss": float(aux["outer_loss"]), "inner_losses": _np(aux["inner_losses"]),
            "u": _np(s1.u), "v": _np(s1.v), "alpha": _np(s1.alpha), "grads": grads,
            "grads_unsharded": dict(seen),
            "params": [{k: _np(x) for k, x in p.items()} for p in s1.params],
            "batch_rows": int(eng.data_minibatch),
            "eval": [float(x) for x in (acc, nll, iw_ent, ness, vent)]}


def mfvi(case):
    """``run_mfvi`` with and without ``shard_batch`` from one seed."""
    kw = dict(case["kw"], train=read_dataset(case["dataset"]), device="cpu")
    kw["N"], kw["D"] = kw["train"].N, kw["train"].D
    plain = run_mfvi(**kw)
    sharded = run_mfvi(**kw, mesh=make_mesh(data=2), shard_batch=True)
    return {k: (plain[k], sharded[k]) for k in ("accs", "nlls", "elbos")}


def trials(case):
    """Trials over a trial axis of 2, padded up from an odd count."""
    tp = TrialParallelPSVI(read_dataset(case["dataset"]), case["num_trials"],
                           mesh=make_mesh(trial=2), device="cpu", **case["kw"])
    return {"local": tp.trials, "padded": tp._padded_trials, "results": tp.run()}


def helpers(case):
    """What each rank takes of an identical host array, as JAX's sharding
    helpers place it."""
    from psvi_torch.parallel.distributed import global_mesh, make_global_array
    from psvi_torch.parallel.mesh import (batch_sharding, replicated, shard_pytree_leading,
                                          trial_sharding)

    x = np.arange(12.0).reshape(6, 2)
    data, trial = global_mesh(data=2), global_mesh(trial=2)
    return {"rows": make_global_array(x, data, ("data", None), device="cpu").numpy(),
            "replicated": make_global_array(x, data, None, device="cpu").numpy(),
            "batch": batch_sharding(data, 1).take(torch.arange(6)).numpy(),
            "same": replicated(data).take(torch.arange(6)).numpy(),
            "trials": trial_sharding(trial, 1).take(torch.arange(4)).numpy(),
            "tree": shard_pytree_leading({"a": torch.arange(4), "b": (torch.zeros(2, 3),)},
                                         trial)}


CHECKS = {"sharded_step": sharded_step, "mfvi": mfvi, "trials": trials, "helpers": helpers,
          "dryrun": lambda case: _dryrun_rank(case["rank"], 2, "cpu")}


def run_checks(rank, cases):
    """Every check of ``cases`` ({name: case}), in the same order on every
    rank; {name: result}."""
    torch.manual_seed(0)
    return {name: CHECKS[case["check"]](dict(case, rank=rank)) for name, case in cases.items()}
