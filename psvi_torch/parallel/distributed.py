"""Multi-process execution: the process group, the global mesh, each
rank's shard of a host array, and a launcher of local ranks.

Counterpart of ``psvi_tpu/parallel/distributed.py`` and of
``__graft_entry__.py::dryrun_multichip``. JAX's multi-controller model
runs one program on every host; its counterpart here is one process per
device, started by ``torchrun`` (or :func:`spawn`), each in a
``torch.distributed`` process group. The backend is the caller's choice,
named: ``"nccl"`` for CUDA devices, one process per card; ``"gloo"`` for
the CPU (and for several ranks sharing one card, which NCCL refuses:
gloo's SUM and MAX all-reduces take CUDA tensors). Nothing here picks a
backend, or falls back from one to the other, on its own.

A launch across hosts or cards::

    torchrun --nnodes 1 --nproc-per-node 4 -m psvi_torch.experiments \\
        --distributed --trial_parallel ...
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import socket
import time
import traceback
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from psvi_torch.device import resolve_device
from psvi_torch.parallel.mesh import Sharding, make_mesh


def initialize_distributed(backend: str, init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None) -> bool:
    """Join the process group with ``backend`` (``"nccl"`` or ``"gloo"``).
    The other arguments fall back to ``torchrun``'s environment
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``; under NCCL
    the card is ``LOCAL_RANK``'s). Returns True if the group was joined,
    False for a single-process run (nothing to do)."""
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if init_method is None and "MASTER_ADDR" in env:
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if init_method is None and world_size in (None, 1):
        return False  # single process
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return True


def global_mesh(trial: int = 1, data: int = 1, mc: int = 1):
    """A ('trial', 'data', 'mc') mesh over the whole world's ranks."""
    return make_mesh(trial=trial, data=data, mc=mc)


def make_global_array(arr, mesh, spec, device=None) -> torch.Tensor:
    """This rank's shard of ``arr``, an identical full host array on every
    rank (the data layer is deterministic per seed), on ``device`` (None:
    CUDA): ``spec`` names the mesh axis its leading dimension splits over
    (None: replicated; JAX's partition spec as a tuple, ``(axis, None,
    ...)``, is taken too)."""
    if isinstance(spec, (tuple, list)):
        if any(s is not None for s in spec[1:]):
            raise ValueError(f"only the leading dimension can be split, got {spec}")
        spec = spec[0] if spec else None
    shard = Sharding(mesh, spec).take(torch.as_tensor(np.asarray(arr)))
    return shard.to(resolve_device(device))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, nprocs, port, backend, args, results):
    try:
        if backend == "gloo":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // nprocs))
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=nprocs, rank=rank)
        try:
            results.put((rank, True, fn(rank, *args)))
        finally:
            dist.destroy_process_group()
    except Exception:  # the parent raises it, with the rank's traceback
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, nprocs: int, *args, backend: str = "gloo", timeout: float = 900.0) -> list:
    """Run ``fn(rank, *args)`` in ``nprocs`` fresh processes on this host, each
    a rank of one ``backend`` process group (``tcp://127.0.0.1``, a free
    port); their return values by rank. ``fn`` and ``args`` must pickle; a
    rank that raises, or no answer within ``timeout`` seconds, raises here."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, nprocs, port, backend, args, results))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + timeout
    try:
        while len(got) < nprocs:
            try:
                r, ok, out = results.get(timeout=1.0)
                got[r] = (ok, out)
                continue
            except queue.Empty:
                pass
            dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode is not None]
            if dead or time.monotonic() > deadline:
                raise RuntimeError(f"ranks {dead or sorted(set(range(nprocs)) - set(got))} "
                                   + ("died without an answer" if dead else
                                      f"gave no answer within {timeout} s"))
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    failed = {r: out for r, (ok, out) in got.items() if not ok}
    if failed:
        raise RuntimeError("ranks failed:\n" + "\n".join(f"rank {r}:\n{tb}"
                                                         for r, tb in sorted(failed.items())))
    return [got[r][1] for r in range(nprocs)]


def _dryrun_rank(rank: int, n: int, device: str) -> dict:
    """One rank of :func:`dryrun_multichip`."""
    from psvi_torch.data import read_dataset
    from psvi_torch.inference.psvi import PSVI
    from psvi_torch.parallel.trials import TrialParallelPSVI

    data = read_dataset("halfmoon")
    net = dict(num_pseudo=8, architecture="fn", n_hidden=16, inner_it=3, num_epochs=2,
               log_every=1, init_sd=1e-3, device=device)
    # 1) trials over the whole world, two a rank
    mesh_t = make_mesh(trial=n)
    res = TrialParallelPSVI(data, num_trials=2 * n, method="psvi_learn_v", mesh=mesh_t,
                            mc_samples=4, data_minibatch=32, **net).run()
    if len(res) != 2 * n or not all(np.isfinite(r["accs"]).all() for r in res):
        raise AssertionError("trial-sharded run: missing or non-finite results")
    # 2) one trial, the minibatch rows over 'data', the data term summed
    mesh_d = make_mesh(data=n)
    eng = PSVI(data, method="psvi_alpha_v", mc_samples=4, data_minibatch=max(32, n),
               mesh=mesh_d, shard_batch=True, **net)
    _, aux = eng._step(eng.state)
    # 3) the MC samples over 'mc', the softmax over S across ranks
    mesh_m = make_mesh(mc=n)
    eng_m = PSVI(data, method="psvi_learn_v", mc_samples=2 * n, data_minibatch=32,
                 mesh=mesh_m, shard_mc=True, **net)
    state_m, aux_m = eng_m._step(eng_m.state)
    acc, nll, *_ = eng_m._evaluate_fn(state_m)
    out = {"batch_loss": float(aux["outer_loss"]), "mc_loss": float(aux_m["outer_loss"]),
           "mc_acc": float(acc), "mc_nll": float(nll), "trial_accs": [r["accs"] for r in res]}
    if not all(np.isfinite(v) for k, v in out.items() if k != "trial_accs"):
        raise AssertionError(f"rank {rank}: non-finite sharded step: {out}")
    return out


def dryrun_multichip(n_devices: int, device: str = "cpu") -> list:
    """Start ``n_devices`` gloo ranks on this host and run in them the
    trial-sharded run, the batch-sharded step and the MC-sharded step and
    evaluation at a toy size (``__graft_entry__.py::dryrun_multichip``);
    every rank's readings, which must agree."""
    out = spawn(_dryrun_rank, n_devices, n_devices, device, backend="gloo")
    if any(o != out[0] for o in out[1:]):
        raise AssertionError(f"ranks disagree: {out}")
    print(f"dryrun_multichip OK: {n_devices} ranks, trial mesh ({n_devices}x1x1), "
          f"data mesh (1x{n_devices}x1), mc mesh (1x1x{n_devices})")
    return out
