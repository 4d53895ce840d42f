#!/usr/bin/env python3
"""Where the time of the dense nested kernels goes, phase by phase, on one
CUDA card.

Run from the root of a checkout: ``python3 scripts/torch_nested_phase_split.py``.
It builds ``psvi_torch/ops/csrc/fused_nested.cu`` with ``-DNESTED_PHASE_CLOCK``
(a macro the normal build leaves undefined): thread 0 of block 0 then writes
(phase id, ``%globaltimer``) at each phase boundary of each iteration, after
a barrier of its block, into a device buffer that the entry
``psvi_nested_phase_clock`` copies out. It runs ``nested_fwd``,
``nested_outer`` and ``nested_rev`` (``--kernels`` picks some) at the dense
main path (four_blobs fn 2-40-4, M=48, B=128, S=10, T=10) and at the
regression main path (sinus 1-40-1, M=10, B=64, τ=0.1), 20 launches each,
and prints one JSON line per (config, kernel): µs per phase per iteration of
``nested_fwd`` and ``nested_rev`` (the mean over launches and iterations)
and the µs outside the iterations, or µs per phase per launch of
``nested_outer`` (one pass, no iterations); the stamped total; and the
CUDA-event median of the instrumented and of the normal build (the stamps'
own barriers cost a little).

``--root DIR`` takes ``psvi_torch`` (its wrappers and its kernel source)
from another checkout, for example a ``git archive`` of a parent commit
whose source carries the same stamps. ``--blocks C`` overrides the cluster
size of ``_nested_plan`` and ``--global-maps`` keeps the maps in global
memory (where the checkout has a plan). The last line is the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]

# Phase ids as the stamps write them. Both designs: 2-5, 9-12 (the layer
# passes), 16. The first design (one block): 17 the inner gradient's sums
# with Adam or its VJP, 8 the loss (nested_outer: the NLLs, per-sample sums
# and IW coefficients), 19 ū, 14 c̄w and z̄ (nested_outer: with the head's δ),
# 15 p̄'s sums. The cluster design: 20 and 21 the per-sample sums, 6, 7 and 13
# the cluster barriers after them, 18 the owners' sums with Adam or its VJP,
# 15 the owners' sums of p̄, ū, c̄w and z̄ (nested_outer: of p̄ and ū, 14 of
# c̄w and z̄); nested_outer's 22 the NLLs and per-sample sums, 23 the IW
# coefficients, 4 the head's δ.
PHASES = {0: "start", 1: "init", 2: "sample", 3: "forward", 4: "head", 5: "backward",
          6: "sync_a", 7: "sync_b", 8: "loss", 9: "tan_sample", 10: "tan_forward",
          11: "tan_head", 12: "tan_backward", 13: "sync_c", 14: "cwbar_zbar", 15: "pbar",
          16: "final", 17: "grad_adam", 18: "owner", 19: "ubar", 20: "sample_sums",
          21: "tan_sums", 22: "nll_sums", 23: "iw_coefficients"}
KERNELS = ("nested_fwd", "nested_outer", "nested_rev")
LAUNCHES = 20


def build_clocked(_build, root):
    """nvcc the checkout's source with the phase clock; returns the library."""
    src = root / "psvi_torch" / "ops" / "csrc" / "fused_nested.cu"
    out = _build._BUILD / "phase_clock"
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"libfused_nested_clock-{hashlib.sha256(src.read_bytes()).hexdigest()[:16]}.so"
    if so.exists():
        return ctypes.CDLL(str(so))
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-DNESTED_PHASE_CLOCK", "-I", str(src.parent),
           "-o", str(so), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    return ctypes.CDLL(str(so))


def read_clock(lib):
    buf = (ctypes.c_ulonglong * (2 * 4096))()
    n = ctypes.c_int()
    rc = lib.psvi_nested_phase_clock(buf, ctypes.byref(n))
    if rc:
        raise RuntimeError(f"psvi_nested_phase_clock failed with CUDA error {rc}")
    a = np.frombuffer(buf, dtype=np.uint64)[:2 * n.value].reshape(-1, 2)
    return a[:, 0].astype(int), a[:, 1].astype(np.float64) / 1e3  # ids, µs


def split(lib, fn, T):
    """µs per phase per iteration over LAUNCHES launches of ``fn``; the
    phases before and after the iterations (init, final) per launch. With
    ``T`` None (nested_outer) every phase per launch."""
    sums, total = {}, 0.0
    for _ in range(LAUNCHES):
        fn()
        torch.cuda.synchronize()
        ids, us = read_clock(lib)
        total += us[-1] - us[0]
        for pid, dt in zip(ids[1:], np.diff(us)):
            sums[PHASES[int(pid)]] = sums.get(PHASES[int(pid)], 0.0) + dt
    if T is None:
        return {"us_per_launch": {k: v / LAUNCHES for k, v in sums.items()},
                "stamped_total_us": total / LAUNCHES}
    outside = ("init", "final")
    return {"us_per_iteration": {k: v / (LAUNCHES * T) for k, v in sums.items()
                                 if k not in outside},
            "us_outside_iterations": {k: sums[k] / LAUNCHES for k in outside if k in sums},
            "stamped_total_us": total / LAUNCHES}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--blocks", type=int, default=None)
    ap.add_argument("--global-maps", action="store_true")
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    sys.path.insert(1, str(HERE))
    import chip_smoke as CS  # the input makers of this checkout
    from psvi_torch.data import read_dataset, read_regression_dataset
    from psvi_torch.ops import _build
    from psvi_torch.ops import fused_nested as FN

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    plan_of = getattr(FN, "_nested_plan", None)
    if plan_of is not None and (args.blocks or args.global_maps):
        base = plan_of

        def plan_of(cfg, kernel):
            return base(cfg, kernel, blocks=args.blocks,
                        shared=False if args.global_maps else None)

        FN._nested_plan = plan_of
    normal = _build.load_library("fused_nested")
    clocked = build_clocked(_build, root)
    blobs, sinus = read_dataset("four_blobs"), read_regression_dataset("sinus")
    cfgs = [("four_blobs fn 2-40-4 M=48", CS.main_cfg(FN, blobs, [2, 40, 4], 48, True, False),
             blobs),
            ("sinus 1-40-1 M=10 tau=0.1",
             CS.main_cfg(FN, sinus, [1, 40, 1], 10, True, False, B=64, tau=0.1), sinus)]
    for name, cfg, data in cfgs:
        calls = CS.dense_calls(FN, cfg, CS.kernel_inputs(FN, cfg, data.x, data.y, 1, dev))
        for kernel in args.kernels.split(","):
            try:
                plan = dataclasses.asdict(plan_of(cfg, kernel)) if plan_of is not None else None
            except ValueError:  # a checkout whose plan does not cover this kernel
                plan = None
            kern = calls[kernel][0]
            _build._LOADED["fused_nested"] = clocked
            FN._lib()  # types the entry points of the library just loaded
            with torch.no_grad():
                kern()
                torch.cuda.synchronize()
                rep = split(clocked, kern, None if kernel == "nested_outer" else cfg.T)
                rep["instrumented_ms"] = CS.median_ms(kern, reps=30, warmup=3)
                _build._LOADED["fused_nested"] = normal
                rep["normal_ms"] = CS.median_ms(kern, reps=30, warmup=3)
            print(json.dumps({"config": name, "kernel": kernel, "root": str(root),
                              "tag": args.tag, "plan": plan, **rep}), flush=True)
    print(CS.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
