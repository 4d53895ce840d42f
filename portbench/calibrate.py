"""The readings that the check's limits are set from, for one cell.

    python3 -m portbench.calibrate --workload <name> --seeds 1 2 ... \
        [--control-seeds ...] [--fault-seeds ...] [--out FILE]

For each of ``--seeds``: the cell's set-up as a run makes it (the checked
steps through the window's own call, at the cell's sizes), then the check's
numbers against the plain float64 reference: the lower readings. For each
of ``--control-seeds``: the control (``harness.control_states``: the plain
reference in float32 with TF32 on, in the program's place) judged the same
way. For each of ``--fault-seeds``: the program with each fault of
``portbench/faults.py`` planted. One JSON line a reading, with each step's
readings, to standard output and to ``--out``. On the card only, like a
run.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from portbench import check, faults
from portbench import harness as H


def _program(cell, inputs, seed, dev, kind=None):
    if kind is None:
        eng, probe = H.set_up(cell, inputs, seed, dev)
    else:
        with faults.planted(kind):
            eng, probe = H.set_up(cell, inputs, seed, dev)
    steps = H.program_states(eng, probe, inputs)
    del eng, probe
    gc.collect()
    torch.cuda.empty_cache()
    return steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda:0")
    cell = H.load_cell(args.workload)
    sink = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    def judged(kind, seed, steps, inputs, **extra):
        t0 = time.perf_counter()
        ref = H.reference_readings(cell, inputs, steps)
        emit({"workload": cell.name, "kind": kind, "seed": seed,
              "numbers": check.numbers(steps, ref), "per_step": check.per_step(steps, ref),
              "reference_s": time.perf_counter() - t0, **extra})

    for seed in sorted(set(args.seeds) | set(args.control_seeds) | set(args.fault_seeds)):
        inputs = H.make_inputs(cell, seed, dev)
        if seed in args.seeds:
            t0 = time.perf_counter()
            steps = _program(cell, inputs, seed, dev)
            judged("program", seed, steps, inputs, program_s=time.perf_counter() - t0)
        if seed in args.control_seeds:
            judged("control_tf32", seed, H.control_states(cell, inputs), inputs)
        if seed in args.fault_seeds:
            for kind in faults.KINDS:
                judged(f"fault_{kind}", seed, _program(cell, inputs, seed, dev, kind), inputs)
        del inputs
        gc.collect()
        torch.cuda.empty_cache()
    emit({"workload": cell.name, "kind": "peak", "memory_peak_bytes":
          int(torch.cuda.max_memory_allocated(dev))})
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
