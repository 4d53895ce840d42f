"""The host's split of a step and an evaluation on the card, by the
program's layer spans, and what the span recorder and the profiler cost:

    python3 -m portbench.host_split --workload <name> --seed <n> --seconds <s> --pairs <k>

from the root of a checkout on a machine with a CUDA card. After the
cell's set-up (as ``portbench.run`` makes it):

1. ``pairs`` windows of ``seconds`` each with the span recorder off and
   then on, in turn: the evaluation rate, the mean host time of
   ``PSVI._step`` (the benchmark's probe) and, with the recorder on, the
   split of ``portbench/spans.py``;
2. one window with the recorder on in which the host waits for the card
   to drain before each outer IW-ELBO forward (the engine's
   ``_outer_loss`` wrapped): the wait, and the split, show how much of
   the outer's host time is spent waiting on work queued before it;
3. the cell's traced window with the recorder on: the split under the
   profiler; the reduction of ``portbench/trace.py`` once with the
   benchmark's spans alone, as its metrics read it, and once with the
   program's spans as idle-gap labels; and the CUDA runtime calls the host
   made inside each program span (the innermost), per step;
4. the host's cost of one span, off and on, in a loop.

The last line of standard output is a digest; the whole record goes to
``.portbench_out/<workload>.<seed>.host_split.json``. No output check is
made: ``portbench.run`` makes it.
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import time
from collections import defaultdict

_T_START = time.perf_counter()

from portbench import run as RUN  # noqa: E402  (the run's cache paths, before torch)

import torch  # noqa: E402


def _window_row(cell, win, records=None) -> dict:
    from portbench import spans as SP

    T = cell.config["engine"]["inner_it"]
    row = {"seconds": win.seconds, "steps": win.steps, "blocks": win.blocks,
           "evals_per_s": win.steps * (T + 1) / win.seconds if win.seconds else None,
           "host_step_ms": statistics.fmean(win.host_step_ms) if win.host_step_ms else None,
           "step_ms_median": statistics.median(win.step_ms) if win.step_ms else None}
    if records is not None:
        row["split"] = SP.split(records)
        row["spans"] = SP.summary(records)
    return row


def runtime_by_span(events, names, steps: int) -> dict:
    """Per program span: the CUDA runtime calls (``cuda*``, ``cu*``) the host
    began inside it, the innermost span taking each, as (count, host ms)
    per step."""
    spans, calls = [], []
    for e in events:
        if str(e.device_type()).endswith("CUDA"):
            continue
        name, s = e.name(), e.start_ns()
        if name in names:
            spans.append((e.duration_ns(), s, s + e.duration_ns(), name))
        elif name.startswith("cu"):
            calls.append((s, e.duration_ns(), name))
    calls.sort()
    starts = [c[0] for c in calls]
    owner = {}
    for _, s, t, name in sorted(spans, reverse=True):  # longest first, so inner spans win
        for i in range(bisect.bisect_left(starts, s), bisect.bisect_right(starts, t)):
            owner[i] = name
    acc = defaultdict(lambda: defaultdict(lambda: [0.0, 0.0]))
    for i, span_name in owner.items():
        row = acc[span_name][calls[i][2]]
        row[0] += 1.0 / steps
        row[1] += calls[i][1] * 1e-6 / steps
    return {k: dict(sorted(v.items(), key=lambda kv: -kv[1][1])) for k, v in acc.items()}


def span_cost_us(n: int = 100_000) -> dict:
    """The host's µs for one enter and exit of a span with no profiler
    recording, with the recorder off and on."""
    from psvi_torch.utils import resource as R

    out = {}
    for on in (False, True):
        R.take_spans()
        R.enable_spans() if on else R.disable_spans()
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with R.span("psvi.outer.fwd"):
                pass
        out["on" if on else "off"] = (time.perf_counter_ns() - t0) / n * 1e-3
    R.disable_spans()
    R.take_spans()
    return out


def _drained(fn, waits: list):
    def wrapped(*a, **k):
        t0 = time.perf_counter_ns()
        torch.cuda.synchronize()
        waits.append((time.perf_counter_ns() - t0) * 1e-6)
        return fn(*a, **k)
    return wrapped


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.host_split: needs a CUDA card", file=sys.stderr)
        return 3

    from portbench import harness as H
    from portbench import spans as SP
    from portbench import trace as TR
    from psvi_torch.utils import resource as R

    torch.set_num_threads(4)
    cell = H.load_cell(args.workload)
    dev = torch.device("cuda:0")
    inputs = H.make_inputs(cell, args.seed, dev)
    eng, probe = H.set_up(cell, inputs, args.seed, dev)
    setup_s = time.perf_counter() - _T_START
    start, run_blocks = eng.state, cell.mix["run_steps"] // cell.mix["log_every"]

    def window(on: bool) -> dict:
        eng.state = start
        R.take_spans()
        if on:
            R.enable_spans()
        win = H.run_window(eng, probe, args.seconds, run_blocks, start)
        R.disable_spans()
        return {"recorder": on, **_window_row(cell, win, R.take_spans() if on else None)}

    windows = [window(on) for _ in range(args.pairs) for on in (False, True)]
    waits: list = []
    eng._outer_loss = _drained(eng._outer_loss, waits)
    drained = window(True)
    del eng._outer_loss  # the class's method again
    drained["wait_ms"] = statistics.fmean(waits)

    R.enable_spans()
    tw, events = H.run_traced(eng, probe, cell.mix["trace_seconds"], run_blocks, start)
    R.disable_spans()
    traced = _window_row(cell, tw, R.take_spans())
    accepted = TR.reduce(events, H.SPANS, tw.seconds)
    labelled = TR.reduce(events, H.SPANS + SP.NAMES, tw.seconds)
    leaked = sorted(k for k in accepted["kernel_s"] if k.startswith("psvi."))
    leaked += sorted(k for k, _ in accepted["device_ops"] if k.startswith("psvi."))
    off = [w["evals_per_s"] for w in windows if not w["recorder"]]
    on = [w["evals_per_s"] for w in windows if w["recorder"]]
    untraced_block_s = statistics.fmean(w["seconds"] / w["blocks"] for w in windows)
    out = {
        "workload": cell.name, "seed": args.seed, "power": RUN.power_limit(),
        "setup_s": setup_s, "windows": windows, "drained": drained, "traced": traced,
        "evals_per_s_off": off, "evals_per_s_on": on,
        "recorder_cost_pct": 100.0 * (1.0 - statistics.median(on) / statistics.median(off)),
        "span_cost_us": span_cost_us(),
        "trace": {"busy_s": accepted["busy_s"], "window_s": accepted["window_s"],
                  "n_device_events": accepted["n_device_events"],
                  "device_idle_pct": 100.0 * (1.0 - accepted["busy_s"] / accepted["window_s"]),
                  "psvi_names_in_kernels": leaked,
                  "busy_s_with_program_spans": labelled["busy_s"],
                  "idle_by_span": labelled["idle_by_span"],
                  "idle_gaps": labelled["idle_gaps"][:10],
                  "runtime_by_span": runtime_by_span(events, SP.NAMES, tw.steps)},
        # the device's busy time of a block, as traced, over an untraced
        # block's wall time: the idle share without the profiler, on the
        # assumption that the profiler leaves kernel durations as they are
        "device_idle_untraced_estimate_pct":
            100.0 * (1.0 - (accepted["busy_s"] / tw.blocks) / untraced_block_s),
    }
    RUN.OUT.mkdir(exist_ok=True)
    with open(RUN.OUT / f"{cell.name}.{args.seed}.host_split.json", "w") as f:
        json.dump(out, f)
    digest = {k: out[k] for k in ("workload", "seed", "power", "evals_per_s_off",
                                  "evals_per_s_on", "recorder_cost_pct", "span_cost_us",
                                  "device_idle_untraced_estimate_pct")}
    digest["split_on"] = [w["split"] for w in windows if w["recorder"]]
    digest["host_step_ms_on"] = [w["host_step_ms"] for w in windows if w["recorder"]]
    digest["drained"] = {"wait_ms": drained["wait_ms"], **drained["split"]}
    digest["split_traced"] = traced["split"]
    digest["trace"] = {k: v for k, v in out["trace"].items()
                       if k not in ("idle_gaps", "runtime_by_span")}
    print(json.dumps(digest), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
