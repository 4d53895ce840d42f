"""Run one cell of the benchmark on the card and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result's JSON object; the numbers the check compared, each beside its
limit, are the last lines of standard error and the result's last key.
The line before it (``"run"``) carries the launches per step, the peak
memory and the card's power limit, and the whole record goes to
``.portbench_out/<workload>.<seed>.t<trace>.json`` in the checkout. A run
with no card, or fewer cards than the cell asks for, fails and prints no
result; so does one in which JAX or the JAX package was imported.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"
OUT = ROOT / ".portbench_out"

# every build and kernel cache of a run lives at a fixed path in the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")

import torch  # noqa: E402


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {cell.chips} CUDA card(s), {n} found",
              file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           _T_START, device="cuda:0")
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: imported in the run: {', '.join(bad)}", file=sys.stderr)
        return 4
    result, info = out["result"], out["info"]
    info["power"] = power_limit()
    OUT.mkdir(exist_ok=True)
    with open(OUT / f"{args.workload}.{args.seed}.t{args.trace}.json", "w") as f:
        json.dump({"result": result, "info": info}, f)
    print(json.dumps({"run": {k: info[k] for k in ("workload", "seed", "step", "steps",
                                                    "launches_per_step", "memory_peak_bytes",
                                                    "power")}}), flush=True)
    for name, row in result["check"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
