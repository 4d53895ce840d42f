"""Quality gates of ``chip_smoke.py``'s methods and lifecycle phases, from
the JAX package.

Runs the JAX engine's ``run_psvi`` on the CPU at each run of
``chip_smoke.METHODS_RUNS`` (four_blobs fn 2-40-4, M=48, S=10, T=10,
B=128, init_sd 1e-3; the remaining methods and the hyper trainer) and of
``chip_smoke.LIFECYCLE_RUNS`` (the same cell with a prune, with the
incremental coreset, and under the joint trainer with a prune) over seeds
0, 1 and 2, and prints one JSON line per run: the final accuracy of each
seed and the gate, the lowest minus 0.05, that the card's run of the port
must meet. The joint run takes JAX's ``backend="xla"``: the Pallas op
computes the same function, and the port's run on the card goes through
its CUDA kernel B3.

Usage: JAX_PLATFORMS=cpu python scripts/torch_methods_jax_gates.py
       [--seeds 0 1 2] [--phases methods lifecycle]
"""

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from psvi_tpu.data import read_dataset  # noqa: E402
from psvi_tpu.inference.psvi import PSVI  # noqa: E402


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--phases", nargs="+", choices=["methods", "lifecycle"],
                    default=["methods", "lifecycle"])
    args = ap.parse_args()
    cs = chip_smoke()
    data = read_dataset("four_blobs")
    runs = {"methods": cs.METHODS_RUNS, "lifecycle": cs.LIFECYCLE_RUNS}
    for label, opts, steps in [r for phase in args.phases for r in runs[phase]]:
        accs, t0 = [], time.time()
        for seed in args.seeds:
            kw = {**cs.METHODS_BASE, **opts, "seed": seed, "num_epochs": steps,
                  "log_every": steps - 1, "fused_inner": False, "backend": "xla"}
            res = PSVI(data, **kw).run_psvi()
            accs.append(float(res["accs"][-1]))
        print(json.dumps({"run": label, "steps": steps, "seeds": args.seeds, "accs": accs,
                          "gate": round(min(accs) - 0.05, 4), "seconds": time.time() - t0}),
              flush=True)


if __name__ == "__main__":
    main()
