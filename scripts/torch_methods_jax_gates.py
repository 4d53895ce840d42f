"""Quality gates of ``chip_smoke.py``'s methods, lifecycle, options and zoo
phases, from the JAX package.

Runs the JAX engine's ``run_psvi`` on the CPU at each run of
``chip_smoke.METHODS_RUNS`` (four_blobs fn 2-40-4, M=48, S=10, T=10,
B=128, init_sd 1e-3; the remaining methods and the hyper trainer) and of
``chip_smoke.LIFECYCLE_RUNS`` (the same cell with a prune, with the
incremental coreset, and under the joint trainer with a prune) and of
``chip_smoke.OPTIONS_RUNS`` (the engine options and the readers, each on
its own dataset and cell) and of ``chip_smoke.ZOO_RUNS`` (``zoo``: the
full-covariance nets on halfmoon; ``zoo_cifar``: AlexNet and ResNet-18 on
synth_cifar, whose unrolled inner loops take about 16 GB, RESULTS.md) over
seeds 0, 1 and 2, and prints one JSON line
per run: the final accuracy of each seed and the gate, the lowest minus
0.05, that the card's run of the port must meet. Every run takes JAX's
plain step (``fused_inner=False``) and ``backend="xla"``: the Pallas ops
compute the same functions, and the port's runs on the card go through its
CUDA kernels.

``--phases baselines`` runs the JAX package's baseline runners at each run
of ``chip_smoke.BASELINE_RUNS`` (the runner, dataset and options named
there; for the sinus regressors the gate is the highest final test RMSE
plus 0.05) and its engine with ``init_args='custom'`` at each run of
``chip_smoke.CUSTOM_RUNS``.

Usage: JAX_PLATFORMS=cpu python scripts/torch_methods_jax_gates.py
       [--seeds 0 1 2] [--phases methods lifecycle options zoo zoo_cifar baselines]
       [--only LABEL_SUBSTRING]
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

from psvi_tpu.data import read_dataset, read_regression_dataset  # noqa: E402
from psvi_tpu.inference import baselines, sparsebbvi  # noqa: E402
from psvi_tpu.inference.psvi import PSVI  # noqa: E402


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--only", default="", help="run only the runs whose label contains this")
    ap.add_argument("--phases", nargs="+",
                    choices=["methods", "lifecycle", "options", "zoo", "zoo_cifar",
                             "baselines"],
                    default=["methods", "lifecycle", "options", "zoo"])
    args = ap.parse_args()
    cs = chip_smoke()
    # (label, dataset, base options, engine options, steps)
    runs = {"methods": [(label, "four_blobs", cs.METHODS_BASE, opts, steps)
                        for label, opts, steps in cs.METHODS_RUNS],
            "lifecycle": [(label, "four_blobs", cs.METHODS_BASE, opts, steps)
                          for label, opts, steps in cs.LIFECYCLE_RUNS],
            "options": [r[:5] for r in cs.OPTIONS_RUNS],
            "zoo": [(label, name, opts, {}, steps) for label, name, opts, steps in cs.ZOO_RUNS
                    if name != "synth_cifar"],
            "zoo_cifar": [(label, name, opts, {}, steps) for label, name, opts, steps
                          in cs.ZOO_RUNS if name == "synth_cifar"],
            "baselines": [(label, name, opts, {}, steps)
                          for label, name, opts, steps, _ in cs.CUSTOM_RUNS]}
    if "baselines" in args.phases:
        baseline_gates(cs, args.seeds, args.only)
    for label, name, base, opts, steps in [r for phase in args.phases for r in runs[phase]
                                           if args.only in r[0]]:
        accs, t0 = [], time.time()
        data = read_dataset(name)
        for seed in args.seeds:
            kw = {**base, **opts, "seed": seed, "num_epochs": steps,
                  "log_every": steps - 1, "fused_inner": False, "backend": "xla"}
            res = PSVI(data, **kw).run_psvi()
            accs.append(float(res["accs"][-1]))
        print(json.dumps({"run": label, "steps": steps, "seeds": args.seeds, "accs": accs,
                          "gate": round(min(accs) - 0.05, 4), "seconds": time.time() - t0}),
              flush=True)


def baseline_gates(cs, seeds, only=""):
    """The JAX runners of ``chip_smoke.BASELINE_RUNS``, one JSON line each."""
    modules = {"baselines": baselines, "sparsebbvi": sparsebbvi}
    for label, module, runner, name, opts in [r for r in cs.BASELINE_RUNS if only in r[0]]:
        t0 = time.time()
        data = read_regression_dataset(name) if name == "sinus" else read_dataset(name)
        vals = []
        for seed in seeds:
            res = getattr(modules[module], runner)(**cs.runner_data(module, runner, data),
                                                   **{**opts, "seed": seed})
            kind, val = cs.final_metric(res)
            vals.append(float(val))
        gate = max(vals) + 0.05 if kind == "rmse" else min(vals) - 0.05
        print(json.dumps({"run": label, "seeds": seeds, kind + "s": vals, "gate": round(gate, 4),
                          "seconds": time.time() - t0}), flush=True)


if __name__ == "__main__":
    main()
