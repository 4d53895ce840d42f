"""Probes behind the lifecycle phase's choices, on the CUDA card.

- ``joint_seeds``: the joint trainer through B3 (and through the plain
  product) on the four_blobs cell of ``chip_smoke.py``, pruned 48 → 24
  after step 50, at 101 and 151 steps, final accuracy over seeds 0-4: how
  far the run must go after the prune's net restart to carry a gate.
- ``lenet_determinism``: the fused LeNet step (flagship, M=100, S=10,
  T=20, B=256) rerun from one state on one draw, with cuDNN's default
  algorithms and with its deterministic ones: which state leaves differ
  between reruns, and the step's median ms each way, in turns.
- ``dense_step --root DIR``: the dense fused step of the checkout at DIR
  (four_blobs fn 2-40-4, M=48), the median of 300 single calls by CUDA
  events, and three 101-step ``run_psvi`` wall times: run it once per
  tree, in turns, to compare two trees.

Usage: python3 scripts/torch_lifecycle_probes.py joint_seeds | lenet_determinism |
       dense_step --root DIR
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]

# chip_smoke.py's dense flagship (METHODS_BASE)
DENSE = dict(method="psvi_learn_v", num_pseudo=48, mc_samples=10, architecture="fn",
             n_hidden=40, n_layers=1, inner_it=10, data_minibatch=128, init_sd=1e-3)


def joint_seeds():
    from psvi_torch.data import read_dataset
    from psvi_torch.inference.psvi import PSVI

    blobs = read_dataset("four_blobs")
    for steps in (101, 151):
        for backend in ("pallas", "xla"):
            t0 = time.perf_counter()
            accs = [float(PSVI(blobs, **DENSE, trainer="joint", backend=backend, prune=True,
                               prune_interval=50, prune_sizes=(24,), num_epochs=steps,
                               log_every=steps - 1, seed=seed).run_psvi()["accs"][-1])
                    for seed in range(5)]
            print(json.dumps({"steps": steps, "backend": backend, "accs": accs,
                              "seconds": time.perf_counter() - t0}), flush=True)


def lenet_determinism():
    from psvi_torch.data import read_dataset
    from psvi_torch.inference.psvi import PSVI
    from psvi_torch.utils.tree import tree_leaves

    eng = PSVI(read_dataset("synth_mnist"), method="psvi_learn_v", architecture="lenet",
               num_pseudo=100, mc_samples=10, inner_it=20, data_minibatch=256, init_sd=1e-3,
               num_epochs=3, log_every=10, seed=0)
    eng.run_psvi()
    state, batch = eng.state, eng._sample_batch()
    eps = ([eng._sample_eps(10) for _ in range(20)], eng._sample_eps(10))

    def step():
        return tree_leaves(eng._nested_step_fused_lenet(state, batch=batch, eps=eps)[0])

    def differing(a, b):
        return [i for i, (x, y) in enumerate(zip(a, b))
                if torch.is_tensor(x) and not torch.equal(x, y)]

    def median_ms(reps=10):
        step()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out))

    res = {}
    for mode in (False, True):
        torch.backends.cudnn.deterministic = mode
        ref = step()
        res[f"deterministic={mode}: leaves differing on reruns"] = [
            differing(ref, step()) for _ in range(3)]
    times = {}
    for mode in (False, True, True, False):
        torch.backends.cudnn.deterministic = mode
        times.setdefault(f"deterministic={mode}", []).append(median_ms())
    res["step_ms"] = times
    print(json.dumps(res), flush=True)


def dense_step(root):
    sys.path.insert(0, str(Path(root).resolve()))
    from psvi_torch.data import read_dataset
    from psvi_torch.inference.psvi import make_psvi_engine

    blobs = read_dataset("four_blobs")
    kw = {**DENSE, "num_epochs": 101, "log_every": 50, "seed": 0}
    eng = make_psvi_engine(blobs, **kw)
    eng.run_psvi()
    walls = []
    for _ in range(3):
        e = make_psvi_engine(blobs, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e.run_psvi()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    state, batch = eng.state, eng._sample_batch()
    ms = []
    for _ in range(300):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        eng._nested_step_fused(state, batch)
        e.record()
        torch.cuda.synchronize()
        ms.append(s.elapsed_time(e))
    print(json.dumps({"root": root, "step_ms_median": float(np.median(ms)),
                      "step_ms_quartiles": [float(np.quantile(ms, q)) for q in (0.25, 0.75)],
                      "run_psvi_101_s": walls}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("probe", choices=["joint_seeds", "lenet_determinism", "dense_step"])
    ap.add_argument("--root", default=str(REPO), help="checkout whose psvi_torch dense_step runs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_lifecycle_probes: no CUDA device")
    if args.probe == "dense_step":
        dense_step(args.root)
    else:
        sys.path.insert(0, str(REPO))
        {"joint_seeds": joint_seeds, "lenet_determinism": lenet_determinism}[args.probe]()


if __name__ == "__main__":
    main()
