"""The sinus regression's final test RMSE, the JAX package against the port.

Runs the JAX engine and the port on the CPU, each over the same seeds, at
the regression main path of ``chip_smoke.py``'s engine phase: sinus,
regressor_net 1-40-1, psvi_learn_v_regressor, M=10, S=10, T=10, B=64,
τ=0.1, lr 1e-2 for u, v and z (``scripts/regressor_parity.py:37-41``'s
hyperparameters), 101 outer steps. The port takes its card's path, the
fused step, here through the kernels' plain versions. The noise streams
differ by design, so only the spreads compare: the script prints each
side's final RMSE per seed, their ranges, and whether the ranges overlap.

Usage: JAX_PLATFORMS=cpu python scripts/torch_sinus_rmse_spread.py [--seeds 0 1 2 3 4]
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from psvi_torch.data import read_regression_dataset  # noqa: E402
from psvi_torch.inference.psvi import make_psvi_engine  # noqa: E402
from psvi_tpu.data import read_regression_dataset as jax_read_regression_dataset  # noqa: E402
from psvi_tpu.inference.psvi import make_psvi_engine as jax_make_psvi_engine  # noqa: E402

KW = dict(method="psvi_learn_v_regressor", architecture="regressor_net", n_hidden=40,
          n_layers=1, num_pseudo=10, mc_samples=10, inner_it=10, data_minibatch=64, tau=0.1,
          init_sd=1e-3, lr0net=1e-3, lr0u=1e-2, lr0v=1e-2, lr0z=1e-2, num_epochs=101,
          log_every=25)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    args = ap.parse_args()
    sides = {
        "jax": lambda seed: jax_make_psvi_engine(jax_read_regression_dataset("sinus"),
                                                 **KW, seed=seed, fused_inner=False),
        "port": lambda seed: make_psvi_engine(read_regression_dataset("sinus"), **KW,
                                              seed=seed, device="cpu", fused_inner=True),
    }
    rmses = {}
    for side, make in sides.items():
        t0 = time.time()
        rmses[side] = [float(make(seed).run_psvi()["rmses"][-1]) for seed in args.seeds]
        print(json.dumps({"side": side, "seeds": args.seeds, "rmses": rmses[side],
                          "range": [min(rmses[side]), max(rmses[side])],
                          "seconds": time.time() - t0}), flush=True)
    lo = max(min(r) for r in rmses.values())
    hi = min(max(r) for r in rmses.values())
    print(json.dumps({"overlap": lo <= hi, "common_range": [lo, hi] if lo <= hi else None}))


if __name__ == "__main__":
    main()
