#!/usr/bin/env python3
"""How far the plain LeNet reverse sweep's fp32 result lies from its own
float64 run, on ``chip_smoke.py``'s lenet inputs: the floor under any fp32
kernel's agreement with the plain version at that config.

Run from the root of a checkout, on the CPU:
``python3 scripts/torch_lenet_fp32_gap.py [S M T seed] ...`` (default: the
lenet phase's small configs at S = 2, with chip_smoke's seed). For each
config, ``lenet_rev_torch`` runs on the float64 forward's history in fp32 and
in float64 from the same numpy inputs; one JSON line each gives
max|Δ|/max|ref| and the cosine of p̄0, ū and v̄. At t = 1 Adam's step is
−lr·sign(g), whose VJP grows as 1/|g|, so a config whose first gradient has
entries near 0 can sit far from its float64 result in fp32.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as CS  # noqa: E402
from psvi_torch.data import read_dataset  # noqa: E402
from psvi_torch.ops import fused_lenet as FL  # noqa: E402

# (S, M, T, seed): psvi_learn_v at S = 2 with M = 13 (the ragged chunk) at
# T = 2 and 3, seed 3 as the lenet phase gives its fourth config
DEFAULT = [(2, 13, 2, 3), (2, 13, 3, 3)]


def gap(mnist, S, M, T, seed):
    cfg = CS.lenet_cfg(FL, mnist, S, M, T, True, False)
    a = CS.lenet_inputs(FL, cfg, mnist, seed, torch.device("cpu"))
    d = {k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v
         for k, v in a.items()}
    _, hist, _ = FL.lenet_fwd_torch(d["p0"], d["u"], d["z"], d["v"], d["alpha"], d["e_in"],
                                    d["lr"], cfg)
    outs = [FL.lenet_rev_torch(h, x["pbar"], x["dlosses"], x["u"], x["z"], x["v"], x["alpha"],
                               x["e_in"], x["lr"], cfg)
            for h, x in ((hist.float(), a), (hist, d))]
    return {"S": S, "M": M, "T": T, "seed": seed, **{
        nm: {"rel": float(CS._rel(x.double(), y)), "cos": float(CS._cos(x.double(), y))}
        for nm, x, y in zip(("p0bar", "ubar", "vbar"), *outs)}}


def main(argv) -> int:
    configs = [tuple(int(x) for x in argv[i:i + 4]) for i in range(0, len(argv), 4)] or DEFAULT
    mnist = read_dataset("synth_mnist")
    for c in configs:
        print(json.dumps(gap(mnist, *c)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
