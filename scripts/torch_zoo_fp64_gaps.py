#!/usr/bin/env python3
"""How far the zoo's fp32 steps lie from the same steps in float64 on one
CUDA card, and where the joint step's two dense backends part.

Run from the root of a checkout on a CUDA card:
``python3 scripts/torch_zoo_fp64_gaps.py [out.jsonl]`` (default
``zoo_fp64_gaps.jsonl``, with every leaf; the lines are also printed,
the joint ones without their per-leaf lists). TF32 is
off, as in ``chip_smoke.py``. On ``synth_cifar``, with ``chip_smoke.py``'s
zoo configurations:

1. The joint trainer (AlexNet at S=10, ResNet-18 at its nested run's M, S,
   B), one step from one state on one draw of the batch and the noise, its
   gradient (the joint Adam's first moment, 0.1·g after one step) four
   ways: ``backend="xla"`` in fp32 and in float64, ``backend="pallas"``
   (B3) in fp32, and the xla step with each dense head's forward value
   replaced by B3's (``y_xla + (y_B3 − y_xla).detach()``: B3's forward
   values, autograd's backward). Per leaf, max|Δ|/max|ref| and the cosine of
   each pair. If the xla step with B3's values lands on the B3 step, the
   backends part only through the heads' forward rounding; if the fp32 xla
   step lies as far from float64 as B3's, that rounding is the size of
   fp32's own error in the step.
2. The nested trainer (AlexNet M=100 S=5 T=10 B=128; ResNet-18 M=50 S=4 T=5
   B=128), one step's hypergradients g_u and g_v in fp32 and in float64 on
   the card against the same step in float64 on the host (the CPU's conv,
   pooling and norm ops: a reference that shares no kernel with cuDNN),
   with each float64 run's seconds (ResNet-18's float64 runs under
   ``remat_inner``, the same function in less memory).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as CS  # noqa: E402
from psvi_torch.data import read_dataset  # noqa: E402
from psvi_torch.inference.psvi import make_psvi_engine  # noqa: E402

JOINT = [("alexnet", {**CS.ALEXNET_KW, "mc_samples": 10}),
         ("resnet18", CS.RESNET_KW)]
NESTED = [("alexnet", CS.ALEXNET_KW, False), ("resnet18", CS.RESNET_KW, True)]


def pair(x, y):
    return {"rel": CS._rel(x.double(), y.double()), "cos": CS._cos(x, y)}


def joint_gaps(cifar, net, kw, out):
    kw = {k: v for k, v in kw.items() if k not in ("num_epochs", "log_every")}
    es = {b: make_psvi_engine(cifar, **kw, trainer="joint", backend=b)
          for b in ("xla", "pallas")}
    st = es["xla"].state
    batch = es["xla"]._sample_batch()
    eps = es["xla"]._sample_eps(kw["mc_samples"])
    m = {"xla32": CS.joint_moment(es["xla"], st, batch, eps),
         "b3_32": CS.joint_moment(es["pallas"], st, batch, eps),
         "xla32_b3_heads": CS.joint_moment(es["xla"], st, batch, eps, heads_from_b3=True),
         "xla64": CS.joint_moment(es["xla"], CS._double(st), CS._double(batch),
                                  CS._double(eps))}
    pairs = {"b3_32 vs xla32": ("b3_32", "xla32"), "b3_32 vs xla64": ("b3_32", "xla64"),
             "xla32 vs xla64": ("xla32", "xla64"),
             "xla32_b3_heads vs b3_32": ("xla32_b3_heads", "b3_32"),
             "xla32_b3_heads vs xla32": ("xla32_b3_heads", "xla32")}
    leaves = []
    for i, ref in enumerate(m["xla64"]):
        row = {"leaf": i, "shape": list(ref.shape)}
        row.update({k: pair(m[a][i], m[b][i]) for k, (a, b) in pairs.items()})
        leaves.append(row)
    worst = {k: max(leaves, key=lambda r: r[k]["rel"]) for k in pairs}
    line = {"config": f"synth_cifar {net} joint M={kw['num_pseudo']} S={kw['mc_samples']} "
            f"B={kw['data_minibatch']}: one step's first moment",
            "worst_rel_by_pair": {k: {"leaf": r["leaf"], "shape": r["shape"], **r[k]}
                                  for k, r in worst.items()},
            "leaves": leaves}
    out(line)
    del es, m
    torch.cuda.empty_cache()


def nested_gaps(cifar, net, kw, remat64, out):
    kw = {k: v for k, v in kw.items() if k not in ("num_epochs", "log_every")}
    rep = CS.nested_vs_host(make_psvi_engine, cifar, kw, remat64)
    out({"config": f"synth_cifar {net} nested M={kw['num_pseudo']} S={kw['mc_samples']} "
         f"T={kw['inner_it']} B={kw['data_minibatch']}: one step's hypergradients, fp32 and "
         "float64 on the card against float64 on the host", **rep})
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_zoo_fp64_gaps: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    path = Path(sys.argv[1] if len(sys.argv) > 1 else "zoo_fp64_gaps.jsonl")
    path.parent.mkdir(parents=True, exist_ok=True)
    card = CS.nvidia_smi_line()
    with path.open("w") as f:
        def out(obj):
            s = json.dumps({"card": card, **obj})
            print(s if len(s) < 4000 else json.dumps({"card": card, **{
                k: v for k, v in obj.items() if k != "leaves"}}), flush=True)
            f.write(s + "\n")
            f.flush()

        cifar = read_dataset("synth_cifar")
        for net, kw in JOINT:
            joint_gaps(cifar, net, kw, out)
        for net, kw, remat64 in NESTED:
            nested_gaps(cifar, net, kw, remat64, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
