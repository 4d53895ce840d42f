#!/usr/bin/env python3
"""Sweep the tile shape of the LeNet kernels' fc GEMM (``k_gemm`` in
``psvi_torch/ops/csrc/fused_lenet.cu``) on one CUDA card.

Run from the root of a checkout: ``python3 scripts/torch_lenet_gemm_sweep.py``.
Each variant is the checkout's ``fused_lenet.cu`` with ``k_gemm``'s tile
macros changed (GBM × GBN output rows and columns, a GBK k tile, GTY × GTX
threads, so a (GBM / GTY) × (GBN / GTX) micro-tile a thread), built with the
same nvcc flags into ``psvi_torch/ops/_build/``. Each must pass
``chip_smoke.py``'s lenet checks at psvi_alpha_v S=4 M=16 T=5 (against the
plain versions, a rerun bit for bit, the composed unroll against autograd).
Then, at the LeNet flagship (S=10, M=100, T=20), the CUDA-event medians of
``lenet_fwd`` and ``lenet_rev`` (10 calls) and ``k_gemm``'s device time in
one call of each (torch.profiler), in two passes over the variants in
opposite orders. One JSON line a variant and pass, then the card's name and
power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
from psvi_torch.data import read_dataset  # noqa: E402
from psvi_torch.ops import _build  # noqa: E402
from psvi_torch.ops import fused_lenet as FL  # noqa: E402

MACROS = ("GBM", "GBN", "GBK", "GTY", "GTX")
AS_BUILT = (32, 32, 64, 16, 16)
VARIANTS = [AS_BUILT, (32, 32, 16, 16, 16), (32, 32, 32, 16, 16), (64, 64, 16, 16, 16),
            (64, 64, 32, 16, 16), (32, 64, 32, 16, 16), (64, 32, 32, 16, 16),
            (32, 32, 32, 8, 8), (32, 32, 32, 8, 16)]


def name(v):
    return "{}x{}x{}_{}x{}".format(*v)


def build(v):
    """nvcc the variant; returns (variant, library path, k_gemm's spills)."""
    src = (_build._CSRC / "fused_lenet.cu").read_text()
    for macro, old, new in zip(MACROS, AS_BUILT, v):
        line = f"#define {macro} {old} "
        if src.count(line) != 1:
            raise RuntimeError(f"{line!r} is not in fused_lenet.cu once")
        src = src.replace(line, f"#define {macro} {new} ")
    _build._BUILD.mkdir(parents=True, exist_ok=True)
    cu = _build._BUILD / f"gemm_{name(v)}.cu"
    cu.write_text(src)
    so = cu.with_suffix(".so")
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name(v)}:\n{proc.stderr}")
    return v, so, CS.check_no_spills(proc.stdout + proc.stderr, ("k_gemm",))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(build, VARIANTS))
    mnist = read_dataset("synth_mnist")
    cfg = CS.lenet_cfg(FL, mnist, 10, 100, 20, True, False)
    a = CS.lenet_inputs(FL, cfg, mnist, 7, dev)
    args = (a["u"], a["z"], a["v"], a["alpha"], a["e_in"], a["lr"], cfg)
    _, hist, _ = FL.lenet_fwd_torch(a["p0"], *args)
    calls = {"lenet_fwd": lambda: FL._lenet_fwd_cuda(a["p0"], *args),
             "lenet_rev": lambda: FL._lenet_rev_cuda(hist, a["pbar"], a["dlosses"], *args)}
    scfg = CS.lenet_cfg(FL, mnist, 4, 16, 5, True, True)
    sa = CS.lenet_inputs(FL, scfg, mnist, 1, dev)
    for order in (built, built[::-1]):
        for v, so, spills in order:
            _build._LOADED["fused_lenet"] = ctypes.CDLL(str(so))
            CS.check_lenet(FL, CS.Checker(), f"{name(v)} psvi_alpha_v S=4 M=16 T=5", scfg, sa,
                           True)
            with torch.no_grad():
                ms = {k: CS.median_ms(f, reps=10, warmup=2) for k, f in calls.items()}
                prof = CS.profile_calls(calls, sums={"k_gemm_ms": "k_gemm"})
            print(json.dumps({"variant": dict(zip(MACROS, v)), "as_built": v == AS_BUILT,
                              "k_gemm_spills": spills["k_gemm"], "ms": ms,
                              "k_gemm_device_ms": {k: p["k_gemm_ms"] for k, p in prof.items()}}),
                  flush=True)
    print(CS.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
