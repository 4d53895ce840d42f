#!/usr/bin/env python3
"""Sweep the split counts of the sampled-linear kernels that split N: the
forward (B3's ``k_sampled_linear`` and B4a's ``k_prng_fwd``) and B4's
backward (``k_prng_dx`` and the two dparam kernels), on one CUDA card.

Run from the root of a checkout: ``python3 scripts/torch_b4_backward_sweep.py``.
At the LeNet fc shapes (S = 10, N = 356) and 400→120 at N = 1024 (and, for
the forward alone, 400→120 at S = 64, N = 2048), for every split count the
kernels take (the forward and dx: 1 to min(8, N / 64); dparam: 1 to
min(8, N / 32)), it times, as ``chip_smoke.py`` times B3 and B4 (50 calls
queued behind a device sleep, the median of 5):

- ``b3`` and ``b4a``: the forwards as built; ``b3_build`` and ``b4a_build``:
  the same with no x copies and no product steps (W_s's build, the launch
  and the stores);
- ``dx``: ``k_prng_dx`` as built, the blocks of a cluster sharing the draws
  where W_s has a chunk for each; ``dx_unshared``: each block draws its whole
  W tile; ``dx_phase1`` and ``dx_phase1_unshared``: phase 1 alone (no GEMM
  steps);
- ``dparam``: both passes; ``dparam_pass1``: pass 1 alone.

The variants are the checkout's sources with a line or two changed, built
with the same nvcc flags into ``psvi_torch/ops/_build/``. Every whole
variant, and the forwards at every split count, must give the bits of the
kernel as built at the plan's split count. One JSON line a shape (the plans'
split counts under ``plan``), then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
PRNG, GEMM = "sampled_linear_prng.cu", "sampled_linear_gemm.cuh"
# variant name -> (file of csrc/, the source line it replaces, the new line)
EDITS = {
    "unshared": [(GEMM, "const bool share = n_splits > 1 && groups >= n_splits;",
                  "const bool share = false;")],
    "phase1": [(PRNG, "const int steps = (t_end - t_begin) * chunks;", "const int steps = 0;")],
    "pass1": [(PRNG, "  k_prng_dparam_reduce<<<", "  if (0) k_prng_dparam_reduce<<<")],
    "fwd_build": [(GEMM, "        if (j < steps) stage(j);", "        if (false) stage(j);"),
                  (GEMM, "        if (j + STAGES - 1 < steps) stage(j + STAGES - 1);",
                   "        if (false) stage(j);"),
                  (GEMM, "        if (warp_o && n0 + 16 * wm < N) {", "        if (false) {")],
}
EDITS["phase1_unshared"] = EDITS["phase1"] + EDITS["unshared"]
# (label, S, N, Din, Dout) swept for the forward alone: 64 samples, whose
# grid fills the card at any split count
FWD_ONLY = ("S=64 N=2048", 64, 2048, 400, 120)


def build_variant(_build, name):
    """Both libraries of csrc/ with the variant's edits, loaded."""
    out = Path(_build.__file__).resolve().parent / "_build" / f"sweep_{name}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(ROOT / "psvi_torch/ops/csrc", out)
    for fname, old, new in EDITS[name]:
        text = (out / fname).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not one line of {fname}")
        (out / fname).write_text(text.replace(old, new))
    libs = []
    for src in ("sampled_linear", "sampled_linear_prng"):
        so = out / f"lib{src}.so"
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
                        str(out / f"{src}.cu")], check=True, capture_output=True)
        libs.append(typed(ctypes.CDLL(str(so))))
    return libs


def typed(lib):
    """Set the argument types of the entries the sweep calls."""
    if hasattr(lib, "psvi_sampled_linear"):
        lib.psvi_sampled_linear.argtypes = [P] * 8 + [I] * 5 + [P]
        lib.psvi_sampled_linear.restype = ctypes.c_int
        return lib
    lib.psvi_prng_fwd.argtypes = [P] * 6 + [I] * 5 + [U, U, P]
    lib.psvi_prng_dx.argtypes = [P] * 4 + [I] * 5 + [U, U, P]
    lib.psvi_prng_dparam.argtypes = [P] * 9 + [I] * 5 + [U, U, P]
    for fn in ("psvi_prng_fwd", "psvi_prng_dx", "psvi_prng_dparam"):
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_b4_backward_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from psvi_torch.ops import _build
    from psvi_torch.ops import sampled_linear as SL
    from psvi_torch.ops import sampled_linear_prng as SLP

    dev = torch.device("cuda:0")
    libs = {"built": SLP._lib()}
    b3_libs = {"built": SL._lib()}
    with ThreadPoolExecutor(len(EDITS)) as pool:
        for name, (b3, b4) in zip(EDITS, pool.map(lambda n: build_variant(_build, n), EDITS)):
            b3_libs[name], libs[name] = b3, b4
    key = SLP.philox_key(9)

    def stream():
        return P(torch.cuda.current_stream().cuda_stream)

    with torch.no_grad():
        for label, S, N, Din, Dout in C.SLP_SHAPES[:3] + [C.SLP_SHAPES[4], FWD_ONLY]:
            a = C.sl_inputs(S, N, Din, Dout, 300, dev)
            x, mu_w, rho_w, rho_b = a[0], a[1], a[2], a[4]
            row = {"shape": f"S={S} N={N} {Din}->{Dout}",
                   "plan": {"fwd": SLP._fwd_plan(S, N, Din, Dout),
                            "dx": SLP._dx_plan(S, N, Din, Dout),
                            "dparam": SLP._dparam_plan(S, N, Din, Dout)},
                   "fwd_ms": {}, "dx_ms": {}, "dparam_ms": {}}
            refs = {"b3": SL._sampled_linear_cuda(*a), "b4a": SLP._prng_fwd_cuda(*a[:5], 9)}
            for ns in range(1, min(SL.FWD_MAX_SPLITS, max(1, N // SL.FWD_MIN_POINTS)) + 1):
                times = {}
                for name, lib3, lib4 in (("b3", b3_libs["built"], None),
                                         ("b3_build", b3_libs["fwd_build"], None),
                                         ("b4a", None, libs["built"]),
                                         ("b4a_build", None, libs["fwd_build"])):
                    y = torch.empty_like(refs["b3"])

                    def call(lib3=lib3, lib4=lib4, y=y, ns=ns):
                        if lib3 is not None:
                            rc = lib3.psvi_sampled_linear(*[P(t.data_ptr()) for t in (*a, y)],
                                                          S, N, Din, Dout, ns, stream())
                        else:
                            rc = lib4.psvi_prng_fwd(*[P(t.data_ptr()) for t in (*a[:5], y)],
                                                    S, N, Din, Dout, ns, *key, stream())
                        if rc != 0:
                            raise RuntimeError(f"forward launch failed with CUDA error {rc}")

                    call()
                    torch.cuda.synchronize()
                    if "build" not in name and not torch.equal(y, refs[name]):
                        raise AssertionError(f"{name} at {ns} splits differs from the kernel")
                    times[name] = C.queued_ms(call)[0]
                row["fwd_ms"][ns] = times
            if label == FWD_ONLY[0]:
                print(json.dumps({label: row}), flush=True)
                continue
            g = torch.randn((S, N, Dout), generator=torch.Generator(dev).manual_seed(3),
                            device=dev)
            dx_ref = SLP._prng_dx_cuda(g, mu_w, rho_w, 9)
            dp_ref = SLP._prng_dparam_cuda(g, x, rho_w, rho_b, 9)
            for ns in range(1, min(SLP.DX_MAX_SPLITS, max(1, N // SLP.DX_MIN_POINTS)) + 1):
                times = {}
                for name, lib in (("dx", libs["built"]), ("dx_unshared", libs["unshared"]),
                                  ("dx_phase1", libs["phase1"]),
                                  ("dx_phase1_unshared", libs["phase1_unshared"])):
                    dx = torch.empty_like(dx_ref)

                    def call(lib=lib, dx=dx, ns=ns):
                        rc = lib.psvi_prng_dx(*[P(t.data_ptr()) for t in (g, mu_w, rho_w, dx)],
                                              S, N, Din, Dout, ns, *key, stream())
                        if rc != 0:
                            raise RuntimeError(f"dx launch failed with CUDA error {rc}")

                    call()
                    torch.cuda.synchronize()
                    if "phase1" not in name and not torch.equal(dx, dx_ref):
                        raise AssertionError(f"{name} at {ns} splits differs from the kernel")
                    times[name] = C.queued_ms(call)[0]
                row["dx_ms"][ns] = times
            for ns in range(1, min(8, max(1, N // SLP.DPARAM_MIN_POINTS)) + 1):
                outs = [torch.empty_like(t) for t in dp_ref]
                part = torch.empty((S, ns, Dout, Din + 1), device=dev)
                times = {}
                for name, lib in (("dparam", libs["built"]), ("dparam_pass1", libs["pass1"])):

                    def call(lib=lib, ns=ns, part=part):
                        rc = lib.psvi_prng_dparam(
                            *[P(t.data_ptr()) for t in (g, x, rho_w, rho_b, *outs, part)],
                            S, N, Din, Dout, ns, *key, stream())
                        if rc != 0:
                            raise RuntimeError(f"dparam launch failed with CUDA error {rc}")

                    call()
                    torch.cuda.synchronize()
                    if name == "dparam":
                        rel = max(C._rel(o, r) for o, r in zip(outs, dp_ref))
                        if not rel <= C.REL_B3:
                            raise AssertionError(f"dparam at {ns} splits: rel {rel}")
                    times[name] = C.queued_ms(call)[0]
                row["dparam_ms"][ns] = times
            print(json.dumps({label: row}), flush=True)
    print(C.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
