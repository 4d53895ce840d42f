#!/usr/bin/env python3
"""B4d's grid target on one CUDA card: ``k_prng_nkl`` at each NKL_BLOCKS.

Run from the root of a checkout: ``python3 scripts/torch_nkl_grid_sweep.py``.
``_nkl_plan`` deals the samples to the fewest groups whose grid of element
tiles × groups reaches NKL_BLOCKS blocks. This script sets NKL_BLOCKS to 2,
4, 8 and 16 times the 132 SMs in turn and prints, for each and for each of
``chip_smoke.py``'s NKL shapes (the LeNet fc layers at S = 10, 64→32 at S =
4000), the plan and the NKL's time a call (50 calls queued behind a device
sleep, the median of 5: ``chip_smoke.queued_ms``); then, at the plan's own
target, each shape's device time by kernel (``k_prng_nkl``,
``k_prng_nkl_reduce``) from torch.profiler over 20 calls. The reduce is a
programmatic dependent launch: its device time includes its wait for
``k_prng_nkl``. The last line is the card's name and power limit.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from psvi_torch.ops import sampled_linear_prng as SLP

    dev = torch.device("cuda:0")
    target = SLP.NKL_BLOCKS
    calls = {}
    for label, S, Din, Dout in CS.NKL_SHAPES:
        p = CS.sl_inputs(1, 1, Din, Dout, 301, dev)[1:5]
        calls[label] = (S, Din, Dout, CS.nkl_call(SLP, p, 301, S)[0])
    with torch.no_grad():
        for mult in (2, 4, 8, 16):
            SLP.NKL_BLOCKS = mult * SLP.SMS
            for label, (S, Din, Dout, kern) in calls.items():
                print(json.dumps({"nkl_blocks": SLP.NKL_BLOCKS, "shape": label,
                                  "plan": CS.nkl_plan(SLP, S, Din, Dout),
                                  "queued_ms": CS.queued_ms(kern)[0]}), flush=True)
        SLP.NKL_BLOCKS = target
        for label, (_, _, _, kern) in calls.items():
            prof = CS.profile_calls({"x20": lambda k=kern: [k() for _ in range(20)]})["x20"]
            print(json.dumps({"nkl_blocks": target, "shape": label, "calls": 20,
                              "device_ms": prof["device_ms"], "by_kernel": prof["top"]}),
                  flush=True)
    print(CS.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
