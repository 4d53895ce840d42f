"""The numbers that decide ``correct``, and the judgement against limits.

The judged side (the program, or the control in its place) goes through
the checked steps from the benchmark's start; ``harness.program_states``
records the state it was in before each step and what the step returned.
The plain reference, in float64, makes one step from each of those states
on the same minibatch and noise (``harness.reference_readings``), so each
step is judged on its own and a step's rounding does not carry into the
next. Five numbers:

- ``outer``: the outer stage. Each step's outer loss as the side reports
  it, against the reference's outer loss at the net the side's unroll ended
  at (same u, v, minibatch and noise), relative; the worst step.
- ``inner``: the inner stage's start. Each step's first inner loss (at the
  net the step started from) against the reference's, relative; the worst
  step.
- ``net``: the unroll. For each net leaf (μ and ρ of each layer), the norm
  of the difference between the net the side's unroll ended at and the
  reference's, over the larger of the reference's change of that leaf in
  the step and the median leaf's; per step the median leaf, and the
  geometric mean over the steps. A leaf whose first inner gradient in the
  reference is under a thousandth of the median leaf's is left out.
- ``hyper``: the hypergradients' size. Each step's gradient of u and of v
  as the side's hyper-Adam took it (from its first moments before and after
  the step), the gap between its norm and the reference's over the
  reference's; per step the worse of u and v, and the geometric mean over
  the steps.
- ``update``: the hyper update. Each step's change of u and of v, the gap
  between its norm and the reference's (the reference's hyper-Adam applied
  to its own hypergradient from the same state) over the reference's; per
  step the worse of u and v, and the geometric mean over the steps.

Why the geometric mean over the steps: a step of the T-iteration Adam
unroll can cross a tie (a max-pool's winner, a ReLU's kink, an inner
gradient near 0) that one float32 rounding flips; the step then lands on
another branch, and the float64 reference does the same under a one-ulp
change of its start (PERF.md §4). A float32 program flips few steps, so
one flipped step moves the mean by its cube root only; a lower precision
moves every step. Every step counts, so a fault in all of them shows in
full.
"""

from __future__ import annotations

import math
import statistics

import torch

from portbench.reference.common import KEYS

NAMES = ("outer", "inner", "net", "hyper", "update")
NEGLIGIBLE = 1e-3
B1 = 0.9  # the hyper-Adam's first-moment decay


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else math.inf


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _net_gap(step, ref) -> float:
    """The median leaf's difference between the side's net after the step
    and the reference's, over the reference's change."""
    first = ref["first_grad"]
    med_g = statistics.median(first)
    keep = [i for i, g in enumerate(first) if g >= NEGLIGIBLE * med_g]
    flat = lambda layers: [p[k] for p in layers for k in KEYS]  # noqa: E731
    start, mine, theirs = (flat(step["before"]["layers"]), flat(step["after"]["layers"]),
                           flat(ref["layers"]))
    moved = [_norm(theirs[i] - start[i].double()) for i in keep]
    med = statistics.median(moved)
    gaps = [_norm(mine[i].double() - theirs[i]) / max(m, med) for i, m in zip(keep, moved)]
    return _finite(statistics.median(gaps))


def _hyper_gap(step, ref) -> float:
    """The worse of u and v: the gap of norms between the gradient the
    side's hyper-Adam took in the step and the reference's."""
    gaps = []
    for h in ("u", "v"):
        m0, m1 = step["before"][f"opt_{h}"][1], step["after"][f"opt_{h}"][1]
        g = (m1.double() - B1 * m0.double()) / (1 - B1)
        gaps.append(abs(_norm(g) - _norm(ref[f"g_{h}"])) / _norm(ref[f"g_{h}"]))
    return _finite(max(gaps))


def _update_gap(step, ref) -> float:
    """The worse of u and v: the gap of norms between the side's change in
    the step and the reference's."""
    gaps = []
    for h in ("u", "v"):
        before = step["before"][h].double()
        mine, theirs = _norm(step["after"][h].double() - before), _norm(ref[h] - before)
        gaps.append(abs(mine - theirs) / theirs)
    return _finite(max(gaps))


def per_step(steps: list, ref: list) -> dict:
    """Each step's readings of the five numbers."""
    return {"outer": [_finite(_rel(s["outer"], r["outer_stage"])) for s, r in zip(steps, ref)],
            "inner": [_finite(_rel(s["inner"][0], r["inner1"])) for s, r in zip(steps, ref)],
            "net": [_net_gap(s, r) for s, r in zip(steps, ref)],
            "hyper": [_hyper_gap(s, r) for s, r in zip(steps, ref)],
            "update": [_update_gap(s, r) for s, r in zip(steps, ref)]}


def _over_steps(reduce, xs) -> float:
    """``reduce`` over the steps; infinite where any step is not finite."""
    return math.inf if any(not math.isfinite(x) for x in xs) else reduce(xs)


def _geometric_mean(xs) -> float:
    """The geometric mean; a step that reads 0 counts as 1e-12."""
    return math.exp(statistics.fmean(math.log(max(x, 1e-12)) for x in xs))


def numbers(steps: list, ref: list) -> dict:
    """The five numbers of a judged side's steps against the reference's."""
    p = per_step(steps, ref)
    return {"outer": _over_steps(max, p["outer"]), "inner": _over_steps(max, p["inner"]),
            "net": _over_steps(_geometric_mean, p["net"]),
            "hyper": _over_steps(_geometric_mean, p["hyper"]),
            "update": _over_steps(_geometric_mean, p["update"])}


def judge(nums: dict, limits) -> dict:
    """Each number the cell compares beside its limit; ``correct`` when
    every one is finite and within its limit. A cell with no limits is not
    correct."""
    lim = limits or {}
    rows = {k: {"value": nums[k], "limit": lim[k]} for k in NAMES if k in lim}
    ok = bool(rows) and all(math.isfinite(r["value"]) and r["value"] <= r["limit"]
                            for r in rows.values())
    return {"correct": ok, "check": rows}
