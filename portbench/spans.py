"""The host's split of a step and an evaluation, from the program's layer
spans (``psvi_torch/utils/resource.py::span``; records ``(name, step,
t0_ns, t1_ns)``).

A span's children are the spans of the same step whose intervals lie
inside its own; its self time is its length less the union of theirs. So
``psvi.unroll.rev``, which runs on autograd's device thread on the card,
counts as a child of ``psvi.outer.bwd`` and of ``psvi.step``. Per step:

- ``host_unroll_ms``: ``psvi.unroll.fwd`` + ``psvi.unroll.rev``, the kernel
  pair's C entries (their launch loops, and any wait on a full launch
  queue);
- ``host_outer_ms``: the self time of ``psvi.outer.fwd`` and
  ``psvi.outer.bwd``, the IW-ELBO's forward and backward less the unroll's
  reverse inside it;
- ``host_step_self_ms``: ``psvi.step`` less its children: the draws, the
  packing, the hyper-Adam, Python;

and per evaluation ``host_eval_ms`` (``psvi.evaluate``, the enqueue of the
test batches) and ``host_wait_ms`` (``psvi.readback``, the host blocked
until the device has drained).
"""

from __future__ import annotations

from collections import defaultdict

STEP = "psvi.step"
NAMES = (STEP, "psvi.unroll.fwd", "psvi.unroll.rev", "psvi.outer.fwd", "psvi.outer.bwd",
         "psvi.evaluate", "psvi.readback")


def _union_ns(intervals) -> int:
    total, end = 0, None
    for s, t in sorted(intervals):
        if end is None or s > end:
            total, end = total + t - s, t
        elif t > end:
            total, end = total + t - end, t
    return total


def self_times(records) -> list:
    """``(name, step, length_ns, self_ns)`` of each record."""
    by_step = defaultdict(list)
    for i, (_, step, t0, t1) in enumerate(records):
        by_step[step].append((t0, t1, i))
    out = []
    for i, (name, step, t0, t1) in enumerate(records):
        inside = [(s, t) for s, t, j in by_step[step] if j != i and t0 <= s and t <= t1]
        out.append((name, step, t1 - t0, t1 - t0 - _union_ns(inside)))
    return out


def summary(records) -> dict:
    """Per name: the count and the total and self ms."""
    acc = {}
    for name, _, length, own in self_times(records):
        row = acc.setdefault(name, {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
        row["count"] += 1
        row["total_ms"] += length * 1e-6
        row["self_ms"] += own * 1e-6
    return dict(sorted(acc.items()))


def split(records) -> dict:
    """The five readings above and the mean ``psvi.step``, in ms; empty
    where the records hold no step."""
    s = summary(records)
    steps = s.get(STEP, {}).get("count", 0)
    if not steps:
        return {}
    tot = lambda n: s.get(n, {}).get("total_ms", 0.0)  # noqa: E731
    own = lambda n: s.get(n, {}).get("self_ms", 0.0)  # noqa: E731
    out = {"step_ms": tot(STEP) / steps,
           "host_unroll_ms": (tot("psvi.unroll.fwd") + tot("psvi.unroll.rev")) / steps,
           "host_outer_ms": (own("psvi.outer.fwd") + own("psvi.outer.bwd")) / steps,
           "host_step_self_ms": own(STEP) / steps}
    for key, name in (("host_eval_ms", "psvi.evaluate"), ("host_wait_ms", "psvi.readback")):
        if name in s:
            out[key] = tot(name) / s[name]["count"]
    return out
