"""Reduce a ``torch.profiler`` window to what the per-layer metrics read.

From the profiler's raw events: the device intervals (kernels, copies and
sets; the device side of a user span is not work), the device seconds of
each kernel by name, the busy seconds (their union) and the idle gaps
between them, each labelled by the innermost of the benchmark's host spans
(``portbench.step``, ``portbench.evaluate``, ``portbench.block``) that was
open at its middle: what the host was doing while the card waited.
"""

from __future__ import annotations

from collections import defaultdict


def base_name(name: str) -> str:
    """A kernel's name without its return type, namespace, template
    arguments and parameters: ``void k_conv1<false>(ConvArgs)`` → ``k_conv1``."""
    n = name[5:] if name.startswith("void ") else name
    n = n.split("(")[0].split("<")[0].strip()
    return n.split("::")[-1]


def short_name(name: str) -> str:
    n = name[5:] if name.startswith("void ") else name
    return n.split("(")[0][:160]


def _on_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def reduce(events, spans, window_s: float) -> dict:
    dev, host = [], []
    for e in events:
        name = e.name()
        if _on_device(e):
            # the device side of a user span (``gpu_user_annotation``) is no work
            if name in spans or (hasattr(e, "is_user_annotation") and e.is_user_annotation()):
                continue
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
        elif name in spans:
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    by_kernel, by_full = defaultdict(float), defaultdict(float)
    for s, t, name in dev:
        by_kernel[base_name(name)] += (t - s) * 1e-9
        by_full[short_name(name)] += (t - s) * 1e-9
    dev.sort()
    merged = []
    for s, t, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) * 1e-9
    gaps = []
    for (_, t0), (s1, _) in zip(merged, merged[1:]):
        mid = (t0 + s1) / 2
        inside = [h for h in host if h[0] <= mid <= h[1]]
        label = min(inside, key=lambda h: h[1] - h[0])[2] if inside else "outside the run loop"
        gaps.append((label, (s1 - t0) * 1e-9))
    gaps.sort(key=lambda g: -g[1])
    gap_by_span = defaultdict(float)
    for label, sec in gaps:
        gap_by_span[label] += sec
    return {
        "window_s": window_s,
        "busy_s": busy,
        "kernel_s": dict(by_kernel),
        "device_ops": sorted(([k, v] for k, v in by_full.items()), key=lambda r: -r[1]),
        "idle_gaps": [[label, sec] for label, sec in gaps],
        "idle_by_span": dict(gap_by_span),
        "n_device_events": len(dev),
    }
