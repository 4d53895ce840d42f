"""Run measurement: per-step wall time and device memory, and the layer
spans.

``LogResource`` is the counterpart of ``psvi_tpu/utils/resource.py`` (ref
``psvi/inference/utils.py:1752-1781``): the averages land in the results
dict under the reference's keys ``avg_epoch_time`` and ``gpu_memory``
(MiB).

``span(name)`` marks a layer of the run loop (``psvi.step``,
``psvi.evaluate``, ``psvi.readback``, ``psvi.unroll.fwd``, ...). Off, and
with no profiler recording, it returns one shared null context. While a
``torch.profiler`` records (``profile_dir``, or a profiler around the
run), the span also enters ``record_function``, so that it lands on the
profiler's timeline beside the device's kernels. Turned on
(``enable_spans``), it appends ``(name, step, t0_ns, t1_ns)`` on
``time.perf_counter_ns`` to a list that ``take_spans`` returns and
clears. ``step`` is the index of the current step, advanced as
``psvi.step`` is entered. It is global to the module and not to a thread:
the backward of an ``autograd.Function`` runs on autograd's device thread
on the card, so a span's step and parent come from the step index and
from which spans' intervals cover it, not from a stack.

``LAUNCH_COUNTERS`` holds every kernel wrapper's launch counter (the
``LAUNCHES`` of the ``ops`` modules), each registered by
``launch_counter`` where its module makes it: whatever replays captured
launches (``inference/eval_graph.py``) walks them.
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.autograd.profiler as _profiler


class LogResource:
    def __init__(self, device: torch.device):
        self.device = device
        self.time_data = []
        self.memory_data = []
        self.prev_time = time.time()

    def update(self):
        now = time.time()
        self.time_data.append(now - self.prev_time)
        self.prev_time = now
        mem = torch.cuda.memory_allocated(self.device) if self.device.type == "cuda" else 0
        self.memory_data.append(mem / 2**20)

    def get_resources(self):
        n = max(len(self.time_data), 1)
        return {"time": sum(self.time_data) / n, "memory": sum(self.memory_data) / n}


# ---------------------------------------------------------------------------
# layer spans
# ---------------------------------------------------------------------------

STEP_SPAN = "psvi.step"

_NULL = contextlib.nullcontext()
_on = False
_step = 0
_records: list = []


class _Span:
    __slots__ = ("name", "fn", "step", "t0")

    def __init__(self, name: str):
        self.name = name
        self.fn = torch.profiler.record_function(name) if _profiler._is_profiler_enabled else None

    def __enter__(self):
        global _step
        if self.fn is not None:
            self.fn.__enter__()
        if _on and self.name == STEP_SPAN:
            _step += 1
        self.step = _step
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if _on:
            _records.append((self.name, self.step, self.t0, t1))
        if self.fn is not None:
            self.fn.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one layer's work; see the module's doc."""
    if not _on and not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


def enable_spans():
    global _on
    _on = True


def disable_spans():
    global _on
    _on = False


def take_spans() -> list:
    """The records since the last take, ``(name, step, t0_ns, t1_ns)`` in the
    order the spans closed; clears them."""
    out = list(_records)
    _records.clear()
    return out


# ---------------------------------------------------------------------------
# kernel launch counters
# ---------------------------------------------------------------------------

LAUNCH_COUNTERS: list = []


def launch_counter(counts):
    """Register ``counts``, a dict of launch counts that starts at zero and
    that a kernel's wrapper adds to where it launches, and return it."""
    LAUNCH_COUNTERS.append(counts)
    return counts
