"""The engine step's host time: the host clock inside the benchmark's span
around each ``PSVI._step`` call (the enqueue of the step's work), mean over
the window's steps, in ms."""

import statistics


def read(rec):
    ms = rec.window.host_step_ms
    return statistics.fmean(ms) if ms else None
