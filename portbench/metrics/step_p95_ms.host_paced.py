"""The run loop's tail where the card idles half the window or more, so
the host paces it: the 95th percentile over every step of the window of
the step's time between CUDA events at ``PSVI._step``'s entry and return."""

import numpy as np


def read(rec):
    ms = rec.window.step_ms
    return float(np.percentile(ms, 95)) if ms else None
