"""The whole step's share of the card's fp32 peak, in %: one step's
operations counted from the configuration's shapes by the work counter it
names (``portbench/work_counts/<name>.py::step_ops``: the unroll and the
outer IW-ELBO with its gradient, the same count whatever runs the step)
over the window's seconds per step times the peak. The card's power limit
is printed beside each run."""

from portbench import work


def read(rec):
    w = rec.window
    if not rec.peaks or not w.steps or not w.seconds:
        return None
    ops = work.counter(rec.cell).step_ops(rec.cell)
    return 100.0 * ops / (w.seconds / w.steps * rec.peaks["fp32_flops"])
