"""The LeNet kernel pair's share of its roofline, in %: per step, the pair's
least time (``lenet_fwd`` and ``lenet_rev`` each the larger of its
operations at the fp32 peak and its bytes at the HBM peak, from the frozen
``portbench/work_counts/lenet.py::lenet_work``) over the device time of the
pair's kernels in the traced window. Read in cells whose configuration
counts its work by that counter; the pair's kernels, by name, are listed
there."""

from portbench import work


def read(rec):
    t = rec.trace
    if t is None or rec.cell.config.get("work") != "lenet" or not rec.peaks:
        return None
    lenet = work.counter(rec.cell)
    device_s = sum(t["kernel_s"].get(k, 0.0) for k in lenet.KERNELS)
    steps = rec.traced_window.steps
    if not device_s or not steps:
        return None
    ops, byts = lenet.kernel_work(rec.cell)
    bound = sum(work.bound_s(ops[k], byts[k], rec.peaks["fp32_flops"],
                             rec.peaks["hbm_bytes_per_s"]) for k in ops)
    return 100.0 * bound / (device_s / steps)
