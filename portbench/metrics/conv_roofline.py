"""The grouped convolution's share of its roofline, in %: per step, its
least time (the step's conv2 passes and the evaluation's share, each the
larger of its operations at the fp32 peak and its bytes at the HBM peak,
from the frozen ``portbench/work_counts/alexnet_cifar10.py::conv_work``)
over the device time of its kernels (``conv_device_ms``'s reading)."""

from pathlib import Path

from portbench import work
from portbench.harness import load_module


def read(rec):
    per_step = load_module(Path(__file__).with_name("conv_device_ms.py")).device_s_per_step(rec)
    if per_step is None or not rec.peaks:
        return None
    ops, byts = work.counter(rec.cell).conv_work(rec.cell)
    bound = sum(work.bound_s(ops[k], byts[k], rec.peaks["fp32_flops"],
                             rec.peaks["hbm_bytes_per_s"]) for k in ops)
    return 100.0 * bound / per_step
