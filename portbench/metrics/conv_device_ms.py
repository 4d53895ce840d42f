"""Device ms per step of the grouped convolution's kernels in the traced
window: the kernels that ``portbench/work_counts/alexnet_cifar10.py``
lists as ``CONV_KERNELS`` (cuDNN's, which run conv2's forward, data and
weight gradients and their second-order terms, and the evaluations'
forwards), over the traced window's steps. Read only in cells whose
configuration counts its work by that counter."""

from portbench import work

COUNTER = "alexnet_cifar10"


def device_s_per_step(rec):
    """The convolution kernels' device seconds a traced step, or None."""
    t = rec.trace
    if t is None or rec.cell.config.get("work") != COUNTER or not rec.traced_window.steps:
        return None
    kernels = work.counter(rec.cell).CONV_KERNELS
    device_s = sum(t["kernel_s"].get(k, 0.0) for k in kernels)
    return device_s / rec.traced_window.steps if device_s else None


def read(rec):
    s = device_s_per_step(rec)
    return None if s is None else 1e3 * s
