"""Device ms per step of every kernel outside the LeNet kernel pair in the
traced window: the outer IW-ELBO and its gradient through autograd and
cuDNN, the draws, the hyper update and the evaluations, spread over the
steps. Read only where the pair ran (its kernels are listed in
``portbench/work_counts/lenet.py``)."""

from portbench import work


def read(rec):
    t = rec.trace
    if t is None or rec.cell.config.get("work") != "lenet" or not rec.traced_window.steps:
        return None
    pair = sum(t["kernel_s"].get(k, 0.0) for k in work.counter(rec.cell).KERNELS)
    if not pair:
        return None
    return 1e3 * (sum(t["kernel_s"].values()) - pair) / rec.traced_window.steps
