"""The memory the plain nested step's differentiated unroll leaves on the
card for the reverse, in GiB: the program's counter
``psvi_torch.inference.psvi.UNROLL["resident_bytes"]`` (allocated after the
unroll less before it) at the last step the run made. Nothing where the
program has no such counter or ran no differentiated unroll."""


def read(rec):
    try:
        from psvi_torch.inference.psvi import UNROLL
    except ImportError:
        return None
    if rec.trace is None or not UNROLL.get("iterations") or not UNROLL.get("resident_bytes"):
        return None
    return UNROLL["resident_bytes"] / 2**30
