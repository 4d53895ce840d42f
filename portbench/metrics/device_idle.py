"""The share of the traced window, in %, in which no kernel, copy or set
ran on the card."""


def read(rec):
    t = rec.trace
    if t is None or not t["window_s"] or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
