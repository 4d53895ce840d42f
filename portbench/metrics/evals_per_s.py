"""ELBO-gradient evaluations per second over the window: every step does
T inner-loss gradients and one outer one, so steps·(T+1) over the window's
wall seconds, the evaluations every ``log_every`` steps included."""


def read(rec):
    w = rec.window
    if not w.seconds or not w.steps:
        return None
    return w.steps * (rec.cell.config["engine"]["inner_it"] + 1) / w.seconds
