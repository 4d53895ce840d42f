"""Set-up: from the process's start (imports, data, the engine, the first
build of the CUDA libraries where the checkout has none, the checked and
warm steps) to the window's start, by the host clock."""


def read(rec):
    return rec.setup_s
