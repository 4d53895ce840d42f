"""Each configuration's work counter, found by name, and the roofline's
least time.

A configuration names its counter by ``"work": "<name>"``;
``portbench/work_counts/<name>.py`` counts the operations and bytes of
its step from the configuration's shapes alone, whatever runs the step.
A configuration that names none, or names a file that is not there, raises.
"""

from __future__ import annotations

from pathlib import Path

HERE = Path(__file__).resolve().parent


def counter(cell):
    """The work counter the cell's configuration names."""
    from portbench.harness import load_module

    name = cell.config.get("work")
    path = HERE / "work_counts" / f"{name}.py"
    if not name or not path.exists():
        raise ValueError(f"the configuration of {cell.name} names no work counter "
                         f"under portbench/work_counts/ ({name!r})")
    return load_module(path)


def bound_s(ops: float, byts: float, peak_flops: float, peak_bytes: float) -> float:
    """The least time the chip could take: the larger of the operations at
    the peak rate and the bytes at the peak bandwidth."""
    return max(ops / peak_flops, byts / peak_bytes)
