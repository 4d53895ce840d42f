"""Parallelism: the ('trial', 'data', 'mc') mesh over processes
(``mesh.py``), the process group and its launchers (``distributed.py``) and
trial-parallel runs (``trials.py``)."""

from psvi_torch.parallel.mesh import batch_sharding, make_mesh, replicated
from psvi_torch.parallel.trials import TrialParallelPSVI, run_trials

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated",
    "TrialParallelPSVI",
    "run_trials",
]
