"""Imported first by every test module of the port: torch on the pytest
worker's share of the cores.

torch's intra-op pool defaults to one thread a core, so six xdist workers
on eight cores would run 48 spinning threads, beside XLA's own pools. Each
worker takes cores // workers (at least one), the rule that
``psvi_torch/parallel/distributed.py`` applies to gloo ranks; a run
without xdist keeps every core. It imports only ``os`` and ``torch``, so
it serves the card's runs (``--noconftest``, no JAX) too.
"""

import os

import torch

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))
