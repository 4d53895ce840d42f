"""Per-step wall time and device memory over a run.

Counterpart of ``psvi_tpu/utils/resource.py`` (ref ``psvi/inference/
utils.py:1752-1781``): the averages land in the results dict under the
reference's keys ``avg_epoch_time`` and ``gpu_memory`` (MiB).
"""

from __future__ import annotations

import time

import torch


class LogResource:
    def __init__(self, device: torch.device):
        self.device = device
        self.time_data = []
        self.memory_data = []
        self.prev_time = time.time()

    def update(self):
        now = time.time()
        self.time_data.append(now - self.prev_time)
        self.prev_time = now
        mem = torch.cuda.memory_allocated(self.device) if self.device.type == "cuda" else 0
        self.memory_data.append(mem / 2**20)

    def get_resources(self):
        n = max(len(self.time_data), 1)
        return {"time": sum(self.time_data) / n, "memory": sum(self.memory_data) / n}
