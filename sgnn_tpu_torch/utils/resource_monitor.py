"""Wall-time + device-memory bracketing around a region.

Port of ``sgnn_tpu/utils/resource_monitor.py``: peak memory from
``torch.cuda.max_memory_allocated`` on a CUDA device, 0 on the CPU.
``stop`` synchronises the device first, so the elapsed time covers the
queued work.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from sgnn_tpu_torch.utils.device import Device


class ResourceMonitor:
    def __init__(self, device: Device = "cpu"):
        self.device = torch.device(device)
        self._start: Optional[float] = None

    @property
    def _cuda(self) -> bool:
        return self.device.type == "cuda"

    def start(self):
        if self._cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self._start = time.perf_counter()

    def stop(self) -> dict:
        if self._cuda:
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - self._start if self._start is not None else 0.0
        self._start = None
        peak = torch.cuda.max_memory_allocated(self.device) / 1e6 if self._cuda else 0.0
        return {"elapsed_time": elapsed, "max_memory_mb": peak}

    def get_current_memory(self) -> float:
        """MB of device memory allocated now (0 on the CPU)."""
        return torch.cuda.memory_allocated(self.device) / 1e6 if self._cuda else 0.0
