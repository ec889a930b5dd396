"""Step timing.

Counterpart of gps_gaussian_tpu/utils/profiling.py `StepTimer` :19: an
exponential moving average of step latency on the host clock, with the
derived throughput. PyTorch returns before the device has finished, so
`stop` synchronises the device first; without that the clock would measure
the enqueue, not the step.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from gps_gaussian_tpu_torch.utils.device import resolve_device


class StepTimer:
    """EMA step timer with pairs/s throughput.

    `device`: the device the step runs on, CUDA unless the caller asks for
    the CPU; a CUDA device is synchronised before each reading of the
    clock."""

    def __init__(self, batch_size: int, alpha: float = 0.1, device="cuda"):
        self.batch_size = batch_size
        self.alpha = alpha
        self.device = resolve_device(device)
        self.ema_s: Optional[float] = None
        self._t0: Optional[float] = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        self._sync()
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is None:
            return
        self._sync()
        dt = time.perf_counter() - self._t0
        self.ema_s = (dt if self.ema_s is None
                      else self.alpha * dt + (1 - self.alpha) * self.ema_s)
        self._t0 = None

    @property
    def step_ms(self) -> float:
        return (self.ema_s or 0.0) * 1e3

    @property
    def pairs_per_s(self) -> float:
        return self.batch_size / self.ema_s if self.ema_s else 0.0
