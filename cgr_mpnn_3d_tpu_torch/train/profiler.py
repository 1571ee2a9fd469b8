"""Step timing: :class:`StepTimer`, wall-clock step statistics (mean, p50,
p99, steps/s) for the metrics log.

The counterpart of ``cgr_mpnn_3d_tpu/train/profiler.py::StepTimer``; its
``trace`` context (a profiler trace of the wrapped steps) is not ported yet.
A step's time is the host's time between two ticks, which includes waiting
for the card: the trainer reads each step's loss on the host (with
``steps_per_call`` each chunk's losses, with ``device_epoch`` each epoch's,
and the interval is split evenly among its steps).
"""

from __future__ import annotations

import time

import numpy as np

__all__ = ["StepTimer"]


class StepTimer:
    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: list[float] = []
        self._last: float | None = None
        self._count = 0

    def tick(self, steps: int = 1) -> None:
        """``steps`` steps ended now: the time since the last tick, split
        evenly among them (a chunk of steps, or a staged epoch, reads its
        losses once, so its steps have no host timestamps of their own)."""
        now = time.perf_counter()
        if self._last is not None:
            for _ in range(steps):
                self._count += 1
                if self._count > self.warmup:
                    self._times.append((now - self._last) / steps)
        self._last = now

    def reset_epoch(self) -> None:
        self._last = None

    def stats(self) -> dict:
        if not self._times:
            return {}
        t = np.asarray(self._times)
        return {
            "step_time_mean_s": float(t.mean()),
            "step_time_p50_s": float(np.percentile(t, 50)),
            "step_time_p99_s": float(np.percentile(t, 99)),
            "steps_per_s": float(1.0 / t.mean()),
        }
