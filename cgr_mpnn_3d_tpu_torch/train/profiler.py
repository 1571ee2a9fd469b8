"""Tracing and step timing (the counterpart of
``cgr_mpnn_3d_tpu/train/profiler.py``):

* :func:`trace` -- a ``torch.profiler`` session around the enclosed block,
  written as a Chrome trace (CPU activity, and CUDA activity where a card
  is present) into ``log_dir``; it prints where it wrote it.
* :class:`StepTimer` -- wall-clock step statistics (mean, p50, p99,
  steps/s) for the metrics log.  A step's time is the host's time between
  two ticks, which includes waiting for the card: the trainer reads each
  step's loss on the host (with ``steps_per_call`` each chunk's losses,
  with ``device_epoch`` each epoch's, and the interval is split evenly
  among its steps).

The program's own spans (``train.step``, ``ops.k2``, ``predict.pack``, ...)
live in ``utils/tracing.py``: under :func:`trace` they are
``record_function`` events of the same Chrome trace, on the clock of the
card's activity; ``utils.tracing.span_log()`` sums them without a
profiler.

A second profiler session in one process has been seen to lose the card's
kernel records (the runtime's launch calls stay), so a check that a trace
holds a kernel runs the trace in a fresh process.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

import numpy as np

__all__ = ["trace", "StepTimer"]


@contextlib.contextmanager
def trace(log_dir: str = "torch-trace", enabled: bool = True):
    """Profile the enclosed block: ``with trace("runs/trace"): step(...)``
    writes ``log_dir/trace-<pid>-<ms>.json``.  With ``enabled`` False it
    does nothing."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = out / f"trace-{os.getpid()}-{int(time.time() * 1e3)}.json"
    prof.export_chrome_trace(str(path))
    print(f"[profiler] trace written to {path}")


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
