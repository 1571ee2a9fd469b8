"""The card: its presence, name and power limit, CUDA-event and host
timing, the process's start, and the check that no JAX module was loaded.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

__all__ = ["require_cards", "card_name", "power_limit", "time_ms",
           "host_ms", "process_start", "forbidden_modules", "FORBIDDEN"]

# top-level module names no run may load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "cgr_mpnn_3d_tpu")


def require_cards(n: int) -> None:
    """Raise SystemExit unless ``n`` CUDA cards are present."""
    if not torch.cuda.is_available():
        raise SystemExit("gpubench: no CUDA card (torch.cuda.is_available() "
                         "is false); there is no CPU fallback")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"gpubench: the cell needs {n} cards, "
                         f"{torch.cuda.device_count()} present")


def card_name() -> str:
    return torch.cuda.get_device_name(0)


def power_limit() -> str:
    """The power limit nvidia-smi reads for card 0, or "unknown"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
        return out.splitlines()[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def time_ms(fn, n: int) -> float:
    """Mean ms of ``fn`` over ``n`` calls between two CUDA events, after
    one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def host_ms(fn, min_s: float = 0.3) -> float:
    """Mean host ms of ``fn`` (which synchronizes itself) over as many
    calls as fill ``min_s`` seconds, after one warm call."""
    fn()
    n, t0 = 0, time.perf_counter()
    while True:
        fn()
        n += 1
        dt = time.perf_counter() - t0
        if dt >= min_s:
            return dt * 1e3 / n


def process_start() -> float:
    """The time (epoch seconds) at which this process started, from
    /proc; the module's import time where /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return _IMPORTED


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


_IMPORTED = time.time()
