"""The device's timeline over a traced stretch: its busy and idle time,
the operations that took most of it and what the host did in its gaps.

A stretch runs under ``torch.profiler`` twice.  With the device's activity
alone, busy time is the union of its kernel, copy and set intervals, so
overlapping streams count once, and idle is the rest of the stretch's
length on the host clock.  With the host's operations too (which slow the
host), each idle gap is named by the innermost host operation that
encloses its midpoint.  Annotations that host spans leave on the device's
timeline are not device work and do not count.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import torch

__all__ = ["Trace", "traced", "device_busy", "union_length", "gaps"]

_SPAN = "gpubench.stretch"
_TOP = 10


@dataclass
class Trace:
    window_s: float                       # the span's length
    busy_s: float                         # union of device intervals in it
    device_ops: list = field(default_factory=list)  # [[name, seconds]]
    idle_gaps: list = field(default_factory=list)   # [[host op, seconds]]

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    return sum(b - a for a, b in _merged(intervals, lo, hi))


def _merged(intervals, lo: float, hi: float) -> list:
    out: list = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def gaps(intervals, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for a, b in _merged(intervals, lo, hi):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def _name_gaps(spans, host) -> dict:
    """{host operation: idle seconds}: each gap under the shortest host
    operation (start, end, name) that encloses its midpoint, in one sweep
    over both sorted lists."""
    idle: dict = {}
    active: list = []
    i = 0
    for a, b in spans:
        mid = (a + b) / 2
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        name = (min(active, key=lambda h: h[1] - h[0])[2] if active
                else "python (no op)")
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    return idle


def _is_device(ev) -> bool:
    return ev.device_type != torch.autograd.DeviceType.CPU


def _device_work(events) -> list:
    """The kernels, copies and sets among ``events``: a host span (the
    optimizer's step, a stretch) also leaves an annotation on the device's
    timeline over what it launched, which is not device work."""
    host = {e.name for e in events if not _is_device(e)}
    return [e for e in events if _is_device(e)
            and not getattr(e, "is_user_annotation", False)
            and "annotation" not in str(getattr(e, "activity_type", ""))
            and e.name not in host and not e.name.startswith("Optimizer.")]


def _top(d: dict) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:_TOP]]


def device_busy(fn) -> tuple[float, float, list]:
    """Run ``fn`` under the profiler with the device's activity alone
    (little host overhead): the host clock's length of the run, the union
    of its device intervals in seconds, and those operations."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    with profile(activities=[ProfilerActivity.CUDA] if cuda
                 else [ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    dev = _device_work(list(prof.events()))
    iv = [(e.time_range.start, e.time_range.end) for e in dev]
    return window_s, union_length(iv, -math.inf, math.inf) / 1e6, dev


def traced(fn) -> Trace:
    """Run ``fn`` twice under the profiler.  The first run is
    ``device_busy``'s: busy time, the operations by device time, and the
    run's length.  The second records the host's operations too, inside a
    span, and names each idle gap of the device by what the host was
    doing."""
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.cuda.is_available()
    window_s, busy_s, dev = device_busy(fn)
    by_name: dict = {}
    for e in dev:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + (e.time_range.end - e.time_range.start) / 1e6)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(_SPAN):
            fn()
            if cuda:
                torch.cuda.synchronize()
    events = list(prof.events())
    span = [e for e in events if e.name == _SPAN and not _is_device(e)]
    if not span:
        raise RuntimeError("the profiler recorded no stretch span")
    lo, hi = span[0].time_range.start, span[0].time_range.end
    iv = [(e.time_range.start, e.time_range.end)
          for e in _device_work(events)]
    host = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in events if not _is_device(e) and e.name != _SPAN))
    return Trace(window_s=window_s, busy_s=busy_s, device_ops=_top(by_name),
                 idle_gaps=_top(_name_gaps(gaps(iv, lo, hi), host)))
