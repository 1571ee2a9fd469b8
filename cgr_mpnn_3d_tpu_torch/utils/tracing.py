"""Spans and counters at the port's layer boundaries.

* :func:`span` -- ``with span("train.step"): ...`` names a stretch of host
  time.  Off (no ``torch.profiler`` session recording and no span log
  open) it reads two module flags and returns one shared object that does
  nothing.  Under a profiler session (``train.profiler.trace``, or any
  other) it enters ``torch.profiler.record_function(name)``, so that the
  span lies in the profiler's timeline on the clock of the card's
  activity, its attributes passed as the record's argument string
  (``"request=3"``); inside :func:`span_log` it appends the span's name,
  start and end (``time.perf_counter_ns``), parent and attributes to the
  log.
* :func:`span_log` -- ``with span_log() as log: ...``; ``log.summary()``
  gives ``{name: {"count", "total_s", "self_s"}}``, self time being a
  span's duration less what its children cover.  The spans stay in
  memory; nothing is written.
* counters, always on (integer adds): ``copy_in_bytes``, the bytes of host
  arrays put on the run's device (``data.batch.device_tensor``, the
  trainer's seeds, host drop tables); ``copy_out_bytes``, the bytes read
  back from it (``predict``'s predictions, the trainer's loss reads, a
  checkpoint's leaves); ``staged_bytes``, a gauge: the size of the staged
  epoch; ``pack_windows`` and ``pack_probes``, the windows the native
  packer packed and its placement attempts (``data.PackedLoader``: a
  window, a reused epoch, and the probes of ``plan_windows``), whose ratio
  says how often a window shrinks; ``mace_structures``, ``mace_atoms`` and
  ``mace_edges``, the structures, atoms and edges within the cutoff that
  ``models.MACE.descriptors`` ran.  On the CPU the same copies count, the
  CPU being the run's device.  :func:`counters` is a snapshot of these and
  of the kernels' launch counters (``ops._launch.launch_counts``).

The spans the program opens:

========================  ==============================================
``train.run``             ``RxnGraphTrainer.train``: the whole loop
``train.epoch``           one epoch's steps (attribute ``epoch``)
``train.stage``           the staged epoch's build (once)
``train.snapshot``        the rollback snapshot's device copies
``train.step``            one step: the gradients and ``optimizer.step()``
``train.readback``        a loss read to the host
``train.validate``        a validation pass
``train.save``            a checkpoint's write
``model.grads``           ``models.fused_train_value_and_grad``
``ops.k2``, ``ops.k3b``,  the whole-model kernels' wrappers: checks, drop
``ops.k3f``               table and launch
``predict.request``       one ``predict`` call (attribute ``request``, a
                          process-wide id its children carry)
``predict.pack``          one ``next()`` of the loader
``predict.copy``          a batch's copy to the device
``predict.forward``       ``apply`` on it
``predict.readback``      its predictions read back
``predict.order``         the row order restored
``predict.geometry``      a window's structures laid out from the
                          dataset's geometry tables and copied
``predict.descriptors``   the descriptors written into the packed node
                          features on the device
``mace.forward``          ``models.MACE.descriptors``: one window's MACE
``ops.mace_interaction``, the MACE kernels' wrappers: checks and launch
``ops.mace_product``
========================  ==============================================
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

__all__ = ["span", "span_log", "SpanLog", "Record", "counters",
           "count_copy_in", "count_copy_out", "count_pack", "count_mace",
           "set_staged_bytes", "next_request_id"]

# the open span log, if any (the profiler's own flag is torch's)
_LOG: SpanLog | None = None

_COUNTS = {"copy_in_bytes": 0, "copy_out_bytes": 0, "staged_bytes": 0,
           "pack_windows": 0, "pack_probes": 0, "mace_structures": 0,
           "mace_atoms": 0, "mace_edges": 0}
_REQUESTS = itertools.count(1)


class _Off:
    """The span of a run that traces nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_OFF = _Off()


def span(name: str, **attrs):
    """A context manager naming the enclosed host time ``name``; see the
    module doc."""
    if _LOG is None and not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, attrs)


class _Span:
    __slots__ = ("name", "attrs", "_rf", "_log", "_rec")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self._rf = None
        if _profiler._is_profiler_enabled:
            args = ",".join(f"{k}={v}" for k, v in self.attrs.items())
            self._rf = torch.profiler.record_function(self.name,
                                                      args or None)
            self._rf.__enter__()
        self._log = _LOG
        if self._log is not None:
            self._rec = self._log._open(self.name, self.attrs)
        return self

    def __exit__(self, *exc):
        if self._log is not None:
            self._log._close(self._rec)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return None


class Record:
    """One span of a log: ``parent`` is the index of the span that was open
    around it on its thread (-1 for none); ``end`` is 0 while it is
    open."""
    __slots__ = ("name", "start", "end", "parent", "attrs")

    def __init__(self, name, start, parent, attrs):
        self.name, self.start, self.end = name, start, 0
        self.parent, self.attrs = parent, attrs

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


class SpanLog:
    """The spans opened while the log was open, in the order they
    opened."""

    def __init__(self):
        self.records: list[Record] = []
        self._stacks: dict = {}      # thread id -> indices of open spans

    def _open(self, name: str, attrs: dict) -> int:
        stack = self._stacks.setdefault(threading.get_ident(), [])
        i = len(self.records)
        self.records.append(Record(name, time.perf_counter_ns(),
                                   stack[-1] if stack else -1, attrs))
        stack.append(i)
        return i

    def _close(self, i: int) -> None:
        self.records[i].end = time.perf_counter_ns()
        self._stacks[threading.get_ident()].pop()

    def named(self, name: str) -> list[Record]:
        return [r for r in self.records if r.name == name]

    def summary(self) -> dict:
        """{name: {"count", "total_s", "self_s"}} over the closed spans;
        self time is the duration less the children's."""
        done = [r for r in self.records if r.end]
        children = [0] * len(self.records)
        for r in done:
            if r.parent >= 0:
                children[r.parent] += r.end - r.start
        out: dict = {}
        for i, r in enumerate(self.records):
            if not r.end:
                continue
            s = out.setdefault(r.name, {"count": 0, "total_s": 0.0,
                                        "self_s": 0.0})
            s["count"] += 1
            s["total_s"] += r.seconds
            s["self_s"] += (r.end - r.start - children[i]) / 1e9
        return out


@contextlib.contextmanager
def span_log():
    """Log every span opened inside the block (this process, every
    thread); an inner log takes the spans from an outer one until it
    closes."""
    global _LOG
    outer, _LOG = _LOG, SpanLog()
    try:
        yield _LOG
    finally:
        _LOG = outer


def next_request_id() -> int:
    """A request id, unique in this process."""
    return next(_REQUESTS)


def count_copy_in(nbytes: int) -> None:
    _COUNTS["copy_in_bytes"] += nbytes


def count_copy_out(nbytes: int) -> None:
    _COUNTS["copy_out_bytes"] += nbytes


def count_pack(windows: int, probes: int) -> None:
    _COUNTS["pack_windows"] += windows
    _COUNTS["pack_probes"] += probes


def count_mace(structures: int, atoms: int, edges: int) -> None:
    _COUNTS["mace_structures"] += structures
    _COUNTS["mace_atoms"] += atoms
    _COUNTS["mace_edges"] += edges


def set_staged_bytes(nbytes: int) -> None:
    _COUNTS["staged_bytes"] = nbytes


def counters() -> dict:
    """A snapshot of the copy and pack counters, the staged gauge and every
    nonzero kernel launch counter (``{"fused_model.train_launches": n,
    ...}``)."""
    from ..ops._launch import launch_counts
    return {**_COUNTS, **launch_counts()}
