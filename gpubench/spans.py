"""The program's own spans and counters over one more stretch of a cell's
work, for the readers of ``program_span`` and ``program_counter`` metrics.

:func:`stretch` runs the cell's ``stretch`` once (5 epochs, or 3 requests)
inside the program's ``utils.tracing.span_log()``, with its
``counters()`` read before and after, and keeps the result on
``ctx.program``, so that every reader of one run shares one stretch.  A
program without ``utils/tracing.py`` gives None, as does a stretch in
which the program opened none of the spans a reader asks for."""

from __future__ import annotations

import torch

from . import spec

__all__ = ["stretch", "mean_s"]

_KEY = "gpubench.spans"


def stretch(ctx) -> dict | None:
    """{"summary": the span log's summary, "counters": each counter's
    growth over the stretch}, or None without the program's tracing."""
    if _KEY not in ctx.program:
        ctx.program[_KEY] = _run(ctx)
    return ctx.program[_KEY]


def _run(ctx) -> dict | None:
    try:
        from cgr_mpnn_3d_tpu_torch.utils import tracing
    except ImportError:
        return None
    runner = spec.runner(ctx)
    before = tracing.counters()
    with tracing.span_log() as log:
        runner.stretch(ctx)
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
    after = tracing.counters()
    return {"summary": log.summary(),
            "counters": {k: v - before.get(k, 0) for k, v in after.items()}}


def mean_s(ctx, name: str) -> float | None:
    """The mean seconds of span ``name`` over the stretch, or None."""
    got = stretch(ctx)
    s = None if got is None else got["summary"].get(name)
    return None if not s else s["total_s"] / s["count"]
