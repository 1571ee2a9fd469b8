"""Run one cell of ``BENCHMARK.json`` once and print its result.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

A run: the inputs and weights from the seed; the program's set-up, which
warms every shape the cell uses (``setup_s`` is the process's start to the
window's start); the measured window; the peak memory; with ``--trace 1``
a traced stretch of the same work after the window and the per-layer
readers; the program's state freed; then the comparison with the plain
reference that decides ``correct``.  The last line of standard output is
the result's JSON; the compared numbers and their limits are the last lines
of standard error and the result's last key.  Without the cards the cell
asks for, or with a JAX module loaded once the window has closed, the run
exits with a code other than 0 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

# the program's and torch's kernel caches at fixed paths in the checkout,
# set before torch loads
_CACHE = Path(__file__).resolve().parent.parent / ".gpubench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(_CACHE / "cuda")

import torch  # noqa: E402

from . import card, spec  # noqa: E402
from .trace import Trace, traced  # noqa: E402

__all__ = ["Context", "run_cell", "main"]


@dataclass
class Context:
    """One run: its cell and settings, what the benchmark made (handed to
    the program and the reference alike), the program's objects, what the
    program produced that is compared, and the window's counts."""
    cell: str
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    config: dict
    traffic: dict
    tmp: Path
    t_start: float
    inputs: dict = field(default_factory=dict)
    program: dict = field(default_factory=dict)
    out: dict = field(default_factory=dict)
    window: dict = field(default_factory=dict)
    setup_s: float = 0.0
    memory_peak_bytes: int = 0
    traced: Trace | None = None
    phases: dict = field(default_factory=dict)

    def mark(self, phase: str) -> None:
        """Record the host seconds since the last mark (or the process's
        start) under ``phase``."""
        self.phases[phase] = (time.time() - self.t_start
                              - sum(self.phases.values()))


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", *, bench: dict | None = None,
             config: dict | None = None, traffic: dict | None = None,
             limits: dict | None = None, t_start: float | None = None
             ) -> dict:
    """The result of one run of ``cell``; ``config``, ``traffic`` and
    ``limits`` replace the cell's own (tests run a small copy on the
    CPU)."""
    bench = bench or spec.benchmark()
    w = spec.workload(bench, cell)
    cfg = config or spec.config(bench, w["config"])
    trf = traffic or spec.traffic(w["traffic"])
    lim = limits or spec.limits(cell)
    drv = spec.kind(trf["kind"])
    drv.check_config(cfg)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    with tempfile.TemporaryDirectory(prefix="gpubench-") as tmp, \
            contextlib.redirect_stdout(sys.stderr):
        ctx = Context(cell, int(seed), float(seconds), bool(trace), dev, cfg,
                      trf, Path(tmp), t_start or card.process_start())
        ctx.mark("start")
        drv.inputs(ctx)
        ctx.mark("inputs")
        drv.setup(ctx)
        if cuda:
            torch.cuda.synchronize(dev)
        ctx.mark("setup")
        ctx.setup_s = time.time() - ctx.t_start
        drv.window(ctx)
        ctx.mark("window")
        if cuda:
            ctx.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
        if trace:
            ctx.traced = traced(lambda: drv.stretch(ctx))
            ctx.mark("stretch")
        values = {}
        for m in spec.metrics_of(bench, cell, trace):
            v = spec.reader(m["name"]).read(ctx)
            if v is not None:
                values[m["name"]] = {"value": float(v), "unit": m["unit"]}
        ctx.program.clear()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        ctx.mark("readers")
        numbers = drv.check(ctx)
        ctx.mark("check")
        print("gpubench: host seconds " + ", ".join(
            f"{k} {v:.3f}" for k, v in ctx.phases.items()), file=sys.stderr)
        print("gpubench: window " + ", ".join(
            f"{k} {v!r}" for k, v in ctx.window.items()
            if not isinstance(v, list)), file=sys.stderr)
    checks = {k: {"value": float(v), "limit": lim[k]}
              for k, v in numbers.items()}
    correct = (ctx.window["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))
    result = {"correct": correct, "attempted": ctx.window["attempted"],
              "failed": ctx.window["failed"], "metrics": values,
              "device": _device(ctx, w["chips"])}
    if ctx.traced is not None:
        result["breakdown"] = {"device_ops": ctx.traced.device_ops,
                               "idle_gaps": ctx.traced.idle_gaps}
    result["checks"] = checks
    return result


def _device(ctx: Context, chips: int) -> dict:
    cuda = ctx.device.type == "cuda"
    out = {"platform": "gpu" if cuda else "cpu",
           "kind": card.card_name() if cuda else "cpu", "count": chips,
           "memory_peak_bytes": ctx.memory_peak_bytes}
    if ctx.traced is not None:
        out["busy_s"] = ctx.traced.busy_s
        out["window_s"] = ctx.traced.window_s
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = card.process_start()
    bench = spec.benchmark()
    chips = spec.workload(bench, args.workload)["chips"]
    card.require_cards(chips)
    print(f"gpubench: card {card.card_name()}, power limit "
          f"{card.power_limit()}, {chips} of {torch.cuda.device_count()}",
          file=sys.stderr)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), bench=bench, t_start=t_start)
    found = card.forbidden_modules()
    if found:
        print(f"gpubench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
