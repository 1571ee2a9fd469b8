"""The readings that a cell's limits are set from, over many seeds in one
process (set-up is paid once for the kernels' build):

* the program's compared numbers on each ``--seeds`` seed (set-up and a
  window of ``--seconds``, which the training cells need only for their
  first steps), with the readings that were set aside for them (every
  step's loss, the worst leaf);
* the control's on each ``--control-seeds`` seed, after the program's
  set-up and window (a training window's steps start from the program's
  state): each of the runner's ``CONTROLS`` in turn, the reference put in
  the program's place and computed in TF32, and the planted faults of the
  cell's kind (training: half of each batch left out and the rest's SSE
  doubled; screening: one answer altered).

    python3 -m gpubench.calibrate --workload <cell> --seeds 1 2 ... \\
        --control-seeds 7 8 9 --seconds 2

One JSON line a reading on standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import tempfile
from pathlib import Path

import torch

from . import card, run, spec


@contextlib.contextmanager
def _after_window(cell: str, seed: int, seconds: float, device: str,
                  config: dict | None, traffic: dict | None):
    """(context, runner) of one run of ``cell`` past its window, with the
    program's state freed; standard output goes to standard error while it
    is open.  ``config`` and ``traffic`` replace the cell's own (tests run
    a small copy on the CPU)."""
    bench = spec.benchmark()
    w = spec.workload(bench, cell)
    cfg = config or spec.config(bench, w["config"])
    trf = traffic or spec.traffic(w["traffic"])
    drv = spec.kind(trf["kind"])
    drv.check_config(cfg)
    dev = torch.device(device)
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(sys.stderr):
        ctx = run.Context(cell, seed, seconds, False, dev, cfg, trf,
                          Path(tmp), 0.0)
        drv.inputs(ctx)
        drv.setup(ctx)
        drv.window(ctx)
        ctx.program.clear()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        yield ctx, drv


def program(cell: str, seed: int, seconds: float, device: str = "cuda", *,
            config: dict | None = None, traffic: dict | None = None) -> dict:
    """The program's compared numbers on ``seed``, with their looks."""
    with _after_window(cell, seed, seconds, device, config, traffic) as (
            ctx, drv):
        numbers = drv.check(ctx, looks=True)
    return {"seed": seed, "program": numbers,
            "failed": ctx.window["failed"]}


def controls(cell: str, seed: int, seconds: float, device: str = "cuda", *,
             config: dict | None = None, traffic: dict | None = None):
    """(variant, its numbers with their looks) for each of the runner's
    ``CONTROLS`` on ``seed``, in its order."""
    with _after_window(cell, seed, seconds, device, config, traffic) as (
            ctx, drv):
        for variant in drv.CONTROLS:
            yield variant, drv.control(ctx, variant, looks=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    card.require_cards(spec.workload(spec.benchmark(), args.workload)
                       ["chips"])
    print(f"gpubench: card {card.card_name()}, power limit "
          f"{card.power_limit()}", file=sys.stderr)
    for seed in args.seeds:
        print(json.dumps(program(args.workload, seed, args.seconds)),
              flush=True)
    for seed in args.control_seeds:
        for variant, numbers in controls(args.workload, seed, args.seconds):
            print(json.dumps({"seed": seed, variant: numbers}),
                  file=sys.__stdout__, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
