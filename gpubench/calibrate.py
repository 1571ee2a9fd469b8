"""The readings that a cell's limits are set from, over many seeds in one
process (set-up is paid once for the kernels' build):

* the program's compared numbers on each ``--seeds`` seed (set-up and a
  window of ``--seconds``, which the training cells need only for their
  first steps), with the readings that were set aside for them (every
  step's loss, the worst leaf);
* the control's on each ``--control-seeds`` seed, after the program's
  set-up and window (a training window's steps start from the program's
  state): the reference put in the program's place, computed in TF32, and
  the planted faults of the cell's kind (training: half of each batch left
  out and the rest's SSE doubled; screening: one answer altered).

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

VARIANTS = {"train_staged": ("tf32", "half"), "screen": ("tf32", "alter")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    w = spec.workload(bench, args.workload)
    card.require_cards(w["chips"])
    print(f"gpubench: card {card.card_name()}, power limit "
          f"{card.power_limit()}", file=sys.stderr)
    trf = spec.traffic(w["traffic"])
    drv = spec.kind(trf["kind"])
    cfg = spec.config(bench, w["config"])
    dev = torch.device("cuda")
    for seed in args.seeds:
        with tempfile.TemporaryDirectory() as tmp, \
                contextlib.redirect_stdout(sys.stderr):
            ctx = run.Context(args.workload, seed, args.seconds, False, dev,
                              cfg, trf, Path(tmp), 0.0)
            drv.inputs(ctx)
            drv.setup(ctx)
            drv.window(ctx)
            ctx.program.clear()
            gc.collect()
            torch.cuda.empty_cache()
            numbers = drv.check(ctx, looks=True)
        print(json.dumps({"seed": seed, "program": numbers,
                          "failed": ctx.window["failed"]}), flush=True)
    for seed in args.control_seeds:
        with tempfile.TemporaryDirectory() as tmp, \
                contextlib.redirect_stdout(sys.stderr):
            ctx = run.Context(args.workload, seed, args.seconds, False, dev,
                              cfg, trf, Path(tmp), 0.0)
            drv.inputs(ctx)
            drv.setup(ctx)
            drv.window(ctx)
            ctx.program.clear()
            gc.collect()
            torch.cuda.empty_cache()
            for variant in VARIANTS[trf["kind"]]:
                line = json.dumps({"seed": seed, variant: drv.control(
                    ctx, variant, looks=True)})
                print(line, file=sys.__stdout__, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
