"""The numbers that decide ``correct``, each the gap between what the
program produced and what the reference computed.

Training, over two stretches of three steps each: the run's first steps
from the initial weights, and the window's first steps from the state the
window starts from.  Each number is the larger of the two stretches':

* ``loss_gap``        |SSE_prog - SSE_ref| / |SSE_ref| of the first step;
* ``grad_gap_worst``  the largest, over every leaf, of the gap between the
                      norms of the program's and the reference's first
                      gradient (as the optimizer got it), over the larger
                      of the reference leaf's norm and the median leaf's;
* ``head_grad_gap``   the same over the head's two leaves (``ffn.w``,
                      ``ffn.b``) alone;
* ``update_gap``      the median over the leaves of the same gap of the
                      parameters' change over the three steps, over the
                      leaves whose first reference gradient is at least a
                      thousandth of the median leaf's (a leaf with a
                      gradient nought to rounding moves under Adam by
                      round-off alone).

Why the head apart, and not every step's loss and the worst leaf's change
(``training_looks`` gives those): a ReLU input within rounding of 0 takes
its sign from the order of a sum, so on a few seeds in a hundred two sound
float32 programs differ by one element's derivative (against float64 now
one side, now the other).  That moves the gradient of every leaf upstream
of the element by up to 4e-5 of its norm, and Adam turns a gradient
element near 0 into a full step of either sign, which moves the later
steps' losses.  The first step's loss and the head's gradient are
continuous where a ReLU input crosses 0 (the output passes through 0), so
they take a tight limit; the worst leaf's gradient takes one above the
4e-5, which still fails a leaf's gradient off by a factor; the median
leaf's change is steady.

Screening: ``pred_gap``, the largest |prediction - reference| of any row
of any request, over the largest |reference|.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

__all__ = ["training_gaps", "training_looks", "prediction_gap"]


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _leaf_gaps(prog: dict, ref: dict, names) -> list:
    r = {n: _norm(ref[n]) for n in names}
    med = statistics.median(r.values())
    return [abs(_norm(prog[n]) - r[n]) / max(r[n], med, 1e-30)
            for n in names]


def _parts(prog: dict, ref: dict, p0: dict) -> tuple:
    losses = [abs(float(a) - b) / max(abs(b), 1e-30)
              for a, b in zip(prog["losses"], ref["losses"], strict=True)]
    names = list(ref["g1"])
    g = {n: _norm(ref["g1"][n]) for n in names}
    gmed = statistics.median(g.values())
    moved = [n for n in names if g[n] >= 1e-3 * gmed]
    dp = {n: prog["p"][n].double() - p0[n].double() for n in moved}
    dr = {n: ref["p"][n].double() - p0[n].double() for n in moved}
    return (losses, dict(zip(names, _leaf_gaps(prog["g1"], ref["g1"],
                                               names))),
            _leaf_gaps(dp, dr, moved))


def training_gaps(prog: dict, ref: dict, p0: dict) -> dict:
    """The compared numbers of one stretch.  ``prog`` and ``ref``:
    {"losses", "g1", "p"}; ``p0``: the parameters the stretch starts
    from."""
    losses, grads, updates = _parts(prog, ref, p0)
    return {"loss_gap": losses[0], "grad_gap_worst": max(grads.values()),
            "head_grad_gap": max(v for n, v in grads.items()
                                 if n.startswith("ffn.")),
            "update_gap": statistics.median(updates)}


def training_looks(prog: dict, ref: dict, p0: dict) -> dict:
    """Every step's loss gap, the median leaf's gradient gap and the worst
    leaf's change gap of one stretch, for the record."""
    losses, grads, updates = _parts(prog, ref, p0)
    return {"loss_gaps": losses,
            "grad_gap_median": statistics.median(grads.values()),
            "update_gap_worst": max(updates)}


def prediction_gap(requests: list, ref: np.ndarray) -> float:
    """Over every request's predictions (row order)."""
    scale = max(float(np.abs(ref).max()), 1e-30)
    worst = 0.0
    for preds in requests:
        preds = np.asarray(preds, np.float64)
        if preds.shape != ref.shape or not np.isfinite(preds).all():
            return float("inf")
        worst = max(worst, float(np.abs(preds - ref).max()) / scale)
    return worst
