"""The numbers that decide ``correct`` in a geometry cell beside
``compare.py``'s ``pred_gap``:

``descriptor_gap``  the largest |program - reference| of any descriptor of
                    any atom of the structures the window's last request
                    ran, over the largest |reference| among them;
``pred_gap_row``    the largest |program - reference| of any row of any
                    request, over the larger of that row's |reference| and
                    the median row's.

Why a row's own scale beside ``pred_gap``: on drawn weights a few rows'
predictions are hundreds of times the median row's, so ``pred_gap``, over
the largest, lets a fault that moves ordinary rows by whole units pass (a
wrong atom order for some rows, say); the median's floor keeps a row whose
prediction lies near 0 from reading its rounding as a fault.

The program's descriptors are those its timed path wrote, window by
window, in the window's structure order (rows in slot order, reactant, TS
and product each); the reference's are one [n, D] array a structure, in
(row, structure) order.
"""

from __future__ import annotations

import numpy as np

__all__ = ["program_blocks", "descriptor_gap", "row_prediction_gap"]


def program_blocks(windows, ref: list) -> list:
    """(program [n, D], reference [n, D]) of every structure of the kept
    windows: each window is (rows in slot order, structure offsets [3B +
    1], descriptors [atoms, D]).  No window gives one pair of an empty
    program block against nothing (which compares as infinite)."""
    pairs = []
    for rows, ptr, desc in windows:
        for p, row in enumerate(rows):
            for k in range(3):
                lo, hi = ptr[3 * p + k], ptr[3 * p + k + 1]
                pairs.append((desc[lo:hi], ref[3 * int(row) + k]))
    return pairs or [(np.zeros((0, 0)), None)]


def descriptor_gap(pairs) -> float:
    """Over every (program, reference) pair."""
    if any(r is None for _, r in pairs):
        return float("inf")
    scale = max(max(float(np.abs(r).max()) for _, r in pairs), 1e-30)
    worst = 0.0
    for prog, r in pairs:
        prog = np.asarray(prog, np.float64)
        if prog.shape != r.shape or not np.isfinite(prog).all():
            return float("inf")
        worst = max(worst, float(np.abs(prog - r).max()))
    return worst / scale


def row_prediction_gap(requests: list, ref: np.ndarray) -> float:
    """Over every request's predictions (row order)."""
    ref = np.asarray(ref, np.float64)
    scale = np.maximum(np.abs(ref), max(float(np.median(np.abs(ref))),
                                        1e-30))
    worst = 0.0
    for preds in requests:
        preds = np.asarray(preds, np.float64)
        if preds.shape != ref.shape or not np.isfinite(preds).all():
            return float("inf")
        worst = max(worst, float((np.abs(preds - ref) / scale).max()))
    return worst
