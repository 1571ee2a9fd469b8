"""What the reference computes for a cell: the first steps of a training
run, and the predictions of a screen, from the inputs the benchmark made.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .chem import RxnGraph
from .model import (adam_amsgrad, forward, graph_set, sse_and_grads,
                    step_seeds)
from .pack import epoch_order, geometry, plan_windows, staged_order

__all__ = ["featurize", "first_steps", "predictions"]


@contextlib.contextmanager
def _fixed_order():
    """Every sum in a fixed order, on the card too: ``index_add_`` and the
    gathers' gradients otherwise add by atomics, in an order that changes
    from run to run, so a ReLU input within rounding of 0 would change its
    sign between two runs of one seed."""
    mode = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(mode, warn_only=warn)


def featurize(smiles: list[str]) -> list:
    """Each row's CGR graph, every distinct SMILES featurized once."""
    graphs = {s: RxnGraph(s).arrays for s in dict.fromkeys(smiles)}
    return [graphs[s] for s in smiles]


def first_steps(smiles, feats, labels, weights: dict, hp: dict, seed: int,
                device, steps: int = 3, tf32: bool = False,
                half: bool = False, epoch: int = 0,
                adam: dict | None = None) -> dict:
    """The first ``steps`` steps of staged epoch ``epoch`` from the
    parameters ``weights`` and, past epoch 0, the Adam state ``adam``
    ({name: [m, v, vmax]}, after ``epoch`` whole epochs of steps):
    {"losses": [SSE a step], "g1": the first step's gradients,
    "p": the parameters after the last step}.  ``hp`` holds depth,
    dropout, lr, gamma, weight_decay, betas, eps, batch_size and the pack
    tile te, tn, tb; the epoch runs at lr * gamma**epoch, with the dropout
    seeds of the steps after ``epoch`` whole epochs.  ``half`` leaves out
    the later half of every batch and doubles the rest's SSE (a fault the
    comparison must catch)."""
    graphs = featurize(smiles)
    geo = geometry(graphs, hp["te"], hp["tn"], hp["tb"], hp["batch_size"])
    plan = plan_windows(epoch_order(len(graphs), seed), graphs.__getitem__,
                        geo, hp["batch_size"])
    order = staged_order(len(plan), seed, epoch)
    depth = hp["depth"]
    rates = [hp["dropout"]] * depth
    lr = hp["lr"] * hp["gamma"] ** epoch
    w = {n: t.detach().clone().float() for n, t in weights.items()}
    first = epoch * len(plan)
    state = {n: [s.detach().clone().float() for s in v]
             for n, v in (adam or {}).items()}
    out = {"losses": []}
    with _fixed_order():
        for k in range(steps):
            batch = plan[order[k]]
            if half:
                batch = batch[:(len(batch) + 1) // 2]
            rows = [r for r, _, _ in batch]
            gs = graph_set([graphs[r] for r in rows],
                           None if feats is None else [feats[r] for r in rows],
                           np.asarray(labels)[rows], device,
                           [(pk, off) for _, pk, off in batch])
            loss, grads = sse_and_grads(
                w, gs, depth, step_seeds(seed, first + k, depth),
                rates, tf32)
            if half:
                loss, grads = 2 * loss, {n: 2 * g for n, g in grads.items()}
            out["losses"].append(loss)
            adam_amsgrad(w, grads, state, first + k + 1, lr,
                         hp["weight_decay"], tuple(hp["betas"]), hp["eps"])
            if k == 0:
                out["g1"] = grads
    out["p"] = w
    return out


def predictions(smiles, feats, weights: dict, depth: int, device,
                block: int = 1024, tf32: bool = False) -> np.ndarray:
    """Eval-mode predictions of every row, ``block`` rows at a time."""
    graphs = featurize(smiles)
    w = {n: t.detach().float() for n, t in weights.items()}
    out = []
    with torch.no_grad(), _fixed_order():
        for a in range(0, len(graphs), block):
            gs = graph_set(graphs[a:a + block],
                           None if feats is None else feats[a:a + block],
                           np.zeros(len(graphs[a:a + block]), np.float32),
                           device)
            out.append(forward(w, gs, depth, tf32=tf32).cpu().numpy())
    return np.concatenate(out)
