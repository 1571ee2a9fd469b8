"""The loader's batching, frozen: which rows a step holds and where each
graph's edges lie in its packs.

A copy of the rules of ``cgr_mpnn_3d_tpu_torch/data/loader.py`` and
``data/batch.py`` that decide the batches of a staged epoch:

* the epoch-0 order is ``arange(n)`` shuffled by ``default_rng(seed)``;
* windows of ``batch_size`` rows, each sorted big graphs first (stable, by
  edge count), shrink ``n -> int(n * 0.8)`` until every graph places, and
  carry the rest into the next window;
* a graph goes to the feasible pack whose edge slack (then node slack,
  then index) after it is least;
* the staged epoch runs the cached batches in ``arange(S)`` shuffled by
  ``default_rng(seed + epoch)``.

The reference needs the placement only for the hash dropout, whose bits
are keyed on the pack and the pack-local edge row.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["Geometry", "geometry", "place", "plan_windows", "epoch_order",
           "staged_order"]


@dataclass(frozen=True)
class Geometry:
    te: int
    tn: int
    tb: int
    d: int
    dn: int
    p: int


def geometry(graphs, te: int, tn: int, tb: int, batch_size: int,
             margin: int = 2) -> Geometry:
    """The pack geometry of a training set: ELL widths from the data (the
    largest in-degree and node count plus ``margin``), ``p`` from the batch
    size."""
    deg, nodes = 1, 1
    for g in graphs:
        if g.num_edges:
            deg = max(deg, int(np.bincount(g.receivers).max()))
        nodes = max(nodes, g.num_nodes)
    return Geometry(te, tn, tb, deg + margin, min(tn, nodes + margin),
                    max(1, -(-batch_size // tb)))


def place(graphs, geo: Geometry):
    """[(pack, first edge row in the pack)] of each graph in turn, or None
    where one does not place."""
    e_fill = np.zeros(geo.p, np.int64)
    n_fill = np.zeros(geo.p, np.int64)
    g_fill = np.zeros(geo.p, np.int64)
    out = []
    for g in graphs:
        ne, nn = g.num_edges, g.num_nodes
        if ne > geo.te or nn > geo.tn or nn > geo.dn:
            return None
        if ne and int(np.bincount(g.receivers, minlength=nn).max()) > geo.d:
            return None
        ok = ((e_fill + ne <= geo.te) & (n_fill + nn <= geo.tn)
              & (g_fill < geo.tb))
        if not ok.any():
            return None
        key = (geo.te - e_fill - ne) * (geo.tn + 1) + (geo.tn - n_fill - nn)
        pk = int(np.argmin(np.where(ok, key, np.iinfo(np.int64).max)))
        out.append((pk, int(e_fill[pk])))
        e_fill[pk] += ne
        n_fill[pk] += nn
        g_fill[pk] += 1
    return out


def plan_windows(order, graph_of, geo: Geometry, batch_size: int) -> list:
    """The batches of one pass over ``order``: for each, [(row, pack, first
    edge row)] in placement order.  ``graph_of(row)`` gives a row's
    graph."""
    order = [int(i) for i in order]
    plan, pending, pos = [], [], 0
    while pos < len(order) or pending:
        take = batch_size - len(pending)
        rows = pending + order[pos:pos + take]
        pos += take
        n = len(rows)
        while True:
            window = sorted(rows[:n], key=lambda i: -graph_of(i).num_edges)
            where = place([graph_of(i) for i in window], geo)
            if where is not None:
                break
            if n == 1:
                raise ValueError(f"row {rows[0]} does not fit one pack")
            n = max(1, int(n * 0.8))
        plan.append([(r, pk, off) for r, (pk, off) in zip(window, where)])
        pending = rows[n:]
    return plan


def epoch_order(n: int, seed: int) -> np.ndarray:
    """The rows of the epoch-0 pass, from which the cache is packed."""
    idx = np.arange(n)
    np.random.default_rng(seed).shuffle(idx)
    return idx


def staged_order(n_batches: int, seed: int, epoch: int) -> np.ndarray:
    """The order in which a staged epoch runs the cached batches."""
    order = np.arange(n_batches)
    np.random.default_rng(seed + epoch).shuffle(order)
    return order
