"""The host helpers of edge partitioning that the pack-local packer needs.

Copies of ``EPOverflow``, ``_r8``, ``_dfs_order``, ``_relabel_large`` and
``_ell_pack`` from ``cgr_mpnn_3d_tpu/parallel/edge_partition.py`` (numpy
only).  The flat v2 layout of that module (``shard_edges``,
``ep_forward``, ``EPLoader``) is not part of the port (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np

from ..chem.featurize import GraphArrays

__all__ = ["EPOverflow"]


class EPOverflow(ValueError):
    """A batch exceeded the pinned padded sizes: grow the pins and retry.
    The only ValueError subclass the EP loader's pin-growth loop catches,
    so real input errors surface at once."""


def _r8(v: int, lo: int = 8) -> int:
    return max(lo, int(-(-v // 8)) * 8)


def _dfs_order(nn: int, senders: np.ndarray,
               receivers: np.ndarray) -> np.ndarray:
    """DFS visit order (old id per new position): keeps subtrees
    contiguous, so contiguous node blocks cut few edges."""
    deg = np.bincount(senders, minlength=nn)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    adj = receivers[np.argsort(senders, kind="stable")]
    visited = np.zeros(nn, bool)
    out = np.empty(nn, np.int64)
    w = 0
    for seed in range(nn):
        if visited[seed]:
            continue
        visited[seed] = True
        stack = [seed]
        while stack:
            u = stack.pop()
            out[w] = u
            w += 1
            for v in adj[indptr[u]:indptr[u + 1]][::-1]:
                if not visited[v]:
                    visited[v] = True
                    stack.append(int(v))
    return out


def _relabel_large(graphs, extra_node_feats, threshold: int):
    """DFS-relabel the nodes of graphs of at least ``threshold`` nodes (the
    edge order, and with it the pair/rev layout, is kept; predictions do
    not depend on node labels)."""
    gs = list(graphs)
    ex = list(extra_node_feats) if extra_node_feats is not None else None
    for i, g in enumerate(gs):
        if g.num_nodes < threshold or g.num_edges == 0:
            continue
        old_of_new = _dfs_order(g.num_nodes, g.senders, g.receivers)
        new_of_old = np.empty_like(old_of_new)
        new_of_old[old_of_new] = np.arange(g.num_nodes)
        gs[i] = GraphArrays(
            node_feats=g.node_feats[old_of_new],
            edge_feats=g.edge_feats,
            senders=new_of_old[g.senders].astype(np.int32),
            receivers=new_of_old[g.receivers].astype(np.int32),
            rev_edge_index=g.rev_edge_index)
        if ex is not None:
            ex[i] = np.asarray(ex[i])[old_of_new]
    return gs, ex


def _ell_pack(rows: np.ndarray, vals: np.ndarray, n_rows: int, width: int,
              sentinel: int, what: str) -> np.ndarray:
    """out[rows[m], rank of m within its row] = vals[m], sentinel-padded."""
    out = np.full((n_rows, width), sentinel, np.int32)
    if len(rows) == 0:
        return out
    order = np.argsort(rows, kind="stable")
    r, v = rows[order], vals[order]
    counts = np.bincount(r, minlength=n_rows)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(r)) - np.repeat(starts, counts)
    if counts.max(initial=0) > width:
        raise EPOverflow(f"{what}: ELL width {width} < max degree "
                         f"{int(counts.max())}; raise it")
    out[r, rank] = v
    return out
