"""Synthetic molecular-like graphs for benchmarks and sharding dry-runs.

Generates random connected graphs with chemistry-like statistics (10-30
atoms, max degree ~4, directed edge pairs) without invoking the SMILES
stack — deterministic and fast, used by chip_smoke.py — and path graphs
(:func:`chain_graph`), whose long chains are the giant graphs that edge
partitioning cuts across shards.
"""

from __future__ import annotations

import numpy as np

from ..chem.featurize import GraphArrays

__all__ = ["synthetic_graphs", "chain_graph"]


def synthetic_graphs(n: int, rng: np.random.Generator,
                     node_feat_dim: int = 78, edge_feat_dim: int = 14,
                     min_atoms: int = 10, max_atoms: int = 30,
                     max_degree: int = 4) -> list[GraphArrays]:
    out = []
    for _ in range(n):
        nn = int(rng.integers(min_atoms, max_atoms + 1))
        deg = np.zeros(nn, np.int32)
        pairs: list[tuple[int, int]] = []
        # spanning tree with degree cap
        for v in range(1, nn):
            cands = [u for u in range(v) if deg[u] < max_degree]
            u = int(rng.choice(cands)) if cands else int(rng.integers(0, v))
            pairs.append((u, v))
            deg[u] += 1
            deg[v] += 1
        # a few ring-closing extras
        for _ in range(int(rng.integers(0, max(1, nn // 8) + 1))):
            u, v = rng.integers(0, nn, 2)
            if u != v and deg[u] < max_degree and deg[v] < max_degree \
                    and (min(u, v), max(u, v)) not in pairs:
                pairs.append((int(min(u, v)), int(max(u, v))))
                deg[u] += 1
                deg[v] += 1
        ne = 2 * len(pairs)
        senders = np.empty(ne, np.int32)
        receivers = np.empty(ne, np.int32)
        for i, (u, v) in enumerate(pairs):
            senders[2 * i], receivers[2 * i] = u, v
            senders[2 * i + 1], receivers[2 * i + 1] = v, u
        out.append(GraphArrays(
            node_feats=rng.standard_normal((nn, node_feat_dim)
                                           ).astype(np.float32),
            edge_feats=rng.standard_normal((ne, edge_feat_dim)
                                           ).astype(np.float32),
            senders=senders,
            receivers=receivers,
            rev_edge_index=np.arange(ne, dtype=np.int32) ^ 1,
        ))
    return out


def chain_graph(n: int, rng: np.random.Generator, node_feat_dim: int = 78,
                edge_feat_dim: int = 14) -> GraphArrays:
    """An n-node path graph (directed pairs adjacent) with normal random
    features."""
    nb = n - 1
    send = np.empty(2 * nb, np.int32)
    recv = np.empty(2 * nb, np.int32)
    send[0::2] = np.arange(nb)
    recv[0::2] = np.arange(1, n)
    send[1::2] = np.arange(1, n)
    recv[1::2] = np.arange(nb)
    return GraphArrays(
        rng.normal(size=(n, node_feat_dim)).astype(np.float32),
        rng.normal(size=(2 * nb, edge_feat_dim)).astype(np.float32),
        send, recv, np.arange(2 * nb, dtype=np.int32) ^ 1)
