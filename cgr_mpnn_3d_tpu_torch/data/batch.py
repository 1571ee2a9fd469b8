"""Static-shape block-dense graph packing (numpy, host side).

A copy of ``cgr_mpnn_3d_tpu/data/batch.py`` (the Python packer, the twin of
``native/packer.cpp``, which packs the same batches bit for bit) plus
:func:`to_device`.  Graphs are
bin-packed into fixed-size *packs* (TE edges x TN nodes x TB graphs per
pack); a batch is P packs.

Pack locality is the key invariant: a graph never spans packs, so every
edge/node index an edge references lives inside the same pack.  The CUDA
kernels rely on it: the whole-model forward (csrc/fused_model_fwd.cu, the
phases of csrc/fused_model_grid.cuh::forward_phases) deals each phase's
tiles and row ranges of every pack to one cooperative grid, and an item
reads only its own pack's rows.

Gather-only adjacency: alongside ``senders/receivers/rev`` the packer emits
ELL-style index arrays whose *adjoints are also gathers*:

    edge_nbr[e, d]      in-edges of sender(e)      (conv fwd)
    edge_nbr_rev[e, d]  out-edges of receiver(e)   (conv bwd)
    node_inc[n, d]      in-edges of node n         (readout fwd / conv partial)
    node_out[n, d]      out-edges of node n        (edge_init bwd)
    graph_nodes[g, k]   nodes of graph g           (pooling fwd)
    graph_of_node[n]    graph id of node n         (pooling bwd)

All indices are **global with sentinel**: a sentinel equals the array's row
count and resolves to an appended zero row in the plain ops (ops/segment.py);
the kernel skips any index outside its pack.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..chem.featurize import GraphArrays

__all__ = ["PackSpec", "PackedGraphBatch", "pack_graphs", "plan_spec",
           "place_graphs", "packs_needed", "empty_batch", "device_tensor",
           "to_device"]


@dataclass(frozen=True)
class PackSpec:
    """Static packing geometry (hashable)."""
    te: int = 256          # edge slots per pack
    tn: int = 128          # node slots per pack
    tb: int = 16           # graph slots per pack
    d: int = 8             # ELL width: max node in-degree
    dn: int = 64           # max nodes per single graph (pooling ELL width)
    p: int = 1             # packs per batch
    feat_dtype: str = "float32"   # host->device feature transfer dtype;
                                  # "float16" halves input-pipeline bytes
                                  # (features are mostly exact one-hots)

    @property
    def total_edges(self) -> int:
        return self.te * self.p

    @property
    def total_nodes(self) -> int:
        return self.tn * self.p

    @property
    def total_graphs(self) -> int:
        return self.tb * self.p

    def with_packs(self, p: int) -> "PackSpec":
        return PackSpec(self.te, self.tn, self.tb, self.d, self.dn, p,
                        self.feat_dtype)


class PackedGraphBatch(NamedTuple):
    """One statically-shaped batch (numpy arrays, or tensors after
    :func:`to_device`; see module doc).

    Shapes: ET = te*p, NT = tn*p, BT = tb*p.
    """
    node_x: np.ndarray        # [NT, F]  f32
    edge_attr: np.ndarray     # [ET, Fe] f32
    senders: np.ndarray       # [ET]     i32, node id   (sentinel NT)
    receivers: np.ndarray     # [ET]     i32, node id   (sentinel NT)
    rev: np.ndarray           # [ET]     i32, edge id   (sentinel ET)
    edge_nbr: np.ndarray      # [ET, D]  i32, edge ids  (sentinel ET)
    edge_nbr_rev: np.ndarray  # [ET, D]  i32, edge ids  (sentinel ET)
    node_inc: np.ndarray      # [NT, D]  i32, edge ids  (sentinel ET)
    node_out: np.ndarray      # [NT, D]  i32, edge ids  (sentinel ET)
    graph_of_node: np.ndarray # [NT]     i32, graph id  (sentinel BT)
    graph_nodes: np.ndarray   # [BT, DN] i32, node ids  (sentinel NT)
    labels: np.ndarray        # [BT]     f32
    graph_mask: np.ndarray    # [BT]     f32 (1 = real graph)
    row_ids: np.ndarray       # [BT]     i32 input row of each slot (-1 pad):
                              # first-fit may backfill an earlier pack, so
                              # slot order is NOT input order — consumers
                              # needing row order (predict) must use this

    @property
    def num_real_graphs(self):
        return self.graph_mask.sum()


def plan_spec(graphs: Sequence[GraphArrays], te: int = 256, tn: int = 128,
              tb: int = 16, margin: int = 2) -> PackSpec:
    """Derive ELL widths (d, dn) from data, keeping tile sizes as given."""
    max_deg = 1
    max_nodes = 1
    for g in graphs:
        if g.num_edges:
            max_deg = max(max_deg, int(np.bincount(g.receivers).max()))
        max_nodes = max(max_nodes, g.num_nodes)
    return PackSpec(te=te, tn=tn, tb=tb, d=max_deg + margin,
                    dn=min(tn, max_nodes + margin), p=1)


def _graph_ell(receivers: np.ndarray, rev: np.ndarray, n_nodes: int,
               d: int, edge_sentinel: int,
               edge_offset: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-graph node_inc/node_out (global edge ids, sentinel-padded)."""
    node_inc = np.full((n_nodes, d), edge_sentinel, dtype=np.int32)
    node_out = np.full((n_nodes, d), edge_sentinel, dtype=np.int32)
    fill = np.zeros(n_nodes, dtype=np.int32)
    for e, r in enumerate(receivers):
        k = fill[r]
        if k >= d:
            raise ValueError(
                f"node in-degree exceeds ELL width d={d}; re-plan the PackSpec")
        node_inc[r, k] = edge_offset + e
        node_out[r, k] = edge_offset + rev[e]
        fill[r] = k + 1
    return node_inc, node_out


def place_graphs(graphs: Sequence[GraphArrays], spec: PackSpec) -> bool:
    """Placement-only feasibility probe: True iff :func:`pack_graphs`
    would place every graph — the same per-graph checks (tile, dn,
    ELL in-degree) and the same best-fit sequence, with NO output
    allocation or writes (the Python twin of the JAX package's native
    ``cgr_place_graphs``)."""
    e_fill = np.zeros(spec.p, np.int32)
    n_fill = np.zeros(spec.p, np.int32)
    g_fill = np.zeros(spec.p, np.int32)
    for g in graphs:
        ne, nn = g.num_edges, g.num_nodes
        if ne > spec.te or nn > spec.tn or nn > spec.dn:
            return False
        if ne and int(np.bincount(g.receivers,
                                  minlength=nn).max()) > spec.d:
            return False
        feasible = ((e_fill + ne <= spec.te) & (n_fill + nn <= spec.tn)
                    & (g_fill < spec.tb))
        if not feasible.any():
            return False
        key = ((spec.te - e_fill - ne).astype(np.int64) * (spec.tn + 1)
               + (spec.tn - n_fill - nn))
        pk = int(np.argmin(np.where(feasible, key,
                                    np.iinfo(np.int64).max)))
        e_fill[pk] += ne
        n_fill[pk] += nn
        g_fill[pk] += 1
    return True


def pack_graphs(graphs: Sequence[GraphArrays],
                labels: Sequence[float],
                spec: PackSpec,
                extra_node_feats: Sequence[np.ndarray] | None = None,
                row_ids: Sequence[int] | None = None,
                ) -> PackedGraphBatch:
    """Bin-pack graphs into ``spec.p`` packs (first-fit) and emit one batch.

    ``extra_node_feats`` optionally concatenates per-graph [n_atoms, K] blocks
    (MACE descriptors) onto node features, replacing ChemDataset.py:83-86.
    Raises if the graphs do not fit — callers size ``p`` via
    :func:`packs_needed`.
    """
    n_feat = graphs[0].node_feats.shape[1]
    if extra_node_feats is not None:
        n_feat += extra_node_feats[0].shape[1]
    e_feat = graphs[0].edge_feats.shape[1]

    ET, NT, BT = spec.total_edges, spec.total_nodes, spec.total_graphs

    fdt = np.dtype(spec.feat_dtype)
    node_x = np.zeros((NT, n_feat), fdt)
    edge_attr = np.zeros((ET, e_feat), fdt)
    senders = np.full(ET, NT, np.int32)
    receivers = np.full(ET, NT, np.int32)
    rev = np.full(ET, ET, np.int32)
    edge_nbr = np.full((ET, spec.d), ET, np.int32)
    edge_nbr_rev = np.full((ET, spec.d), ET, np.int32)
    node_inc = np.full((NT, spec.d), ET, np.int32)
    node_out = np.full((NT, spec.d), ET, np.int32)
    graph_of_node = np.full(NT, BT, np.int32)
    graph_nodes = np.full((BT, spec.dn), NT, np.int32)
    labels_out = np.zeros(BT, np.float32)
    graph_mask = np.zeros(BT, np.float32)
    row_ids_out = np.full(BT, -1, np.int32)
    row_ids = (list(range(len(graphs))) if row_ids is None
               else list(row_ids))

    # per-pack fill counters
    e_fill = np.zeros(spec.p, np.int32)
    n_fill = np.zeros(spec.p, np.int32)
    g_fill = np.zeros(spec.p, np.int32)

    for gi, g in enumerate(graphs):
        ne, nn = g.num_edges, g.num_nodes
        if ne > spec.te or nn > spec.tn:
            raise ValueError(
                f"graph {gi} ({nn} nodes / {ne} edges) exceeds pack tile "
                f"({spec.tn} nodes / {spec.te} edges); increase te/tn")
        if nn > spec.dn:
            raise ValueError(f"graph {gi} has {nn} nodes > dn={spec.dn}")
        # best-fit pack selection: tightest post-placement edge slack
        # (ties: node slack, then lowest index — np.argmin's first-min).
        # With descending-size callers this is best-fit-decreasing; at
        # te=128 it recovers ~2% fill over first-fit by pairing large
        # graphs with the small ones that still fit their slack.
        feasible = ((e_fill + ne <= spec.te) & (n_fill + nn <= spec.tn)
                    & (g_fill < spec.tb))
        if not feasible.any():
            raise ValueError(
                "graphs do not fit into the configured packs; "
                "increase spec.p (see packs_needed)")
        key = ((spec.te - e_fill - ne).astype(np.int64) * (spec.tn + 1)
               + (spec.tn - n_fill - nn))
        pk = int(np.argmin(np.where(feasible, key, np.iinfo(np.int64).max)))

        n_off = pk * spec.tn + n_fill[pk]
        e_off = pk * spec.te + e_fill[pk]
        g_off = pk * spec.tb + g_fill[pk]

        x = g.node_feats
        if extra_node_feats is not None:
            ex = np.asarray(extra_node_feats[gi], np.float32)
            if ex.shape[0] != nn:
                raise ValueError(
                    f"extra feature rows ({ex.shape[0]}) != atoms ({nn}) "
                    f"for graph {gi}")
            x = np.concatenate([x, ex], axis=1)
        node_x[n_off:n_off + nn] = x
        edge_attr[e_off:e_off + ne] = g.edge_feats
        senders[e_off:e_off + ne] = g.senders + n_off
        receivers[e_off:e_off + ne] = g.receivers + n_off
        rev[e_off:e_off + ne] = g.rev_edge_index + e_off

        if ne:
            inc, out = _graph_ell(g.receivers, g.rev_edge_index, nn,
                                  spec.d, ET, e_off)
            node_inc[n_off:n_off + nn] = inc
            node_out[n_off:n_off + nn] = out
            # edge_nbr[e] = node_inc[sender(e)]; edge_nbr_rev[e] = node_out[receiver(e)]
            edge_nbr[e_off:e_off + ne] = inc[g.senders]
            edge_nbr_rev[e_off:e_off + ne] = out[g.receivers]

        graph_of_node[n_off:n_off + nn] = g_off
        graph_nodes[g_off, :nn] = np.arange(n_off, n_off + nn, dtype=np.int32)
        labels_out[g_off] = labels[gi]
        graph_mask[g_off] = 1.0
        row_ids_out[g_off] = row_ids[gi]

        e_fill[pk] += ne
        n_fill[pk] += nn
        g_fill[pk] += 1

    return PackedGraphBatch(node_x, edge_attr, senders, receivers, rev,
                            edge_nbr, edge_nbr_rev, node_inc, node_out,
                            graph_of_node, graph_nodes, labels_out,
                            graph_mask, row_ids_out)


def empty_batch(spec: PackSpec, n_feat: int, e_feat: int
                ) -> PackedGraphBatch:
    """An all-padding batch (graph_mask 0 everywhere): the filler for
    data-parallel step groups whose last group is short of devices."""
    ET, NT, BT = spec.total_edges, spec.total_nodes, spec.total_graphs
    fdt = np.dtype(spec.feat_dtype)
    return PackedGraphBatch(
        node_x=np.zeros((NT, n_feat), fdt),
        edge_attr=np.zeros((ET, e_feat), fdt),
        senders=np.full(ET, NT, np.int32),
        receivers=np.full(ET, NT, np.int32),
        rev=np.full(ET, ET, np.int32),
        edge_nbr=np.full((ET, spec.d), ET, np.int32),
        edge_nbr_rev=np.full((ET, spec.d), ET, np.int32),
        node_inc=np.full((NT, spec.d), ET, np.int32),
        node_out=np.full((NT, spec.d), ET, np.int32),
        graph_of_node=np.full(NT, BT, np.int32),
        graph_nodes=np.full((BT, spec.dn), NT, np.int32),
        labels=np.zeros(BT, np.float32),
        graph_mask=np.zeros(BT, np.float32),
        row_ids=np.full(BT, -1, np.int32),
    )


def packs_needed(graphs: Sequence[GraphArrays], spec: PackSpec,
                 fill_target: float = 0.9) -> int:
    """Lower-bound pack count for a set of graphs (first-fit headroom)."""
    tot_e = sum(g.num_edges for g in graphs)
    tot_n = sum(g.num_nodes for g in graphs)
    tot_g = len(graphs)
    p = max(
        int(np.ceil(tot_e / (spec.te * fill_target))),
        int(np.ceil(tot_n / (spec.tn * fill_target))),
        int(np.ceil(tot_g / spec.tb)),
        1,
    )
    return p


def device_tensor(a: np.ndarray, device) -> torch.Tensor:
    """``a`` as a tensor on ``device``, in memory that torch allocated: on
    the CPU a copy, not a view of the numpy buffer, whose alignment changes
    from run to run -- and MKL's products give other bits for operands at
    other alignments, which would make two runs of the same steps differ."""
    t = torch.as_tensor(np.ascontiguousarray(a), device=device)
    return t.clone() if t.device.type == "cpu" else t


def to_device(batch: PackedGraphBatch, device) -> PackedGraphBatch:
    """The same batch as tensors on ``device`` (int32 indices, features in
    the packer's dtype).  Indices keep the global-with-sentinel convention."""
    return PackedGraphBatch(*(device_tensor(a, device) for a in batch))
