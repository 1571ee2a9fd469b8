"""Edge partitioning in the flat layout: one graph batch sharded over
``n_ep`` shards by its edge axis, plus the host helpers the pack-local
packer (``ep_pack.py``) shares.

The counterpart of ``cgr_mpnn_3d_tpu/parallel/edge_partition.py``:
:class:`EdgeShardedBatch` and :func:`shard_edges` (numpy, a copy of its
body), the flat forward :func:`ep_forward` and the steps
:func:`make_ep_train_step` / :func:`make_ep_eval_step`.  The layout:

* **Node ownership.**  The global node axis is split into contiguous
  blocks: shard k owns nodes [k*block, (k+1)*block) (graphs of 64 nodes or
  more are DFS-relabelled first, so a block boundary cuts few edges).
* **Edge pairs.**  Directed-edge pairs (e, rev e) stay together on the
  shard that owns the even edge's source, so ``h[rev e]`` is local.
* **One extended index space per shard.**  Owned block [0, NK) ++ boundary
  slots [NK, NK + n_ep*S), slot [j, i] the i-th boundary node shared with
  shard j: the target of the partial incoming sums pushed to their owners,
  the halo of the completed sums pulled back and the host-packed x halo.
* **Exchange.**  Two all-to-alls of an [n_ep, S, H] boundary buffer a
  layer (push the partials, pull the completed rows); the adjoint of an
  all-to-all is the same all-to-all.
* **Loss.**  Pooling is a partial sum over owned nodes, summed over the
  shards with the FFN head; the FFN bias enters each shard as b / n_ep, so
  the sum is exact.

The flat forward is a per-shard generator on ``ep_pack.py``'s protocol
(:class:`~.ep_pack.Psum`, and :class:`~.ep_pack.AllToAll` for the
boundary buffer), run by :func:`~.ep_pack.run_lockstep` with every shard
in one process or by :func:`~.ep_pack.run_distributed` with one shard a
rank.  Each gather and partial sum is one op of
``ops/segment.py::flat_op`` (K7 with one pack on the card, the plain op on
the CPU), its ELL arrays brought to int32 once a batch by
:func:`flat_shards`.  JAX splits each op into owned and boundary rows so
XLA can overlap the all-to-alls; the sums are row-wise, so here each op is
one K7 launch over all its rows: per shard and forward 5·depth + 4
launches (x[src] 1; a layer: incoming partials, pushed rows, serve, t and
reverse; the readout's incoming partials and pushed rows; pool 1), and a
training step adds 5·depth + 3 backward launches (x[src] takes none).
The gathers and sums stay f32 at ``compute_dtype="bfloat16"``, whose
rounding is the linears' operands only, as JAX's ``_linear``.  Dropout is
the port's hash dropout keyed by the shard's seed and edge slot (JAX draws
``jax.random.bernoulli`` from the shard's folded key).  ``pooling="mean"``
divides each graph's pooled row by its node count over all shards (one
more sum over the shards); JAX's ``ep_forward`` pools by sum whatever
``pooling`` says.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..chem.featurize import GraphArrays
from ..data.batch import device_tensor
from ..models.cgr_mpnn import (ACTIVATIONS, CGRMPNN, _dropout, _linear,
                               _linear_cat)
from ..ops._launch import seed_list
from ..ops.kernel_math import k_act, round_bf16
from ..ops.segment import flat_ell, flat_op

__all__ = ["EPOverflow", "EdgeShardedBatch", "shard_edges", "FlatShard",
           "flat_shards", "flat_launches", "ep_forward_shard", "ep_forward",
           "make_ep_train_step", "make_ep_eval_step"]


class EPOverflow(ValueError):
    """A batch exceeded the pinned padded sizes: grow the pins and retry.
    The only ValueError subclass the EP loader's pin-growth loop catches,
    so real input errors surface at once."""


class EdgeShardedBatch(NamedTuple):
    """One graph batch, edge-sharded over ``n_ep`` shards (leading axis).

    Sizes a shard: NK owned nodes, T = n_ep*S boundary slots, NKH = NK + T
    extended positions, EK edge slots, B graphs.  An index equal to the
    gathered array's row count is the sentinel (a zero row)."""
    node_x: np.ndarray        # [n_ep, NKH, F] owned x ++ host-packed halo x
    edge_attr: np.ndarray     # [n_ep, EK, Fe]
    src_idx: np.ndarray       # [n_ep, EK]      ext position of src (sent NKH)
    rev: np.ndarray           # [n_ep, EK]      local edge ids (sentinel EK)
    dst_part: np.ndarray      # [n_ep, EK]      ext position of dst (sent NKH)
    part_inc: np.ndarray      # [n_ep, NKH, D]  in-edges per ext pos (sent EK)
    ext_out: np.ndarray       # [n_ep, NKH, D2] out-edges per ext pos (sent EK)
    recv_idx: np.ndarray      # [n_ep, T]       owned pos of each boundary
                              #                 slot this shard SERVES (sent NK)
    own_recv_inc: np.ndarray  # [n_ep, NK, DR]  serving slots per owned node
                              #                 (sentinel T)
    graph_nodes: np.ndarray   # [n_ep, B, DN]   owned node pos per graph
                              #                 (sentinel NK)
    node_graph: np.ndarray    # [n_ep, NK]      graph of owned node (sent B)
    inv_deg_own: np.ndarray   # [n_ep, NK]      1/in-degree of owned nodes
                              #                 (0 for isolated/pad; mean aggr)
    labels: np.ndarray        # [n_ep, B]       identical copies
    graph_mask: np.ndarray    # [n_ep, B]


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


def shard_edges(graphs: Sequence[GraphArrays], labels: Sequence[float],
                n_ep: int, d: int | None = None,
                extra_node_feats: Sequence[np.ndarray] | None = None,
                ek: int | None = None, nk: int | None = None,
                s_max: int | None = None, dn: int | None = None,
                d_out: int | None = None, d_recv: int | None = None
                ) -> EdgeShardedBatch:
    """The edge-sharded batch of whole graphs (vectorised: no per-edge
    Python, so ~100k edges shard in well under a second).  The size
    arguments (ek/nk/s_max/dn/d/d_out/d_recv) pin the padded shapes; a batch
    that needs more raises :class:`EPOverflow`."""
    n_graphs = len(graphs)
    # locality: giant graphs get a DFS node relabeling so contiguous
    # ownership blocks cut few edges (small graphs are contiguous already)
    graphs, extra_node_feats = _relabel_large(graphs, extra_node_feats,
                                              threshold=64)
    # ---- disjoint union (bulk concatenates) -------------------------------
    n_nodes = np.asarray([g.num_nodes for g in graphs], np.int64)
    n_edges = np.asarray([g.num_edges for g in graphs], np.int64)
    if (n_edges % 2).any():
        raise ValueError("directed-edge counts must be even (pair layout)")
    node_off = np.concatenate([[0], np.cumsum(n_nodes)])
    NT = int(node_off[-1])
    x = np.concatenate([g.node_feats for g in graphs], axis=0)
    if extra_node_feats is not None:
        x = np.concatenate(
            [x, np.concatenate([np.asarray(a, np.float32)
                                for a in extra_node_feats], axis=0)], axis=1)
    e_attr = np.concatenate([g.edge_feats for g in graphs], axis=0)
    edge_off = np.repeat(node_off[:-1], n_edges)
    send_g = np.concatenate([g.senders for g in graphs]).astype(np.int64)
    send_g += edge_off
    recv_g = np.concatenate([g.receivers for g in graphs]).astype(np.int64)
    recv_g += edge_off
    graph_of = np.repeat(np.arange(n_graphs, dtype=np.int64), n_nodes)
    E = len(send_g)

    # ---- ownership and pair assignment ------------------------------------
    # NK is the per-shard array CAPACITY (pinnable for static shapes); the
    # ownership block size tracks the ACTUAL node count so a small batch
    # under a large pin still spreads evenly over all shards — ownership
    # geometry (and with it every other natural size) is independent of
    # the pins, which keeps pin-growth monotone and convergent.
    NK = nk or _r8(int(np.ceil(NT / n_ep)))
    block = max(1, int(np.ceil(NT / n_ep)))
    if block > NK:
        raise EPOverflow(f"nk={NK} too small for {NT} nodes / {n_ep} shards")
    owner = lambda n: np.minimum(n // block, n_ep - 1)
    pair_src = send_g[0::2]                    # even edge's source
    pair_shard = owner(pair_src)               # [E/2]

    # ---- boundary sets: unique (shard k, remote node v) --------------------
    pair_dst = recv_g[0::2]
    b_mask = owner(pair_dst) != pair_shard
    bk = pair_shard[b_mask]                    # shard that references
    bv = pair_dst[b_mask]                      # remote node referenced
    kv = np.unique(bk * np.int64(NT + 1) + bv)
    u_k, u_v = kv // (NT + 1), kv % (NT + 1)
    u_j = owner(u_v)                           # owner of each boundary node
    # slot index within (k, j): entries already sorted by (k, v); group by
    # (k, j) — v values for one (k, j) group are contiguous ascending
    kj = u_k * n_ep + u_j
    order = np.argsort(kj, kind="stable")
    kj_s, v_s, k_s, j_s = kj[order], u_v[order], u_k[order], u_j[order]
    grp_counts = np.bincount(kj_s, minlength=n_ep * n_ep)
    starts = np.concatenate([[0], np.cumsum(grp_counts)[:-1]])
    slot = np.arange(len(kj_s)) - np.repeat(starts, grp_counts) \
        if len(kj_s) else np.zeros(0, np.int64)
    S = s_max or _r8(int(grp_counts.max(initial=0)))
    if grp_counts.max(initial=0) > S:
        raise EPOverflow(f"s_max={S} < max boundary set "
                         f"{int(grp_counts.max())}")
    T = n_ep * S
    NKH = NK + T

    # ext-position lookup: lut[k, v] = NK + j*S + slot for boundary (k, v)
    lut = np.full((n_ep, NT), -1, np.int64)
    if len(v_s):
        lut[k_s, v_s] = NK + j_s * S + slot

    def ext_pos(k_arr, n_arr):
        """ext position of global node n as seen from shard k."""
        own = owner(n_arr)
        local = n_arr - k_arr * block
        bpos = lut[k_arr, n_arr]
        return np.where(own == k_arr, local, bpos)

    # ---- per-shard edge layout --------------------------------------------
    pair_order = np.argsort(pair_shard, kind="stable")
    pair_counts = np.bincount(pair_shard, minlength=n_ep)
    EK = ek or _r8(2 * int(pair_counts.max(initial=0)), lo=8)
    if 2 * pair_counts.max(initial=0) > EK:
        raise EPOverflow(f"ek={EK} < max shard edges "
                         f"{2 * int(pair_counts.max())}")
    p_starts = np.concatenate([[0], np.cumsum(pair_counts)[:-1]])
    p_rank = np.arange(len(pair_order)) - np.repeat(p_starts, pair_counts)
    # local edge slots: pair rank r -> slots (2r, 2r+1)
    shard_of_pair_sorted = pair_shard[pair_order]
    eids = np.stack([2 * pair_order, 2 * pair_order + 1], 1).reshape(-1)
    e_shard = np.repeat(shard_of_pair_sorted, 2)
    e_slot = np.stack([2 * p_rank, 2 * p_rank + 1], 1).reshape(-1)

    Fe = e_attr.shape[1]
    F = x.shape[1]
    edge_attr = np.zeros((n_ep, EK, Fe), e_attr.dtype)
    src_idx = np.full((n_ep, EK), NKH, np.int32)
    dst_part = np.full((n_ep, EK), NKH, np.int32)
    rev = np.full((n_ep, EK), EK, np.int32)
    edge_attr[e_shard, e_slot] = e_attr[eids]
    src_idx[e_shard, e_slot] = ext_pos(e_shard, send_g[eids])
    dst_part[e_shard, e_slot] = ext_pos(e_shard, recv_g[eids])
    rev[e_shard, e_slot] = e_slot ^ 1          # pairs stay adjacent

    # ---- node features: owned block ++ halo --------------------------------
    node_x = np.zeros((n_ep, NKH, F), x.dtype)
    for k in range(n_ep):                       # n_ep iterations, bulk rows
        lo = k * block
        hi = min((k + 1) * block, NT) if k < n_ep - 1 else NT
        if hi > lo:
            node_x[k, :hi - lo] = x[lo:hi]
    if len(v_s):
        node_x[k_s, NK + j_s * S + slot] = x[v_s]

    # ---- ELL adjacency (vectorized) ----------------------------------------
    def _max_count(rows_2d, limit):
        k_i, e_i = np.nonzero(rows_2d < limit)
        if len(k_i) == 0:
            return 1
        key = k_i.astype(np.int64) * limit + rows_2d[k_i, e_i]
        return int(np.bincount(key).max())

    D = d or _max_count(dst_part, NKH)
    D2 = d_out or _max_count(src_idx, NKH)
    part_inc = np.empty((n_ep, NKH, D), np.int32)
    ext_out = np.empty((n_ep, NKH, D2), np.int32)
    for k in range(n_ep):                       # bulk _ell_pack per shard
        real = dst_part[k] < NKH
        part_inc[k] = _ell_pack(dst_part[k][real],
                                np.nonzero(real)[0].astype(np.int64),
                                NKH, D, EK, "part_inc")
        reals = src_idx[k] < NKH
        ext_out[k] = _ell_pack(src_idx[k][reals],
                               np.nonzero(reals)[0].astype(np.int64),
                               NKH, D2, EK, "ext_out")

    # ---- serving side: slots this shard's owned nodes feed -----------------
    # shard j serves boundary node v (owned by j) to requester k at k's slot
    # (j, i); on j the wire position is [k, i] (all_to_all pairs [k]<->[j]).
    recv_idx = np.full((n_ep, T), NK, np.int32)
    if len(v_s):
        recv_idx[j_s, k_s * S + slot] = (v_s - j_s * block).astype(np.int32)
    DR = d_recv or _max_count(recv_idx, NK)
    own_recv_inc = np.empty((n_ep, NK, DR), np.int32)
    for k in range(n_ep):
        srv = recv_idx[k] < NK
        own_recv_inc[k] = _ell_pack(recv_idx[k][srv].astype(np.int64),
                                    np.nonzero(srv)[0].astype(np.int64),
                                    NK, DR, T, "own_recv_inc")

    # ---- pooling over owned nodes ------------------------------------------
    node_ids = np.arange(NT, dtype=np.int64)
    n_owner = owner(node_ids)
    n_pos = node_ids - n_owner * block
    DN = dn or max(1, int(np.bincount(
        n_owner * n_graphs + graph_of, minlength=1).max(initial=1)))
    graph_nodes = np.empty((n_ep, n_graphs, DN), np.int32)
    node_graph = np.full((n_ep, NK), n_graphs, np.int32)
    node_graph[n_owner, n_pos] = graph_of
    for k in range(n_ep):
        sel = n_owner == k
        graph_nodes[k] = _ell_pack(graph_of[sel], n_pos[sel],
                                   n_graphs, DN, NK, "graph_nodes")

    # global in-degree -> per-owner inverse (aggr='mean' normalization)
    deg = np.bincount(recv_g, minlength=NT).astype(np.float64)
    inv_deg_own = np.zeros((n_ep, NK), np.float32)
    nz = deg > 0
    inv_deg_own[n_owner[nz], n_pos[nz]] = (1.0 / deg[nz]).astype(np.float32)

    labels_out = np.broadcast_to(
        np.asarray(labels, np.float32), (n_ep, n_graphs)).copy()
    graph_mask = np.ones((n_ep, n_graphs), np.float32)

    return EdgeShardedBatch(node_x, edge_attr, src_idx, rev, dst_part,
                            part_inc, ext_out, recv_idx, own_recv_inc,
                            graph_nodes, node_graph, inv_deg_own,
                            labels_out, graph_mask)


# ---------------------------------------------------------------------------
# the flat forward of one shard, and the steps
# ---------------------------------------------------------------------------

class FlatShard(NamedTuple):
    """One shard of an :class:`EdgeShardedBatch` as tensors on a device,
    with its ELL arrays as ``ops/segment.py::flat_op`` takes them: ``ell``
    maps each op to its (forward, backward) arrays, made once a batch."""
    batch: EdgeShardedBatch
    ell: dict


def _flat_tables(b: EdgeShardedBatch) -> dict:
    src, ext_out = flat_ell(b.src_idx), flat_ell(b.ext_out)
    recv, own_recv = flat_ell(b.recv_idx), flat_ell(b.own_recv_inc)
    rev = flat_ell(b.rev)
    return {"x_src": (src, ext_out),
            "incoming": (flat_ell(b.part_inc), flat_ell(b.dst_part)),
            "pushed": (own_recv, recv),
            "serve": (recv, own_recv),
            "t": (src, ext_out),
            "reverse": (rev, rev),
            "pool": (flat_ell(b.graph_nodes), flat_ell(b.node_graph))}


def flat_shards(batch: EdgeShardedBatch, device) -> list[FlatShard]:
    """The shards of ``batch`` (leaves [n_ep, ...]) on ``device``, one
    :class:`FlatShard` each."""
    out = []
    for k in range(batch.node_x.shape[0]):
        b = EdgeShardedBatch(*(device_tensor(a[k], device) for a in batch))
        out.append(FlatShard(b, _flat_tables(b)))
    return out


def flat_launches(depth: int, train: bool) -> int:
    """K7 launches of one shard's flat forward (``train``: its training
    step, forward and backward) at ``depth`` conv layers."""
    fwd = 5 * depth + 4
    return fwd + (5 * depth + 3 if train else 0)


def ep_forward_shard(model: CGRMPNN, s: FlatShard, n_ep: int, *,
                     train: bool = False, seeds=None):
    """One shard's flat forward, a generator: yields its collectives
    (:class:`~.ep_pack.AllToAll`, :class:`~.ep_pack.Psum`) and returns (the
    full-batch masked SSE, the same on every shard, and preds [B]).
    ``seeds`` holds this shard's int32 dropout seed per conv layer (train
    mode)."""
    from .ep_pack import AllToAll, Psum
    cfg = model.cfg
    if train and seeds is None:
        raise ValueError("train mode needs one dropout seed per conv layer")
    b, ell = s.batch, s.ell
    kact = ACTIVATIONS[cfg.activation]
    bf16 = cfg.compute_dtype == "bfloat16"
    fd = model.ffn.w.dtype
    NK = b.own_recv_inc.shape[0]
    NKH = b.node_x.shape[0]
    T = NKH - NK
    S = T // n_ep
    EK = b.src_idx.shape[0]

    def op(name, src):
        return flat_op(name, src, *ell[name])

    # mean: in-degrees are known per batch, so the normalisation is a
    # host-made scale on owned nodes applied BEFORE the halo pull
    scale = b.inv_deg_own.to(fd)[:, None] if cfg.aggr == "mean" else None

    def incoming_owned(h):
        """Complete incoming sums on owned nodes: the partials of every
        extended position, the boundary rows pushed to their owners."""
        part = op("incoming", h)                                 # [NKH, H]
        pushed = yield AllToAll(part[NK:].reshape(n_ep, S, -1))
        a = part[:NK] + op("pushed", pushed.reshape(T, -1))
        return a if scale is None else a * scale

    def messages(h, a_own):
        """t[e] = a[src(e)] - h[rev(e)], the boundary rows of a pulled."""
        serve = op("serve", a_own)                               # [T, H]
        pulled = yield AllToAll(serve.reshape(n_ep, S, -1))
        a_ext = torch.cat([a_own, pulled.reshape(T, -1)])
        return op("t", a_ext) - op("reverse", h)

    if not train:
        layer_seeds = [None] * cfg.depth
    elif torch.is_tensor(seeds) and seeds.is_cuda:
        layer_seeds = list(seeds)
    else:
        layer_seeds = seed_list(seeds)
    x = b.node_x.to(fd)
    x_src = op("x_src", x)                                       # [EK, F]
    h0 = k_act(kact, _linear_cat(x_src, b.edge_attr.to(fd), model.edge_init,
                                 bf16))
    h = h0
    for l, conv in enumerate(model.convs):
        a_own = yield from incoming_owned(h)
        t = yield from messages(h, a_own)
        h_new = _linear(t, conv, bf16)
        if cfg.use_learnable_skip:
            h = h_new + model.skip_weights[l] * h0
        else:
            h = h_new + h0
        h = k_act(kact, h)
        if train and cfg.dropout_ps[l] > 0.0:
            h = _dropout(h, cfg.dropout_ps[l], layer_seeds[l], EK)
    s_own = yield from incoming_owned(h)                         # [NK, H]
    hn = k_act(kact, _linear_cat(x[:NK], s_own, model.edge_to_node, bf16))
    pool = op("pool", hn)                                        # [B, H]
    if cfg.pooling == "mean":
        cnt = yield Psum((b.graph_nodes < NK).sum(dim=1).to(fd))
        pool = pool * torch.where(cnt > 0, 1.0 / cnt.clamp_min(1.0),
                                  0.0)[:, None]
    # the ffn bias split as b/n_ep, so the sum over shards is exact
    w_ffn = model.ffn.w
    if bf16:
        pool, w_ffn = round_bf16(pool), round_bf16(w_ffn)
    z = pool @ w_ffn + model.ffn.b / n_ep
    preds = (yield Psum(z))[:, 0]
    err = (preds - b.labels.to(fd)) * b.graph_mask.to(fd)
    return (err * err).sum(), preds


def ep_forward(model: CGRMPNN, shards: list, *, train: bool = False,
               seeds=None, comm=None):
    """The flat forward over every shard in this process -> (full-batch
    SSE, preds [B]).  ``seeds`` [n_ep, depth]: one dropout seed per shard
    and conv layer (train mode).  With ``comm``
    (``multihost.ep_comm``: one shard a rank) ``shards`` is this rank's one
    shard and its peers run on the other ranks of the group."""
    from .ep_pack import run_distributed, run_lockstep
    if comm is not None:
        if len(shards) != 1:
            raise ValueError(f"{len(shards)} shards on a rank of an EP group")
        return run_distributed(ep_forward_shard(
            model, shards[0], len(comm.ranks), train=train,
            seeds=None if seeds is None else seeds[0]), (), comm)
    n_ep = len(shards)
    gens = [ep_forward_shard(model, s, n_ep, train=train,
                             seeds=None if seeds is None else seeds[k])
            for k, s in enumerate(shards)]
    (sse, preds), *_ = run_lockstep(gens, ())
    return sse, preds


def make_ep_train_step(model: CGRMPNN, comm=None):
    """``step(groups, seeds) -> SSE``: the flat training step's compute over
    every data-parallel group and shard in this process (``groups``
    [n_dp][n_ep] :class:`FlatShard`), autograd of each group's full-batch
    SSE with ``.grad`` accumulating over the groups (JAX's ``psum(loss /
    n_ep)`` over ('dp', 'ep'): every shard of a group holds its full SSE);
    the optimizer is the caller's.  ``seeds`` [n_dp, n_ep, depth] turns on
    train-mode dropout.  Over several ranks ``groups`` holds this rank's
    cells (with ``comm``: [[its shard]]), and [SSE, gradients] are summed
    over every rank in one collective, a group's SSE once."""
    from .data_parallel import all_reduce_step
    from .ep_pack import _once_a_group

    def step(groups, seeds=None):
        model.zero_grad(set_to_none=True)
        total = None
        for g, shards in enumerate(groups):
            sse, _ = ep_forward(model, shards, train=seeds is not None,
                                seeds=None if seeds is None else seeds[g],
                                comm=comm)
            sse.backward()
            total = sse.detach() if total is None else total + sse.detach()
        return all_reduce_step(model, _once_a_group(total, comm))
    return step


def make_ep_eval_step(model: CGRMPNN, comm=None):
    """``eval(groups) -> (SSE summed over the groups, preds [n_dp * B])`` in
    eval mode, no gradients; ``groups`` [n_dp][n_ep] :class:`FlatShard`.
    Over several ranks the SSE is summed over every rank (each group's
    once) and the preds are this rank's groups'."""
    from .data_parallel import all_reduce_step
    from .ep_pack import _once_a_group

    def evaluate(groups):
        sse, preds = None, []
        with torch.no_grad():
            for shards in groups:
                s, p = ep_forward(model, shards, comm=comm)
                sse = s if sse is None else sse + s
                preds.append(p)
            sse = all_reduce_step(None, _once_a_group(sse, comm))
        return sse, torch.cat(preds)
    return evaluate
