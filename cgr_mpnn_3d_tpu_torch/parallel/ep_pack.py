"""Edge partitioning in the pack-local layout: the host packer and the EP
step, with every shard of a step in one process.

The counterpart of ``cgr_mpnn_3d_tpu/parallel/ep_pack.py`` ("edge
partitioning v3").  A batch of whole graphs is sharded over ``n_ep``
shards and each shard's local subgraph is packed block-dense, as the
single-device packer does:

* **Ownership.**  Whole graphs go to the least-loaded shard (LPT by
  edges), so a normal batch has zero cut; only a graph with more edges
  than an even shard share is striped in contiguous node chunks over every
  shard.  Directed-edge pairs stay adjacent (slots 2i, 2i+1) on the shard
  that owns the even edge's source.
* **Fragments.**  A shard's piece of one graph (owned and halo nodes) is a
  fragment; fragments are bin-packed best-fit-decreasing into packs of te
  edge and tn node slots, so every index a pack's edges reference lies in
  the pack.
* **Wire.**  Boundary rows travel in a hop-aligned ring: hop h moves each
  shard's rows for shard k + h in a block of ``caps[h-1]`` rows (TW rows in
  all).  The push sends the halo slots' partial incoming sums to their
  owners; the pull returns the completed sums.

:func:`pack_shard_edges` is the JAX packer in numpy, slot for slot, without
its transposed TPU tables (``send_t``, ``dst_t``, ``inc_t``, ``out_t``,
``pool_t``, the 8-row node-group table): the CUDA kernels gather through ELL
arrays instead, which the packer adds -- ``edge_nbr = node_inc[senders]``
(e^1 included), ``rev = e^1`` on real edges, ``edge_nbr_rev =
node_out[dst]`` (the adjoint of the message gather; both padded to one
width, max(d, d2)) and ``pool_ell``, the per-group pool ELL (``pool_t``
untransposed).  ``dst`` doubles as the readout's ``receivers``.

The EP forward (:func:`ep_pack_forward_shard`, the JAX ``ep_pack_forward``'s
kernel branch) is one function per shard, as ``per_device`` is in JAX: a
generator that yields at each collective -- :class:`Exchange` (a ring hop)
and :class:`Psum` (a sum over the shards) -- and receives the result.
:func:`run_lockstep` advances every shard's generator to its next
collective, runs the collective in this process (the ring exchange is a
tensor copy between the shards' buffers) and resumes them, so each layer's
push partials exist for every shard before the exchange and each shard's
conv kernel runs after it.  Over several ranks with one shard a rank
(``multihost`` layout (b)), :func:`run_distributed` drives the rank's one
generator instead and serves its requests through the process group: the
ring move between the group's ranks (host-staged point-to-point, its
adjoint the inverse move) and a sum over them (its adjoint the identity:
every rank computes the group's SSE from the summed predictions).  Per shard: edge_init through K5, then with zero
cut the conv stack K4, else per layer the boundary correction and K8 (K9 for
``aggr=mean``); then the readout and group pool K11, the fragment combine,
mean pooling and the FFN head.  Every gather of the glue, and every adjoint,
is a gather through an index array the packer built (the JAX scatter-adds
become gathers through ``recv_add_ell`` and ``halo_pull_idx``): no atomics,
so a rerun is bit-identical.

``compute_dtype="bfloat16"`` is JAX's ``md`` / ``store_dt`` (JAX
``ep_pack_forward`` :920-990): x, e, h0 and every layer's h bf16, each
kernel at ``mat_dtype`` bf16 (K5, K4 or K8/K9, K11; K2 per shard on the
zero-cut train step), while the correction, the wire rows, the received
rows and the readout stay f32.  ``cfg.ep_overlap`` runs each wired layer as
JAX's overlap path (:1006-1063): the two exchanges, K6 with
``act="linear"`` and no dropout for the local pre-activations, the compact
correction ``[recv ++ (pulled - p_wire)] @ W`` brought to the node slots
through a gather table made from ``recv_add_ell`` and ``halo_pull_idx`` (no
scatter-add) and to the edges at their senders, then act, hash dropout and
``store_dt``.  With
wired mean it warns once and runs the K9 path (JAX drops to its XLA glue
path there; the port has none, and K9 computes the same sums).  One stream
in one process runs everything in order, so nothing overlaps yet.
``cfg.ep_rdma_exchange`` sends every exchange through K12
(:mod:`.rdma_exchange`: one launch for all hops and shards) instead of
:class:`_RingExchange`'s copies.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..data.batch import device_tensor
from ..models.cgr_mpnn import (ACTIVATIONS, CGRMPNN, CGRMPNNConfig, _dropout,
                               _kernel_kw, _skips, _store_dtype,
                               kernel_grads_to_params, sum_partials)
from ..ops._launch import seed_list
from ..ops.bf16_ref import bf16_mm
from ..ops.conv_stack import conv_stack
from ..ops.fused_conv import fused_conv_layer, fused_conv_layer_r
from ..ops.fused_model import fused_model_train
from ..ops.gather_linear import gather_linear, gather_linear_pool
from ..ops.kernel_math import k_act, round_bf16
from ..ops.segment import gather_nodes, node_incoming_sum
from .edge_partition import EPOverflow, _ell_pack, _r8, _relabel_large
from .rdma_exchange import _ring_move, ring_exchange_rdma

__all__ = ["EPOverflow", "EPPackSpec", "EPPackedBatch", "pack_shard_edges",
           "empty_ep_pack_batch", "wire_bytes_per_layer", "ep_shards",
           "Exchange", "Psum", "ring_exchange", "run_lockstep",
           "run_distributed",
           "ep_pack_forward_shard", "ep_pack_forward",
           "supports_ep_fused_train", "ep_pack_fused_train",
           "make_ep_pack_train_step", "make_ep_pack_eval_step",
           "ring_moves"]

# runs of _RingExchange (forward and backward): 0 under --ep_rdma
ring_moves = 0


@dataclass(frozen=True)
class EPPackSpec:
    """Static per-shard pack geometry (hashable: the trainer keys its steps
    on it)."""
    n_ep: int
    te: int = 128            # edge slots per pack
    tn: int = 64             # node slots per pack
    p: int = 1               # packs per shard
    d: int = 8               # ELL width: max in-degree (node_inc)
    d2: int = 8              # ELL width: max out-degree (node_out)
    dr: int = 2              # ELL width: max peers referencing one owned node
    dn: int = 64             # ELL width: max owned nodes of one graph/shard
    b: int = 32              # graph slots
    caps: tuple[int, ...] = ()   # per-hop wire rows, len n_ep-1, 8-aligned
    gp: int = 8              # pool groups (fragments) per pack
    kg: int = 8              # ELL width: max fragments of one graph/shard

    @property
    def pn(self) -> int:
        return self.p * self.tn

    @property
    def pe(self) -> int:
        return self.p * self.te

    @property
    def tw(self) -> int:
        return int(sum(self.caps))


class EPPackedBatch(NamedTuple):
    """One edge-sharded batch in the pack-local layout (leading axis n_ep;
    numpy from the packer, one shard's tensors after :func:`ep_shards`).

    PN = p*tn node slots, PE = p*te edge slots, TW = sum(caps) wire rows,
    DD = max(d, d2).  Sentinels: PN for node slots, PE for edges, TW for
    wire rows, B for graphs, p*gp for pool groups.
    """
    node_x: np.ndarray         # [n_ep, PN, F]   owned + halo x (pad 0)
    edge_attr: np.ndarray      # [n_ep, PE, Fe]
    senders: np.ndarray        # [n_ep, PE]      pack slot of src (sent PN)
    dst: np.ndarray            # [n_ep, PE]      pack slot of dst (sent PN)
    node_inc: np.ndarray       # [n_ep, PN, D]   in-edges  (sent PE)
    node_out: np.ndarray       # [n_ep, PN, D2]  out-edges (sent PE)
    edge_nbr: np.ndarray       # [n_ep, PE, DD]  node_inc[senders] (sent PE)
    rev: np.ndarray            # [n_ep, PE]      e^1 on real edges (sent PE)
    edge_nbr_rev: np.ndarray   # [n_ep, PE, DD]  node_out[dst] (sent PE)
    wire_send_slot: np.ndarray # [n_ep, TW]      halo slot per push row (s PN)
    recv_dst_slot: np.ndarray  # [n_ep, TW]      owned slot per recv row (s PN)
    recv_add_ell: np.ndarray   # [n_ep, PN, DR]  recv rows per owned slot (s TW)
    halo_pull_idx: np.ndarray  # [n_ep, PN]      pull row per halo slot (s TW)
    halo_mask: np.ndarray      # [n_ep, PN] f32  1 on halo slots
    graph_nodes: np.ndarray    # [n_ep, B, DN]   owned slots per graph (s PN)
    node_graph: np.ndarray     # [n_ep, PN]      graph of owned slot (s B)
    inv_deg: np.ndarray        # [n_ep, PN] f32  GLOBAL 1/in-degree on every
                               #                 materialized slot
    labels: np.ndarray         # [n_ep, B]       identical copies
    graph_mask: np.ndarray     # [n_ep, B]
    node_group: np.ndarray     # [n_ep, PN]      pool group pack*GP+g of an
                               #                 owned slot (sent p*GP)
    graph_frag: np.ndarray     # [n_ep, B, KG]   pool groups per graph (s p*GP)
    pool_ell: np.ndarray       # [n_ep, p*GP, DN] owned slots per pool group
                               #                 (sent PN)
    group_graph: np.ndarray    # [n_ep, p*GP]    graph id per pool group (s B)


def _check(what: str, need: int, have: int) -> None:
    if need > have:
        raise EPOverflow(f"{what}: need {need} > pinned {have}")


def _kernel_ells(senders, dst, node_inc, node_out, PN: int, PE: int):
    """The kernels' per-edge ELL arrays of one shard: edge_nbr =
    node_inc[senders], rev, edge_nbr_rev = node_out[dst], both ELL arrays
    padded to max(d, d2) columns."""
    dd = max(node_inc.shape[1], node_out.shape[1])

    def rows_of(ell, idx):
        ext = np.full((PN + 1, dd), PE, np.int32)
        ext[:PN, :ell.shape[1]] = ell
        return ext[idx]

    ar = np.arange(PE, dtype=np.int32)
    rev = np.where(senders < PN, ar ^ 1, PE).astype(np.int32)
    return rows_of(node_inc, senders), rev, rows_of(node_out, dst)


def pack_shard_edges(graphs: Sequence, labels: Sequence[float], n_ep: int, *,
                     te: int = 128, tn: int = 64,
                     extra_node_feats: Sequence[np.ndarray] | None = None,
                     spec: EPPackSpec | None = None
                     ) -> tuple[EPPackedBatch, EPPackSpec]:
    """Shard whole graphs over ``n_ep`` and pack each shard block-dense.

    With ``spec`` the batch is built at the pinned sizes (raises
    :class:`EPOverflow` when exceeded: the loader grows pins and retries);
    without it the natural sizes become the returned spec.
    """
    n_graphs = len(graphs)
    if spec is not None:
        te, tn = spec.te, spec.tn
    if te % 2:
        raise ValueError("te must be even (pair-adjacent edge layout)")
    graphs, extra_node_feats = _relabel_large(graphs, extra_node_feats,
                                              threshold=max(16, tn))
    # ---- disjoint union -----------------------------------------------------
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
    send_g = np.concatenate([g.senders for g in graphs]).astype(np.int64) \
        + edge_off
    recv_g = np.concatenate([g.receivers for g in graphs]).astype(np.int64) \
        + edge_off
    graph_of = np.repeat(np.arange(n_graphs, dtype=np.int64), n_nodes)
    deg = np.bincount(recv_g, minlength=NT)

    # ---- ownership + pair assignment ---------------------------------------
    # whole graphs go to the least-loaded shard (LPT, balanced by edges);
    # only graphs bigger than an even shard share are striped in contiguous
    # node chunks over all shards
    owner_arr = np.empty(NT, np.int32)
    loads = np.zeros(n_ep, np.int64)
    giant_cut = max(1, int(np.ceil(n_edges.sum() / n_ep)))
    for gi in np.argsort(-n_edges, kind="stable"):
        glo, nn_g = int(node_off[gi]), int(n_nodes[gi])
        if int(n_edges[gi]) > giant_cut:
            chunk = max(1, int(np.ceil(nn_g / n_ep)))
            for k in range(n_ep):
                a = glo + k * chunk
                owner_arr[a:glo + min((k + 1) * chunk, nn_g)] = k
            loads += int(n_edges[gi]) // n_ep
        else:
            k = int(np.argmin(loads))
            owner_arr[glo:glo + nn_g] = k
            loads[k] += int(n_edges[gi])

    def owner(n):
        return owner_arr[n]

    pair_src, pair_dst = send_g[0::2], recv_g[0::2]
    pair_shard = owner(pair_src)       # pairs live with the even edge's src

    # ---- pass 1a: per-shard fragments ---------------------------------------
    F, Fe = x.shape[1], e_attr.shape[1]
    sh: list[dict] = []
    nat = dict(p=1, d=1, d2=1, dn=1, gp=1)
    max_frag_e = max_frag_n = 1
    for k in range(n_ep):
        owned = np.nonzero(owner_arr == k)[0].astype(np.int64)
        pr = np.nonzero(pair_shard == k)[0]
        u, v = pair_src[pr], pair_dst[pr]            # u always owned by k
        remotes = np.unique(v[owner(v) != k])
        n_own = len(owned)
        n_local = n_own + len(remotes)

        def lid(nodes):
            own = owner(nodes) == k
            return np.where(own, np.searchsorted(owned, nodes),
                            n_own + np.searchsorted(remotes, nodes))

        lu = lid(u).astype(np.int64)
        lv = lid(v).astype(np.int64)
        # fragment = this shard's piece of ONE graph (owned + halo nodes),
        # so a graph's pool is one group per shard even when it is
        # disconnected
        uni_ids = np.concatenate([owned, remotes])
        comp = (np.unique(graph_of[uni_ids], return_inverse=True)[1]
                if n_local else np.zeros(0, np.int64))
        ncomp = int(comp.max(initial=-1)) + 1
        frag_pairs = np.bincount(comp[lu], minlength=ncomp) if len(pr) \
            else np.zeros(ncomp, np.int64)
        frag_nodes = np.bincount(comp, minlength=ncomp)
        max_frag_e = max(max_frag_e, 2 * int(frag_pairs.max(initial=0)))
        max_frag_n = max(max_frag_n, int(frag_nodes.max(initial=0)))
        nat["dn"] = max(nat["dn"], int(np.bincount(
            graph_of[owned], minlength=1).max(initial=1)))
        sh.append(dict(owned=owned, remotes=remotes, n_own=n_own,
                       n_local=n_local, pr=pr, lu=lu, lv=lv, comp=comp,
                       ncomp=ncomp, frag_pairs=frag_pairs,
                       frag_nodes=frag_nodes,
                       uni=np.concatenate([owned, remotes])))

    # tile sizing: unpinned builds grow the tile to fit the largest
    # fragment; pinned builds raise EPOverflow so the loader can grow
    if max_frag_e > te or max_frag_n > tn:
        if spec is not None:
            raise EPOverflow(
                f"fragment ({max_frag_n} nodes / {max_frag_e} edges) "
                f"exceeds the pinned (te={te}, tn={tn}) tile")
        te = max(te, 2 * _r8(-(-max_frag_e // 2), lo=4))
        tn = max(tn, _r8(max_frag_n))

    # ---- pass 1b: best-fit-decreasing fragments into packs, slots ----------
    for k in range(n_ep):
        s = sh[k]
        ncomp, comp = s["ncomp"], s["comp"]
        frag_pairs, frag_nodes = s["frag_pairs"], s["frag_nodes"]
        pr, lu, lv = s["pr"], s["lu"], s["lv"]
        n_local = s["n_local"]
        order = np.lexsort((-frag_nodes, -frag_pairs))
        pack_of_frag = np.full(ncomp, -1, np.int64)
        e_fill: list[int] = []
        n_fill: list[int] = []
        for f in order:
            fe_, fn_ = 2 * int(frag_pairs[f]), int(frag_nodes[f])
            # tightest edge slack wins (ties: node slack, then index)
            pk, best = -1, None
            for q in range(len(e_fill)):
                if e_fill[q] + fe_ <= te and n_fill[q] + fn_ <= tn:
                    key = (te - e_fill[q] - fe_) * (tn + 1) \
                        + (tn - n_fill[q] - fn_)
                    if best is None or key < best:
                        pk, best = q, key
            if pk < 0:
                pk = len(e_fill)
                e_fill.append(0)
                n_fill.append(0)
            pack_of_frag[f] = pk
            e_fill[pk] += fe_
            n_fill[pk] += fn_
        p_used = max(1, len(e_fill))
        nat["p"] = max(nat["p"], p_used)

        # node slots: fragments of a pack laid out consecutively
        pk_node = pack_of_frag[comp] if ncomp else np.zeros(0, np.int64)
        order_n = np.lexsort((np.arange(n_local), comp, pk_node))
        pk_sorted = pk_node[order_n]
        cnts = np.bincount(pk_sorted, minlength=p_used)
        starts = np.concatenate([[0], np.cumsum(cnts)[:-1]])
        rank = np.arange(n_local) - np.repeat(starts, cnts)
        slot = np.empty(n_local, np.int64)
        slot[order_n] = pk_sorted * tn + rank

        # edge slots: pairs of a pack consecutive, pair i -> (2i, 2i+1)
        if len(pr):
            pk_pair = pack_of_frag[comp[lu]]
            order_p = np.lexsort((np.arange(len(pr)), comp[lu], pk_pair))
            pkp = pk_pair[order_p]
            pcnt = np.bincount(pkp, minlength=p_used)
            pstart = np.concatenate([[0], np.cumsum(pcnt)[:-1]])
            prank = np.arange(len(pr)) - np.repeat(pstart, pcnt)
            s0 = pkp * te + 2 * prank
        else:
            order_p = np.zeros(0, np.int64)
            s0 = np.zeros(0, np.int64)
        # pool groups: fragments of a pack numbered by fragment id; owned
        # slots carry pack*GP+group
        if ncomp:
            go = np.lexsort((np.arange(ncomp), pack_of_frag))
            gcnt = np.bincount(pack_of_frag, minlength=p_used)
            gstart = np.concatenate([[0], np.cumsum(gcnt)[:-1]])
            grank = np.arange(ncomp) - np.repeat(gstart, gcnt)
            group_of_frag = np.empty(ncomp, np.int64)
            group_of_frag[go] = grank
            nat["gp"] = max(nat.get("gp", 1), int(gcnt.max(initial=1)))
        else:
            group_of_frag = np.zeros(0, np.int64)
            nat["gp"] = max(nat.get("gp", 1), 1)
        s.update(slot=slot, order_p=order_p, s0=s0, p_used=p_used,
                 pof=pack_of_frag, gof=group_of_frag)

    # ---- wire caps (hop h moves k -> (k+h) % n_ep rows) ----------------------
    counts = np.zeros((n_ep, n_ep), np.int64)       # [shard, hop]
    for k in range(n_ep):
        rem = sh[k]["remotes"]
        if len(rem):
            hops = (owner(rem) - k) % n_ep
            counts[k] += np.bincount(hops, minlength=n_ep)
    nat_caps = tuple(_r8(int(counts[:, h].max(initial=0)), lo=8)
                     if counts[:, h].max(initial=0) else 0
                     for h in range(1, n_ep))

    # ---- resolve spec (pins) -------------------------------------------------
    if spec is not None:
        _check("packs p", nat["p"], spec.p)
        _check("graphs b", n_graphs, spec.b)
        if len(spec.caps) != n_ep - 1:
            raise ValueError(f"spec.caps length {len(spec.caps)} != "
                             f"n_ep-1 = {n_ep - 1}")
        for h, (need, have) in enumerate(zip(nat_caps, spec.caps), 1):
            _check(f"wire cap hop {h}", need, have)
        out_spec = spec
    else:
        out_spec = None      # finalized after ELL widths are known
    p_cap = spec.p if spec else nat["p"]
    b_cap = spec.b if spec else n_graphs
    dn_cap = spec.dn if spec else nat["dn"]
    gp_cap = spec.gp if spec else _r8(nat["gp"])
    if spec is not None:
        _check("ELL dn", nat["dn"], spec.dn)
        _check("pool gp", nat["gp"], spec.gp)
    caps = spec.caps if spec else nat_caps
    PN, PE, TW = p_cap * tn, p_cap * te, int(sum(caps))
    g_sent = p_cap * gp_cap      # pool-group sentinel
    hop_off = np.concatenate([[0], np.cumsum(caps)]).astype(np.int64)

    # ---- pass 2: emit arrays -------------------------------------------------
    node_x = np.zeros((n_ep, PN, F), np.float32)
    edge_attr = np.zeros((n_ep, PE, Fe), np.float32)
    senders = np.full((n_ep, PE), PN, np.int32)
    dst = np.full((n_ep, PE), PN, np.int32)
    wire_send_slot = np.full((n_ep, TW), PN, np.int32)
    recv_dst_slot = np.full((n_ep, TW), PN, np.int32)
    halo_pull_idx = np.full((n_ep, PN), TW, np.int32)
    halo_mask = np.zeros((n_ep, PN), np.float32)
    node_graph = np.full((n_ep, PN), b_cap, np.int32)
    inv_deg = np.zeros((n_ep, PN), np.float32)
    graph_nodes = np.empty((n_ep, b_cap, dn_cap), np.int32)
    node_group = np.full((n_ep, PN), g_sent, np.int32)
    pool_ell = np.full((n_ep, p_cap * gp_cap, dn_cap), PN, np.int32)
    group_graph = np.full((n_ep, p_cap * gp_cap), b_cap, np.int32)

    d_nat = d2_nat = dr_nat = kg_nat = 1
    inc_rows, inc_vals, out_rows, out_vals = [], [], [], []
    gf_rows, gf_vals = [], []
    for k in range(n_ep):
        s = sh[k]
        slot, uni = s["slot"], s["uni"]
        node_x[k, slot] = x[uni]
        if len(s["pr"]):
            prs = s["pr"][s["order_p"]]
            lus, lvs = s["lu"][s["order_p"]], s["lv"][s["order_p"]]
            s0, s1 = s["s0"], s["s0"] + 1
            edge_attr[k, s0] = e_attr[2 * prs]
            edge_attr[k, s1] = e_attr[2 * prs + 1]
            senders[k, s0] = slot[lus]
            senders[k, s1] = slot[lvs]
            dst[k, s0] = slot[lvs]
            dst[k, s1] = slot[lus]
            er = np.concatenate([s0, s1])
            inc_rows.append(dst[k, er].astype(np.int64))
            inc_vals.append(er)
            out_rows.append(senders[k, er].astype(np.int64))
            out_vals.append(er)
            d_nat = max(d_nat, int(np.bincount(inc_rows[-1]).max()))
            d2_nat = max(d2_nat, int(np.bincount(out_rows[-1]).max()))
        else:
            inc_rows.append(np.zeros(0, np.int64))
            inc_vals.append(np.zeros(0, np.int64))
            out_rows.append(np.zeros(0, np.int64))
            out_vals.append(np.zeros(0, np.int64))
        # pooling + degree over owned slots
        oslot = slot[:s["n_own"]]
        g_own = graph_of[s["owned"]]
        node_graph[k, oslot] = g_own
        graph_nodes[k] = _ell_pack(g_own, oslot, b_cap, dn_cap, PN,
                                   "graph_nodes")
        # GLOBAL 1/in-degree on every materialized slot, owned AND halo (the
        # wired-mean column scale reads src slots)
        dg_all = deg[uni]
        nz_all = dg_all > 0
        inv_deg[k, slot[nz_all]] = (1.0 / dg_all[nz_all]).astype(np.float32)
        # pool tables: owned slots carry pack*GP+group of their fragment;
        # per-graph fragment lists feed the cross-pack combine
        comp, pof, gof = s["comp"], s["pof"], s["gof"]
        if s["n_own"]:
            gid_local = pof[comp] * gp_cap + gof[comp]      # per local node
            node_group[k, oslot] = gid_local[:s["n_own"]]
            pool_ell[k] = _ell_pack(gid_local[:s["n_own"]], oslot,
                                    p_cap * gp_cap, dn_cap, PN, "pool ELL")
        if s["ncomp"]:
            fi = np.full(s["ncomp"], s["n_local"], np.int64)
            np.minimum.at(fi, comp, np.arange(s["n_local"]))
            frag_graph = graph_of[s["uni"][fi]]
            frag_gid = pof * gp_cap + gof
            kg_nat = max(kg_nat, int(np.bincount(
                frag_graph, minlength=1).max(initial=1)))
            gf_rows.append(frag_graph)
            gf_vals.append(frag_gid)
            group_graph[k, frag_gid] = frag_graph
        else:
            gf_rows.append(np.zeros(0, np.int64))
            gf_vals.append(np.zeros(0, np.int64))
        # wire: this shard's halo rows, hop-grouped, v-ascending both sides
        rem = s["remotes"]
        if len(rem):
            hops = (owner(rem) - k) % n_ep
            horder = np.lexsort((rem, hops))
            rem_s, hop_s = rem[horder], hops[horder]
            within = np.arange(len(rem_s)) - np.repeat(
                np.concatenate([[0], np.cumsum(np.bincount(
                    hop_s, minlength=n_ep))[:-1]]),
                np.bincount(hop_s, minlength=n_ep))
            rows = hop_off[hop_s - 1] + within
            hslot = slot[s["n_own"] + np.searchsorted(rem, rem_s)]
            wire_send_slot[k, rows] = hslot
            halo_pull_idx[k, hslot] = rows
            halo_mask[k, hslot] = 1.0

    # receiver side: shard j, hop h receives from k=(j-h); same (h, v) order
    recv_r, recv_v = [[] for _ in range(n_ep)], [[] for _ in range(n_ep)]
    for k in range(n_ep):
        rem = sh[k]["remotes"]
        if not len(rem):
            continue
        hops = (owner(rem) - k) % n_ep
        horder = np.lexsort((rem, hops))
        rem_s, hop_s = rem[horder], hops[horder]
        within = np.arange(len(rem_s)) - np.repeat(
            np.concatenate([[0], np.cumsum(np.bincount(
                hop_s, minlength=n_ep))[:-1]]),
            np.bincount(hop_s, minlength=n_ep))
        rows = hop_off[hop_s - 1] + within
        owners = owner(rem_s)
        for j in np.unique(owners):
            m = owners == j
            sj = sh[j]
            oslot = sj["slot"][np.searchsorted(sj["owned"], rem_s[m])]
            recv_dst_slot[j, rows[m]] = oslot
            recv_r[j].append(oslot.astype(np.int64))
            recv_v[j].append(rows[m])

    recv_add_ell_cols = []
    for j in range(n_ep):
        r = np.concatenate(recv_r[j]) if recv_r[j] else np.zeros(0, np.int64)
        if len(r):
            dr_nat = max(dr_nat, int(np.bincount(r).max()))
        recv_add_ell_cols.append(r)

    d_cap = spec.d if spec else d_nat
    d2_cap = spec.d2 if spec else d2_nat
    dr_cap = spec.dr if spec else dr_nat
    kg_cap = spec.kg if spec else kg_nat
    if spec is not None:
        _check("ELL d", d_nat, spec.d)
        _check("ELL d2", d2_nat, spec.d2)
        _check("ELL dr", dr_nat, spec.dr)
        _check("pool kg", kg_nat, spec.kg)

    node_inc = np.empty((n_ep, PN, d_cap), np.int32)
    node_out = np.empty((n_ep, PN, d2_cap), np.int32)
    recv_add_ell = np.empty((n_ep, PN, dr_cap), np.int32)
    for k in range(n_ep):
        node_inc[k] = _ell_pack(inc_rows[k], inc_vals[k], PN, d_cap, PE,
                                "node_inc")
        node_out[k] = _ell_pack(out_rows[k], out_vals[k], PN, d2_cap, PE,
                                "node_out")
        r = recv_add_ell_cols[k]
        v = (np.concatenate(recv_v[k]) if recv_v[k]
             else np.zeros(0, np.int64))
        recv_add_ell[k] = _ell_pack(r, v, PN, dr_cap, TW, "recv_add_ell")

    graph_frag = np.empty((n_ep, b_cap, kg_cap), np.int32)
    for k in range(n_ep):
        graph_frag[k] = _ell_pack(gf_rows[k], gf_vals[k], b_cap, kg_cap,
                                  g_sent, "graph_frag")

    if out_spec is None:
        out_spec = EPPackSpec(n_ep=n_ep, te=te, tn=tn, p=p_cap, d=d_cap,
                              d2=d2_cap, dr=dr_cap, dn=dn_cap, b=b_cap,
                              caps=caps, gp=gp_cap, kg=kg_cap)

    ells = [_kernel_ells(senders[k], dst[k], node_inc[k], node_out[k], PN, PE)
            for k in range(n_ep)]
    edge_nbr, rev, edge_nbr_rev = (np.stack(a) for a in zip(*ells))

    labels_out = np.zeros((n_ep, b_cap), np.float32)
    labels_out[:, :n_graphs] = np.asarray(labels, np.float32)[None]
    graph_mask = np.zeros((n_ep, b_cap), np.float32)
    graph_mask[:, :n_graphs] = 1.0

    return EPPackedBatch(node_x, edge_attr, senders, dst, node_inc, node_out,
                         edge_nbr, rev, edge_nbr_rev, wire_send_slot,
                         recv_dst_slot, recv_add_ell, halo_pull_idx,
                         halo_mask, graph_nodes, node_graph, inv_deg,
                         labels_out, graph_mask, node_group, graph_frag,
                         pool_ell, group_graph), out_spec


def empty_ep_pack_batch(spec: EPPackSpec, n_feat: int, e_feat: int
                        ) -> EPPackedBatch:
    """All-sentinel batch (mask 0): its loss and gradients are exactly 0."""
    n_ep, PN, PE, TW, B = (spec.n_ep, spec.pn, spec.pe, spec.tw, spec.b)
    dd = max(spec.d, spec.d2)
    G = spec.p * spec.gp
    return EPPackedBatch(
        node_x=np.zeros((n_ep, PN, n_feat), np.float32),
        edge_attr=np.zeros((n_ep, PE, e_feat), np.float32),
        senders=np.full((n_ep, PE), PN, np.int32),
        dst=np.full((n_ep, PE), PN, np.int32),
        node_inc=np.full((n_ep, PN, spec.d), PE, np.int32),
        node_out=np.full((n_ep, PN, spec.d2), PE, np.int32),
        edge_nbr=np.full((n_ep, PE, dd), PE, np.int32),
        rev=np.full((n_ep, PE), PE, np.int32),
        edge_nbr_rev=np.full((n_ep, PE, dd), PE, np.int32),
        wire_send_slot=np.full((n_ep, TW), PN, np.int32),
        recv_dst_slot=np.full((n_ep, TW), PN, np.int32),
        recv_add_ell=np.full((n_ep, PN, spec.dr), TW, np.int32),
        halo_pull_idx=np.full((n_ep, PN), TW, np.int32),
        halo_mask=np.zeros((n_ep, PN), np.float32),
        graph_nodes=np.full((n_ep, B, spec.dn), PN, np.int32),
        node_graph=np.full((n_ep, PN), B, np.int32),
        inv_deg=np.zeros((n_ep, PN), np.float32),
        labels=np.zeros((n_ep, B), np.float32),
        graph_mask=np.zeros((n_ep, B), np.float32),
        node_group=np.full((n_ep, PN), G, np.int32),
        graph_frag=np.full((n_ep, B, spec.kg), G, np.int32),
        pool_ell=np.full((n_ep, G, spec.dn), PN, np.int32),
        group_graph=np.full((n_ep, G), B, np.int32))


def wire_bytes_per_layer(spec: EPPackSpec, hidden: int,
                         bytes_per_el: int = 4) -> int:
    """Bytes exchanged per D-MPNN layer per shard: push + pull of TW rows."""
    return 2 * spec.tw * hidden * bytes_per_el


def ep_shards(batch: EPPackedBatch, device) -> list[EPPackedBatch]:
    """The shards of ``batch`` (leaves [n_ep, ...]) as tensors on
    ``device``, one :class:`EPPackedBatch` per shard."""
    n_ep = batch.node_x.shape[0]
    return [EPPackedBatch(*(device_tensor(a[k], device) for a in batch))
            for k in range(n_ep)]


# ---------------------------------------------------------------------------
# the wire glue of one shard: every op a gather, every adjoint a gather
# ---------------------------------------------------------------------------

def _take0(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather with the sentinel (and anything past it) -> a zero row;
    a 2-D ``idx`` sums its columns."""
    return (node_incoming_sum(src, idx) if idx.dim() == 2
            else gather_nodes(src, idx))


class _PairGather(torch.autograd.Function):
    """out = take0(src, idx) · out_mask; the adjoint is the gather
    take0(g · out_mask, adj) · in_mask through the transposed index array
    ``adj`` (no scatter).  A mask of None is 1."""

    @staticmethod
    def forward(ctx, src, idx, adj, out_mask, in_mask):
        ctx.save_for_backward(adj, out_mask, in_mask)
        out = _take0(src, idx)
        return out if out_mask is None else out * out_mask[:, None]

    @staticmethod
    def backward(ctx, g):
        adj, out_mask, in_mask = ctx.saved_tensors
        if out_mask is not None:
            g = g * out_mask[:, None]
        d = _take0(g, adj)
        return (d if in_mask is None else d * in_mask[:, None],
                None, None, None, None)


def _node_partial(h, b: EPPackedBatch):
    """a[n] = Σ h over the shard's in-edges of node slot n (node_inc);
    adjoint dh[e] = g[dst[e]]."""
    return _PairGather.apply(h, b.node_inc, b.dst, None, None)


def _wire_gather(a, b: EPPackedBatch):
    """wire[t] = a[wire_send_slot[t]]: injective on real rows, so the
    adjoint is the halo-indexed gather."""
    return _PairGather.apply(a, b.wire_send_slot, b.halo_pull_idx, None,
                             b.halo_mask)


def _serve_gather(a, b: EPPackedBatch):
    """serve[t] = a[recv_dst_slot[t]]: dst slots may repeat (several peers
    reference one owned node), so the adjoint is the recv-add ELL sum."""
    return _PairGather.apply(a, b.recv_dst_slot, b.recv_add_ell, None, None)


def _recv_add(recv, b: EPPackedBatch):
    """The received rows summed onto their owned slots (the JAX
    ``.at[recv_dst_slot].add(recv)``) as the gather through recv_add_ell;
    the adjoint of :func:`_serve_gather`."""
    return _PairGather.apply(recv, b.recv_add_ell, b.recv_dst_slot, None,
                             None)


def _halo_swap(a, pulled, b: EPPackedBatch):
    """Replace the halo rows of ``a`` with pulled rows (the JAX
    ``.at[wire_send_slot].add`` onto halo slots, as a gather through
    halo_pull_idx)."""
    m = b.halo_mask[:, None]
    return a * (1.0 - m) + _PairGather.apply(pulled, b.halo_pull_idx,
                                             b.wire_send_slot, b.halo_mask,
                                             None)


def _combine_groups(pool_part, b: EPPackedBatch):
    """pool[g] = Σ over graph g's pool groups of this shard (graph_frag);
    adjoint through group_graph."""
    return _PairGather.apply(pool_part, b.graph_frag, b.group_graph, None,
                             None)


# ---------------------------------------------------------------------------
# collectives, and the in-process lockstep that runs them
# ---------------------------------------------------------------------------

class Exchange(NamedTuple):
    """A shard's request: send ``buf`` [TW, H] around the hop-aligned ring
    (``inverse``: back), receive its peers' rows."""
    buf: torch.Tensor
    inverse: bool = False


class Psum(NamedTuple):
    """A shard's request: the sum of ``value`` over all shards."""
    value: torch.Tensor


class _RingExchange(torch.autograd.Function):
    """Hop h moves the block [off_h, off_h + caps[h-1]) of shard k's buffer
    to shard k + h (``inverse``: to k - h).  The adjoint is the inverse
    exchange."""

    @staticmethod
    def forward(ctx, caps, inverse, *bufs):
        global ring_moves
        ring_moves += 1
        ctx.caps, ctx.inverse = caps, inverse
        return tuple(_ring_move(bufs, caps, inverse))

    @staticmethod
    def backward(ctx, *grads):
        global ring_moves
        ring_moves += 1
        return (None, None, *_ring_move(grads, ctx.caps, not ctx.inverse))


def ring_exchange(bufs: list, caps: tuple[int, ...],
                  inverse: bool = False) -> list:
    """The ring exchange of every shard's buffer in this process."""
    return list(_RingExchange.apply(tuple(caps), inverse, *bufs))


def _rank_ring_move(buf: torch.Tensor, caps: tuple[int, ...], inverse: bool,
                    comm) -> torch.Tensor:
    """:func:`_ring_move` between the ranks of an EP group: hop h sends
    this shard's block h to shard k + h (``inverse``: k - h) and receives
    shard k - h's (k + h's) in its place.  Gloo's point-to-point calls take
    host tensors, so the blocks go through host memory."""
    import torch.distributed as dist
    n, k = len(comm.ranks), comm.shard
    host = buf.detach().to("cpu").contiguous()
    out = torch.empty_like(host)
    reqs, off = [], 0
    for h, s_h in enumerate(caps, start=1):
        if s_h:
            to, frm = ((k - h) % n, (k + h) % n) if inverse else \
                ((k + h) % n, (k - h) % n)
            reqs.append(dist.isend(host[off:off + s_h], comm.ranks[to],
                                   tag=h))
            reqs.append(dist.irecv(out[off:off + s_h], comm.ranks[frm],
                                   tag=h))
        off += s_h
    for r in reqs:
        r.wait()
    return out.to(buf.device)


class _RankExchange(torch.autograd.Function):
    """This rank's share of :class:`_RingExchange` (layout (b): one shard a
    rank): its buffer out, its peers' rows in.  The adjoint is the inverse
    exchange between the same ranks."""

    @staticmethod
    def forward(ctx, buf, caps, inverse, comm):
        ctx.caps, ctx.inverse, ctx.comm = caps, inverse, comm
        return _rank_ring_move(buf, caps, inverse, comm)

    @staticmethod
    def backward(ctx, g):
        return (_rank_ring_move(g, ctx.caps, not ctx.inverse, ctx.comm),
                None, None, None)


class _GroupSum(torch.autograd.Function):
    """A :class:`Psum` over the ranks of an EP group; the backward is the
    identity: each rank holds the group's loss, computed from the summed
    value, and takes its own share of the gradient from it."""

    @staticmethod
    def forward(ctx, value, comm):
        from .multihost import all_reduce_host_
        return all_reduce_host_(value.detach().clone(), comm.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def run_distributed(gen, caps: tuple[int, ...], comm):
    """The per-rank counterpart of :func:`run_lockstep` (layout (b)): runs
    this rank's one shard generator and serves its requests through the
    process group of ``comm`` (``multihost.ep_comm``) -- an
    :class:`Exchange` as the ring move between the group's ranks, a
    :class:`Psum` as an all-reduce over them; returns its return value.
    Every rank of the group must run it on the same spec."""
    send = None
    while True:
        try:
            req = gen.send(send)
        except StopIteration as stop:
            return stop.value
        if type(req) is Exchange:
            send = _RankExchange.apply(req.buf, tuple(caps), req.inverse,
                                       comm)
        else:
            send = _GroupSum.apply(req.value, comm)


def run_lockstep(gens: list, caps: tuple[int, ...],
                 rdma: bool = False) -> list:
    """Run one generator per shard in lockstep: each runs to its next
    :class:`Exchange` or :class:`Psum`, the collective runs over all of
    them, and each resumes with its share; returns their return values.
    With ``rdma`` the exchanges go through K12 (:func:`ring_exchange_rdma`)
    instead of :func:`ring_exchange`."""
    exchange = ring_exchange_rdma if rdma else ring_exchange
    n = len(gens)
    sends: list = [None] * n
    while True:
        reqs, done = [], []
        for g, v in zip(gens, sends):
            try:
                reqs.append(g.send(v))
            except StopIteration as stop:
                done.append(stop.value)
        if done:
            if len(done) != n:
                raise RuntimeError("the shards left the lockstep at "
                                   "different collectives")
            return done
        kind = type(reqs[0])
        if any(type(r) is not kind for r in reqs):
            raise RuntimeError("the shards asked for different collectives")
        if kind is Exchange:
            sends = exchange([r.buf for r in reqs], caps, reqs[0].inverse)
        else:
            total = reqs[0].value
            for r in reqs[1:]:
                total = total + r.value
            sends = [total] * n


# ---------------------------------------------------------------------------
# the EP forward of one shard
# ---------------------------------------------------------------------------

_overlap_wired_mean_warned = False


def _warn_overlap_wired_mean_once() -> None:
    """``ep_overlap`` with aggr='mean' on a wired spec: the overlap path's
    correction, applied after the linear-activation kernel, cannot carry
    the global mean scale through the product, so the run takes the K9
    path instead; say so once (JAX ``_warn_overlap_wired_mean_once``)."""
    global _overlap_wired_mean_warned
    if not _overlap_wired_mean_warned:
        _overlap_wired_mean_warned = True
        warnings.warn(
            "--ep_overlap with aggr='mean' on an edge-partition spec with a "
            "non-empty cut runs the wired-mean layers through K9 "
            "(fused_conv_layer_r with the global scale), as without "
            "--ep_overlap", stacklevel=3)


def _exchanges(h, b: EPPackedBatch):
    """The push and the pull of one wired layer on h (f32): (recv, r_recv,
    pulled - p_wire) -- the received rows [TW, H], them summed on their
    owned slots [PN, H], and the pulled complete sums less the local
    partials sent [TW, H]."""
    a_loc = _node_partial(h, b)
    p_wire = _wire_gather(a_loc, b)
    recv = yield Exchange(p_wire)
    r_recv = _recv_add(recv, b)
    pulled = yield Exchange(_serve_gather(a_loc + r_recv, b), inverse=True)
    return recv, r_recv, pulled - p_wire


def _correction(h, b: EPPackedBatch):
    """r [PN, H]: the remote incoming-sum partials of each node slot --
    received rows on owned boundary slots, (pulled complete - local partial)
    on halo slots, zero elsewhere -- so that the conv kernel's local
    messages plus r at the sender are the complete sums (push, then pull)."""
    _, r_recv, d_pull = yield from _exchanges(h, b)
    return _halo_swap(r_recv, d_pull, b)


def _recv_only(h, b: EPPackedBatch):
    """r_s [PN, H]: the received remote partials on owned slots (the readout
    pools owned slots only, so no pull hop)."""
    recv = yield Exchange(_wire_gather(_node_partial(h, b), b))
    return _recv_add(recv, b)


def _overlap_tables(b: EPPackedBatch, tw: int):
    """The overlap path's gather tables between the node slots and the
    rows of [recv ++ (pulled - p_wire)] (sentinel 2·TW): (corr_ell [PN,
    DR+1], each slot's received rows (recv_add_ell) then its pull row (halo
    slots); slots2 [2·TW], recv_dst_slot ++ wire_send_slot, its adjoint).
    Built once per batch on the batch's device."""
    ra, pull = b.recv_add_ell, b.halo_pull_idx
    corr_ell = torch.cat([torch.where(ra < tw, ra, 2 * tw),
                          torch.where(pull < tw, pull + tw, 2 * tw)[:, None]],
                         dim=1).to(torch.int32)
    return corr_ell, torch.cat([b.recv_dst_slot, b.wire_send_slot])


def _overlap_correction(recv, d_pull, w, tables, b: EPPackedBatch, bf16):
    """The overlap path's boundary term at each edge [PE, H]: rw = [recv ++
    (pulled - p_wire)] @ w (operands bf16 at bf16, f32 sums), its rows
    summed onto their node slots through ``corr_ell`` (adjoint: the gather
    through ``slots2``; both from :func:`_overlap_tables`), then taken at
    each edge's sender (adjoint: the sum through node_out)."""
    rows2 = torch.cat([recv, d_pull])
    rw = bf16_mm(rows2, w) if bf16 else rows2 @ w
    nodes = _PairGather.apply(rw, *tables, None, None)
    return _PairGather.apply(nodes, b.senders, b.node_out, None, None)


def ep_pack_forward_shard(model: CGRMPNN, b: EPPackedBatch, spec: EPPackSpec,
                          *, train: bool = False, seeds=None):
    """One shard's EP forward, a generator (see the module doc): yields its
    collectives and returns (the full-batch masked SSE -- the same on every
    shard -- and preds [B]).  ``seeds`` holds this shard's int32 dropout
    seed per conv layer (train mode)."""
    cfg = model.cfg
    if train and seeds is None:
        raise ValueError("train mode needs one dropout seed per conv layer")
    kact = ACTIVATIONS[cfg.activation]
    md = cfg.compute_dtype
    bf16 = md == "bfloat16"
    # fd: the correction's, the wire's and the readout's type (f32, or
    # float64 for a float64 evaluation); sd: x, e and the edge states
    fd = model.ffn.w.dtype
    sd = _store_dtype(cfg) if bf16 else fd
    p, tn, H = spec.p, spec.tn, cfg.hidden
    has_wire = any(c > 0 for c in spec.caps)
    wired_mean = cfg.aggr == "mean" and has_wire
    if cfg.ep_overlap and wired_mean:
        _warn_overlap_wired_mean_once()
    overlap = cfg.ep_overlap and has_wire and not wired_mean
    x, e = b.node_x.to(sd), b.edge_attr.to(sd)
    F = x.shape[1]
    wei, wen = model.edge_init, model.edge_to_node
    h0 = gather_linear(x, e, b.senders[:, None], b.node_out, wei.w[:F],
                       wei.w[F:], wei.b, p=p, act=kact, mat_dtype=md,
                       out_dtype=md)
    skips = _skips(model, x.device)
    if not has_wire:
        # no boundary at this width: the whole depth as one stack kernel
        h = conv_stack(h0, b.edge_nbr, b.rev, b.edge_nbr_rev,
                       torch.stack([c.w for c in model.convs]),
                       torch.stack([c.b for c in model.convs]), skips, p=p,
                       act=kact, mean=cfg.aggr == "mean", train=train,
                       seeds=seeds if train else None,
                       dropout_ps=tuple(cfg.dropout_ps) if train else (),
                       mat_dtype=md)
    else:
        # per-edge GLOBAL 1/in-degree of the sender (0 on padding edges)
        scale = (_take0(b.inv_deg[:, None], b.senders)[:, 0].contiguous()
                 if wired_mean else None)
        tables = _overlap_tables(b, spec.tw) if overlap else None
        # seeds on the card stay there (a 0-dim view a layer, no host
        # read); host seeds become ints
        if not train:
            layer_seeds = [None] * cfg.depth
        elif torch.is_tensor(seeds) and seeds.is_cuda:
            layer_seeds = list(seeds)
        else:
            layer_seeds = seed_list(seeds)
        h = h0
        for l, conv in enumerate(model.convs):
            rate = cfg.dropout_ps[l] if train else 0.0
            if overlap:
                recv, _, d_pull = yield from _exchanges(h.to(fd), b)
                # the local pre-activations, independent of the exchanges
                pre = fused_conv_layer(
                    h, h0, b.edge_nbr, b.rev, b.edge_nbr_rev, conv.w, conv.b,
                    skips[l], p=p, act="linear", mat_dtype=md,
                    out_dtype="float32")
                corr = _overlap_correction(recv, d_pull, conv.w, tables, b,
                                           bf16)
                out = k_act(kact, pre.to(fd) + corr)
                if rate > 0.0:
                    out = _dropout(out, rate, layer_seeds[l], spec.te)
                h = out.to(sd)
                continue
            r = yield from _correction(h.to(fd), b)
            h = fused_conv_layer_r(
                h, r, h0, b.edge_nbr, b.rev, b.edge_nbr_rev, b.senders,
                b.node_out, conv.w, conv.b, skips[l], p=p, tn=tn, scale=scale,
                act=kact, train=train, seed=layer_seeds[l], dropout_p=rate,
                mat_dtype=md)
    # readout + per-pack group pool in one kernel (only the push hop: the
    # pool reads owned slots), then the groups of each graph combined
    if has_wire:
        r_s = yield from _recv_only(h.to(fd), b)
    else:
        r_s = h.new_zeros((p * tn, H), dtype=fd)
    h_ro, ro_mean = h, cfg.aggr == "mean"
    if wired_mean:
        # the global mean as the add kernel on scaled rows: each edge feeds
        # exactly one node dst(e), so h rows take inv_deg[dst(e)] and r_s
        # rows inv_deg[v]
        h_ro = (h.to(fd) * _take0(b.inv_deg[:, None], b.dst)).to(h.dtype)
        r_s = r_s * b.inv_deg[:, None]
        ro_mean = False
    _, pool_part = gather_linear_pool(
        h_ro, r_s, x, b.node_inc, b.dst[:, None], b.node_group, b.pool_ell,
        wen.w[F:], wen.w[:F], wen.b, p=p, act=kact, mean=ro_mean,
        mat_dtype=md)
    pool = _combine_groups(pool_part, b)
    if cfg.pooling == "mean":
        # the shard's pool rows are partial sums: divide by the graph's
        # node count over all shards
        local_cnt = (b.graph_nodes < spec.pn).sum(dim=1).to(fd)
        cnt = yield Psum(local_cnt)
        pool = pool * torch.where(cnt > 0, 1.0 / cnt.clamp_min(1.0),
                                  0.0)[:, None]
    # the ffn bias split as b/n_ep, so the sum over shards is exact
    w_ffn = model.ffn.w
    if bf16:
        pool, w_ffn = round_bf16(pool), round_bf16(w_ffn)
    z = pool @ w_ffn + model.ffn.b / spec.n_ep
    preds = (yield Psum(z))[:, 0]
    err = (preds - b.labels) * b.graph_mask
    return (err * err).sum(), preds


def ep_pack_forward(model: CGRMPNN, shards: list, spec: EPPackSpec, *,
                    train: bool = False, seeds=None, comm=None):
    """The EP forward over every shard in this process -> (full-batch SSE,
    preds [B]).  ``seeds`` [n_ep, depth]: one dropout seed per shard and
    conv layer (train mode).  With ``comm`` (``multihost.ep_comm``: one
    shard a rank) ``shards`` is this rank's one shard and its peers run on
    the other ranks of the group (:func:`run_distributed`)."""
    if comm is not None:
        if len(shards) != 1:
            raise ValueError(f"{len(shards)} shards on a rank of an EP group")
        return run_distributed(ep_pack_forward_shard(
            model, shards[0], spec, train=train,
            seeds=None if seeds is None else seeds[0]), spec.caps, comm)
    if len(shards) != spec.n_ep:
        raise ValueError(f"{len(shards)} shards for n_ep={spec.n_ep}")
    gens = [ep_pack_forward_shard(model, b, spec, train=train,
                                  seeds=None if seeds is None else seeds[k])
            for k, b in enumerate(shards)]
    (sse, preds), *_ = run_lockstep(gens, spec.caps,
                                    model.cfg.ep_rdma_exchange)
    return sse, preds


# ---------------------------------------------------------------------------
# the zero-cut one-kernel step, and the in-process steps
# ---------------------------------------------------------------------------

def supports_ep_fused_train(cfg: CGRMPNNConfig, spec: EPPackSpec) -> bool:
    """Whether the one-kernel training step applies: the whole-model
    configuration and no boundary exchange in the spec (each pool group is
    then a whole graph, and the kernel's in-pack degrees are the true
    ones)."""
    return cfg.fuse_whole_model and not any(c > 0 for c in spec.caps)


def _ep_kernel_batch(b: EPPackedBatch, spec: EPPackSpec) -> tuple:
    """A shard as the whole-model kernels' batch: the pool groups (p*gp)
    are the graphs, pool_ell their node lists, node_group the graph of
    each node; node_inc padded to the edge ELL arrays' width."""
    dd = b.edge_nbr.shape[1]
    node_inc = b.node_inc
    if node_inc.shape[1] < dd:
        node_inc = torch.cat([node_inc, node_inc.new_full(
            (node_inc.shape[0], dd - node_inc.shape[1]), spec.pe)], dim=1)
    labels = _take0(b.labels[:, None], b.group_graph)[:, 0]
    mask = _take0(b.graph_mask[:, None], b.group_graph)[:, 0]
    return node_inc, labels, mask


def ep_pack_fused_train(model: CGRMPNN, b: EPPackedBatch, spec: EPPackSpec,
                        seeds=None):
    """(partial SSE over this shard's graphs, the 11 weight gradients) by
    one launch of the whole-model training kernel (K2) on the shard's
    packs (plain version on the CPU).  Valid for zero-cut specs
    (:func:`supports_ep_fused_train`); the per-shard values are partial
    sums over disjoint graphs, summed over the shards by the caller (no
    division by n_ep)."""
    cfg = model.cfg
    node_inc, labels, mask = _ep_kernel_batch(b, spec)
    x = b.node_x.float()
    F = x.shape[1]
    wei, wen = model.edge_init.w, model.edge_to_node.w
    inputs = (x, b.edge_attr.float(), b.senders, b.edge_nbr, b.rev, node_inc,
              b.pool_ell, wei[:F], wei[F:], model.edge_init.b,
              torch.stack([c.w for c in model.convs]),
              torch.stack([c.b for c in model.convs]), _skips(model, x.device),
              wen[F:], wen[:F], model.edge_to_node.b, model.ffn.w,
              model.ffn.b)
    with torch.no_grad():
        return fused_model_train(inputs, (b.dst, b.edge_nbr_rev, b.node_group),
                                 labels, mask,
                                 **_kernel_kw(cfg, spec, seeds is not None,
                                              seeds))


def make_ep_pack_train_step(model: CGRMPNN, spec: EPPackSpec, comm=None):
    """``step(groups, seeds) -> SSE``: the EP training step's compute over
    every data-parallel group and shard in this process (``groups``
    [n_dp][n_ep] shards), the gradients written into the parameters'
    ``.grad`` (the optimizer is the caller's).  Zero-cut specs of the
    whole-model configuration run one K2 launch per shard (partial SSEs and
    gradients summed over each group's shards, then over the groups);
    otherwise autograd of each group's full-batch SSE through K5, K4 or
    K8/K9, and K11, ``.grad`` accumulating over the groups -- JAX's
    ``psum(loss / n_ep)`` over ('dp', 'ep'), since every shard of a group
    holds its full SSE.  ``seeds`` [n_dp, n_ep, depth] turns on train-mode
    dropout.

    Over several ranks ``groups`` holds this rank's cells ([n][n_ep] under
    layout (a); [[its shard]] under layout (b), with ``comm``), and [SSE,
    gradients] are summed over every rank in one collective
    (``data_parallel.all_reduce_step``); under layout (b) a group's full
    SSE enters that sum once, from its shard 0."""
    from .data_parallel import all_reduce_step
    if supports_ep_fused_train(model.cfg, spec):
        def step(groups, seeds=None):
            sse, grads = sum_partials(sum_partials(
                ep_pack_fused_train(model, b, spec,
                                    None if seeds is None else seeds[g][k])
                for k, b in enumerate(shards))
                for g, shards in enumerate(groups))
            kernel_grads_to_params(model, grads)
            return all_reduce_step(model, sse)
        return step

    def step(groups, seeds=None):
        model.zero_grad(set_to_none=True)
        total = None
        for g, shards in enumerate(groups):
            sse, _ = ep_pack_forward(model, shards, spec,
                                     train=seeds is not None,
                                     seeds=None if seeds is None else seeds[g],
                                     comm=comm)
            sse.backward()
            total = sse.detach() if total is None else total + sse.detach()
        return all_reduce_step(model, _once_a_group(total, comm))
    return step


def _once_a_group(sse: torch.Tensor, comm) -> torch.Tensor:
    """A group's full SSE as its share of the sum over ranks: all of it on
    shard 0, zero on the group's other ranks (layout (b))."""
    return sse if comm is None or comm.shard == 0 else torch.zeros_like(sse)


def make_ep_pack_eval_step(model: CGRMPNN, spec: EPPackSpec, comm=None):
    """``eval(groups) -> (SSE summed over the groups, preds [n_dp * B])`` in
    eval mode, no gradients; ``groups`` [n_dp][n_ep] shards.  Over several
    ranks the SSE is summed over every rank (each group's once) and the
    preds are this rank's groups'."""
    from .data_parallel import all_reduce_step

    def evaluate(groups):
        sse, preds = None, []
        with torch.no_grad():
            for shards in groups:
                s, p = ep_pack_forward(model, shards, spec, comm=comm)
                sse = s if sse is None else sse + s
                preds.append(p)
            sse = all_reduce_step(None, _once_a_group(sse, comm))
        return sse, torch.cat(preds)
    return evaluate
