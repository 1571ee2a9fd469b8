"""Gather-only message-passing primitives in plain PyTorch: the oracle.

The counterparts of ``cgr_mpnn_3d_tpu/ops/segment.py``.  Each op is a batched
row gather over a source with one all-zero row appended, so an index equal to
the source's row count (the packer's sentinel, data/batch.py) contributes
exactly zero.  Autograd gives the backward; the JAX package's transpose index
arrays (``node_out``, ``edge_nbr_rev``, ...) are therefore not arguments here.

    op                  forward gather
    gather_nodes        x[senders]
    dmpnn_messages      sum_d h[edge_nbr[e, d]] * norm[e]  -  h[rev[e]]
    node_incoming_sum   sum_d h[node_inc[n, d]]
    node_partial_sum    sum_d h[node_inc[n, d]] over a shard's own edges
    graph_pool_sum      sum_k hn[graph_nodes[g, k]]
    gather_rev          h[rev]

:func:`in_pack` and :func:`pack_gather_sum` are the kernels' convention
instead: an index outside the pack of the row that holds it counts as
absent (the plain versions of the CUDA kernels use them).

:func:`flat_op` is the entry of the flat edge-partition layout
(``parallel/edge_partition.py``): each of its gathers and partial sums, by
name, with the forward ELL array and the transposed one that its backward
gathers through (:func:`flat_ell` brings both to int32, 2-d and contiguous
once per batch):

    op          forward ELL           backward ELL
    x_src       src_idx[:, None]      ext_out
    incoming    part_inc              dst_part[:, None]
    pushed      own_recv_inc          recv_idx[:, None]
    serve       recv_idx[:, None]     own_recv_inc
    t           src_idx[:, None]      ext_out
    reverse     rev[:, None]          rev[:, None]
    pool        graph_nodes           node_graph[:, None]

CUDA tensors go through K7 (``onehot_spmm.spmm`` with one pack, at
``mat_dtype="float32"``: an index outside the source's rows is absent, the
layout's sentinel), CPU tensors through the plain op of the table above;
there is no third route.
"""

from __future__ import annotations

import torch

from .kernel_math import mean_colscale

__all__ = ["ext_zero_row", "gather_nodes", "dmpnn_messages",
           "node_incoming_sum", "node_partial_sum", "graph_pool_sum",
           "gather_rev", "in_pack", "pack_gather_sum", "FLAT_OPS",
           "flat_ell", "flat_op"]


def ext_zero_row(h: torch.Tensor) -> torch.Tensor:
    """Append one all-zero row: the sentinel target."""
    return torch.cat([h, h.new_zeros((1,) + tuple(h.shape[1:]))], dim=0)


def in_pack(idx: torch.Tensor, p: int, n_src: int):
    """(ids, valid) for the ELL array ``idx`` [rows] or [rows, D] over a
    source of ``n_src`` rows, both split into ``p`` packs: ids outside the
    pack of their row become the sentinel ``n_src`` (the zero row of
    :func:`ext_zero_row`)."""
    rows = idx.shape[0]
    pack = torch.arange(rows, device=idx.device) // (rows // p)
    lo = pack * (n_src // p)
    if idx.dim() == 2:
        lo = lo[:, None]
    valid = (idx >= lo) & (idx < lo + n_src // p)
    return torch.where(valid, idx, n_src).long(), valid


def pack_gather_sum(src: torch.Tensor, idx: torch.Tensor, p: int,
                    mean: bool = False) -> torch.Tensor:
    """out[r] = scale_r · sum_d src[idx[r, d]] over in-pack entries; scale_r
    is 1, or 1 / (entries counted) for ``mean``."""
    ids, valid = in_pack(idx, p, src.shape[0])
    out = ext_zero_row(src)[ids].sum(dim=1)
    return out * mean_colscale(valid)[:, None] if mean else out


def _take(h_ext: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    # out-of-range ids clip to the zero row, as jnp.take(mode="clip") does
    return h_ext[idx.long().clamp(0, h_ext.shape[0] - 1)]


def gather_nodes(x: torch.Tensor, senders: torch.Tensor) -> torch.Tensor:
    """x[senders] (edge_init gather)."""
    return _take(ext_zero_row(x), senders)


def dmpnn_messages(h: torch.Tensor, edge_nbr: torch.Tensor,
                   rev: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
    """D-MPNN message: the sender's incoming sum scaled by ``norm`` (1 for
    aggr='add', 1/in-degree for 'mean') minus the unscaled reverse edge."""
    he = ext_zero_row(h)
    return _take(he, edge_nbr).sum(dim=1) * norm[:, None] - _take(he, rev)


def node_incoming_sum(h: torch.Tensor, node_inc: torch.Tensor) -> torch.Tensor:
    """Edge -> node incoming sum (the readout's ``s``)."""
    return _take(ext_zero_row(h), node_inc).sum(dim=1)


def graph_pool_sum(hn: torch.Tensor, graph_nodes: torch.Tensor) -> torch.Tensor:
    """Node -> graph sum pooling."""
    return _take(ext_zero_row(hn), graph_nodes).sum(dim=1)


def node_partial_sum(h: torch.Tensor, node_inc: torch.Tensor) -> torch.Tensor:
    """Edge -> node partial incoming sum over a shard's own edges (the flat
    edge-partition layout's; the owners complete it)."""
    return _take(ext_zero_row(h), node_inc).sum(dim=1)


def gather_rev(h: torch.Tensor, rev: torch.Tensor) -> torch.Tensor:
    """h[rev]: the reverse edge's state (rev is an involution on real
    edges, so its adjoint is the same gather)."""
    return _take(ext_zero_row(h), rev)


# the flat layout's ops and the plain op each takes on the CPU (a gather of
# one entry a row, or a sum over the row's ELL entries)
FLAT_OPS = {"x_src": "gather_nodes", "incoming": "node_partial_sum",
            "pushed": "node_partial_sum", "serve": "gather_nodes",
            "t": "gather_nodes", "reverse": "gather_rev",
            "pool": "graph_pool_sum"}


def flat_ell(idx: torch.Tensor) -> torch.Tensor:
    """An index array of the flat layout as K7 takes it: int32, 2-d (a 1-d
    array becomes one column) and contiguous."""
    if idx.dim() == 1:
        idx = idx[:, None]
    return idx.to(torch.int32).contiguous()


def flat_op(op: str, src: torch.Tensor, idx: torch.Tensor,
            idx_bwd: torch.Tensor) -> torch.Tensor:
    """The flat layout's op ``op`` (:data:`FLAT_OPS`) of ``src`` through the
    :func:`flat_ell` arrays ``idx`` [rows, D] and ``idx_bwd`` (its
    transpose, one row per row of ``src``) -> [rows, H].  CUDA tensors:
    one K7 launch forward and one backward (f32); CPU tensors: the plain
    op under autograd."""
    plain = FLAT_OPS[op]
    if src.is_cuda:
        from . import onehot_spmm
        return onehot_spmm.spmm(src, idx, idx_bwd, p=1, mat_dtype="float32")
    if src.device.type != "cpu":
        raise ValueError(f"unsupported device {src.device}")
    fn = globals()[plain]
    return fn(src, idx if plain in ("node_partial_sum", "graph_pool_sum")
              else idx[:, 0])
