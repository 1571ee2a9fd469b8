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
    graph_pool_sum      sum_k hn[graph_nodes[g, k]]

:func:`in_pack` and :func:`pack_gather_sum` are the kernels' convention
instead: an index outside the pack of the row that holds it counts as
absent (the plain versions of the CUDA kernels use them).
"""

from __future__ import annotations

import torch

from .kernel_math import mean_colscale

__all__ = ["ext_zero_row", "gather_nodes", "dmpnn_messages",
           "node_incoming_sum", "graph_pool_sum", "in_pack",
           "pack_gather_sum"]


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
