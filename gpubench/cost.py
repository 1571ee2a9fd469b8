"""The yardstick's arithmetic: the work a forward or a training step needs
on a packed batch, the chip's peaks and the least time that work takes.

Copied from the port's chip smoke test (``forward_cost``, ``train_cost``,
``bound``), with the weights counted from the model's widths instead of
read from the kernels' arguments.  Products count 2 operations a
multiply-add; gathers count one add a row element; only real rows count
(padding feeds no prediction); every input is read once and every output
written once.
"""

from __future__ import annotations

import torch

__all__ = ["PEAKS", "peak_flops", "forward_cost", "train_cost", "bound"]

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAKS = {"float32": 67e12, "bfloat16": 989e12, "bytes": 3.35e12}


def peak_flops(compute_dtype: str) -> float:
    """The product peak of a configuration's compute type."""
    return PEAKS[compute_dtype]


def _t(a):
    return torch.as_tensor(a)


def _real(batch):
    NT = batch.node_x.shape[0]
    ET = batch.edge_attr.shape[0]
    E = int((_t(batch.senders) < NT).sum())
    N = int((_t(batch.graph_nodes) < NT).sum())
    B = int((_t(batch.graph_nodes) < NT).any(dim=1).sum())
    nbr = int((_t(batch.edge_nbr) < ET).sum())
    inc = int((_t(batch.node_inc) < ET).sum())
    return E, N, B, nbr, inc


def _nbytes(arrays) -> int:
    return sum(_t(a).numel() * _t(a).element_size() for a in arrays)


def _weights(F: int, Fe: int, H: int, L: int) -> int:
    """Numbers in the kernels' weight arguments (W_ei split at F, b_ei, the
    conv stack, the skips, W_en split at F, b_en, W_ffn, b_ffn)."""
    return ((F + Fe) * H + H + L * H * H + L * H + L + (F + H) * H + H
            + H + 1)


def forward_cost(batch, H: int, L: int) -> tuple[float, float, float]:
    """(product operations, gather adds, bytes) of the forward on a packed
    batch (numpy arrays or tensors).  The x part of edge_init counts once
    a node, since x[senders]·Wx = (x·Wx)[senders]."""
    F = batch.node_x.shape[1]
    Fe = batch.edge_attr.shape[1]
    BT = batch.graph_nodes.shape[0]
    E, N, B, nbr, inc = _real(batch)
    dense = (2 * N * F * H + 2 * E * Fe * H + L * 2 * E * H * H
             + 2 * N * (F + H) * H + 2 * B * H)
    adds = L * (nbr + E) * H + inc * H + N * H
    nbytes = (_nbytes([_t(batch.node_x).float(), _t(batch.edge_attr).float(),
                       batch.senders, batch.edge_nbr, batch.rev,
                       batch.node_inc, batch.graph_nodes])
              + 4 * _weights(F, Fe, H, L) + BT * 4)
    return float(dense), float(adds), float(nbytes)


def train_cost(batch, H: int, L: int) -> tuple[float, float, float]:
    """(product operations, gather adds, bytes) of one training step: the
    replayed forward, then over the real rows the cotangents through the
    weights, each weight gradient once (the x part of dWx once a node) and
    the transposed gathers; the adjoint indices, labels and gradients
    read or written once.  Nothing recomputed is counted twice beyond the
    one replay."""
    f_dense, f_adds, nbytes = forward_cost(batch, H, L)
    F = batch.node_x.shape[1]
    Fe = batch.edge_attr.shape[1]
    BT = batch.graph_nodes.shape[0]
    E, N, B, nbr, inc = _real(batch)
    dense = (4 * B * H + 4 * N * H * H + 4 * N * F * H + 4 * L * E * H * H
             + 2 * E * Fe * H)
    adds = L * (nbr + E) * H + inc * H + N * H
    nbytes += (_nbytes([batch.receivers, batch.edge_nbr_rev,
                        batch.graph_of_node]) + BT * 4
               + 4 * _weights(F, Fe, H, L) + 4)
    return float(f_dense + dense), float(f_adds + adds), float(nbytes)


def bound(cost, compute_dtype: str = "float32") -> tuple[float, str]:
    """(least ms, "operations" or "bytes") of ``cost``: products at the
    compute type's peak, the other operations at the float32 peak, bytes
    at the memory's."""
    t_ops = (cost[0] / peak_flops(compute_dtype)
             + cost[1] / PEAKS["float32"])
    t_bytes = cost[2] / PEAKS["bytes"]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")
