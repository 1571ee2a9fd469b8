"""The CGR-MPNN in plain PyTorch over lists of graphs: the forward, the
masked SSE with its gradients by autograd, the kernels' hash dropout and
Adam with amsgrad and L2 weight decay.

  h0  = relu([x[src] ++ e] @ W_ei + b_ei)
  for each conv layer l:
      m   = sum of h over the edges into each node
      h   = relu((m[src] - h[rev]) @ W_l + b_l + h0)
      h   = dropout(h)                                     (train only)
  s   = sum of h over the edges into each node
  hn  = relu([x ++ s] @ W_en + b_en)
  out = (sum of hn over the graph's nodes) @ W_ffn + b_ffn

Every product is a float32 matmul with TF32 off.  ``tf32=True`` rounds
each product's operands to TF32 (10 mantissa bits, to nearest even) with
float32 sums: what the tensor cores do in TF32, and the control that has to
come out as not correct.

The dropout bits of element (row, col) in pack ``pack`` are a murmur3
finalizer over ``row*65537 + col + seed*0x9E3779B9 + pack*0x85EBCA6B`` in
uint32 arithmetic, with ``row`` the pack-local edge row; an element is kept
where the bits reach ``min(int(rate * 2**32), 2**32 - 1)`` and is then
scaled by ``1 / (1 - rate)``: a frozen copy of the port's rule.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Dims", "leaf_shapes", "make_weights", "GraphSet", "graph_set",
           "forward", "sse_and_grads", "adam_amsgrad", "step_seeds",
           "round_tf32"]

_M32 = 0xFFFFFFFF


@dataclass(frozen=True)
class Dims:
    F: int          # node features (CGR + descriptors)
    Fe: int         # edge features
    H: int          # hidden width
    depth: int      # conv layers


def leaf_shapes(d: Dims) -> dict:
    """The parameters by name, in the order the weights are drawn."""
    shapes = {"edge_init.w": (d.F + d.Fe, d.H), "edge_init.b": (d.H,)}
    for l in range(d.depth):
        shapes[f"convs.{l}.w"] = (d.H, d.H)
        shapes[f"convs.{l}.b"] = (d.H,)
    shapes.update({"edge_to_node.w": (d.F + d.H, d.H),
                   "edge_to_node.b": (d.H,), "ffn.w": (d.H, 1),
                   "ffn.b": (1,)})
    return shapes


def make_weights(d: Dims, seed: int, device) -> dict:
    """Weights drawn on ``device`` from ``seed`` in one call: each layer's
    w and b uniform in +-1/sqrt(fan_in), as torch's Linear draws them."""
    shapes = leaf_shapes(d)
    sizes = [math.prod(s) for s in shapes.values()]
    bounds = [1.0 / math.sqrt(shapes[n.rsplit(".", 1)[0] + ".w"][0])
              for n in shapes]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(sum(sizes), generator=gen, device=device)
    scale = torch.repeat_interleave(
        torch.tensor(bounds, device=device),
        torch.tensor(sizes, device=device))
    flat = (2.0 * u - 1.0) * scale
    return {n: t.view(s) for (n, s), t in
            zip(shapes.items(), torch.split(flat, sizes))}


@dataclass
class GraphSet:
    """Graphs laid end to end: node and edge features, global edge ends,
    each node's graph, labels, and each edge's dropout key (pack and
    pack-local row; None in eval)."""
    x: torch.Tensor
    e: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    rev: torch.Tensor
    graph_of_node: torch.Tensor
    labels: torch.Tensor
    n_graphs: int
    drop_row: torch.Tensor | None = None
    drop_pack: torch.Tensor | None = None


def graph_set(graphs, feats, labels, device, where=None) -> GraphSet:
    """``graphs`` (featurized reactions), ``feats`` (each one's [atoms, K]
    descriptor block, or None), ``labels``; ``where`` (pack, first edge row)
    of each graph for the dropout keys."""
    xs, es, src, dst, rev, gon, rows, packs = [], [], [], [], [], [], [], []
    n_off = e_off = 0
    for i, g in enumerate(graphs):
        x = g.node_feats
        if feats is not None:
            x = np.concatenate([x, np.asarray(feats[i], np.float32)], axis=1)
        xs.append(x)
        es.append(g.edge_feats)
        src.append(g.senders.astype(np.int64) + n_off)
        dst.append(g.receivers.astype(np.int64) + n_off)
        rev.append(g.rev_edge_index.astype(np.int64) + e_off)
        gon.append(np.full(g.num_nodes, i, np.int64))
        if where is not None:
            pk, off = where[i]
            rows.append(off + np.arange(g.num_edges, dtype=np.int64))
            packs.append(np.full(g.num_edges, pk, np.int64))
        n_off += g.num_nodes
        e_off += g.num_edges

    def t(parts, dtype):
        return torch.as_tensor(np.concatenate(parts), dtype=dtype,
                               device=device)

    return GraphSet(
        t(xs, torch.float32), t(es, torch.float32), t(src, torch.int64),
        t(dst, torch.int64), t(rev, torch.int64), t(gon, torch.int64),
        torch.as_tensor(np.asarray(labels, np.float32), device=device),
        len(graphs),
        t(rows, torch.int64) if where is not None else None,
        t(packs, torch.int64) if where is not None else None)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32: 10 mantissa bits, to nearest
    even."""
    i = t.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


class _TF32Matmul(torch.autograd.Function):
    """a @ b with the operands of the product and of both of its
    gradients' products rounded to TF32, as TF32 matmuls compute them."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ b.T, a.T @ g


def _mm(a, b, tf32: bool):
    return _TF32Matmul.apply(a, b) if tf32 else a @ b


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    lo = (a * (b & 0xFFFF)) & _M32
    hi = (a * (b >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _keep(row, pack, H: int, seed: int, rate: float) -> torch.Tensor:
    """The hash dropout's keep mask of the edges at (pack, row), [E, H]."""
    col = torch.arange(H, device=row.device, dtype=torch.int64)[None, :]
    s = int(seed) & _M32
    x = (_mul32(row[:, None], 65537) + col + _mul32(
        torch.tensor(s, device=row.device), 0x9E3779B9)
         + _mul32(pack[:, None], 0x85EBCA6B)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x >= min(int(rate * 2**32), 2**32 - 1)


def _incoming(h, dst, n_nodes):
    return torch.zeros(n_nodes, h.shape[1], dtype=h.dtype,
                       device=h.device).index_add_(0, dst, h)


def forward(w: dict, gs: GraphSet, depth: int, seeds=None,
            rates=(), tf32: bool = False) -> torch.Tensor:
    """Predictions [graphs]; ``seeds`` (one per conv layer) turns on the
    hash dropout at ``rates``."""
    F = gs.x.shape[1]
    N = gs.x.shape[0]
    wei, wen = w["edge_init.w"], w["edge_to_node.w"]
    h0 = torch.relu(_mm(gs.x[gs.src], wei[:F], tf32)
                    + _mm(gs.e, wei[F:], tf32) + w["edge_init.b"])
    h = h0
    for l in range(depth):
        m = _incoming(h, gs.dst, N)
        h = torch.relu(_mm(m[gs.src] - h[gs.rev], w[f"convs.{l}.w"], tf32)
                       + w[f"convs.{l}.b"] + h0)
        if seeds is not None and rates[l] > 0.0:
            keep = _keep(gs.drop_row, gs.drop_pack, h.shape[1],
                         int(seeds[l]), rates[l])
            h = torch.where(keep, h * (1.0 / (1.0 - rates[l])), 0.0)
    s = _incoming(h, gs.dst, N)
    hn = torch.relu(_mm(gs.x, wen[:F], tf32) + _mm(s, wen[F:], tf32)
                    + w["edge_to_node.b"])
    pooled = torch.zeros(gs.n_graphs, hn.shape[1], dtype=hn.dtype,
                         device=hn.device).index_add_(0, gs.graph_of_node,
                                                      hn)
    return (_mm(pooled, w["ffn.w"], tf32) + w["ffn.b"])[:, 0]


def sse_and_grads(w: dict, gs: GraphSet, depth: int, seeds, rates,
                  tf32: bool = False) -> tuple:
    """(the SSE of the graphs, a float; {name: its gradient})."""
    leaves = {n: t.detach().clone().requires_grad_(True)
              for n, t in w.items()}
    err = forward(leaves, gs, depth, seeds, rates, tf32) - gs.labels
    sse = (err * err).sum()
    grads = torch.autograd.grad(sse, list(leaves.values()))
    return float(sse.detach()), dict(zip(leaves, grads))


def adam_amsgrad(w: dict, grads: dict, state: dict, t: int, lr: float,
                 weight_decay: float, betas=(0.9, 0.999),
                 eps: float = 1e-8) -> None:
    """One Adam step with amsgrad and L2 weight decay, in place; ``state``
    holds m, v and vmax by name (filled on the first step), ``t`` counts
    from 1."""
    b1, b2 = betas
    for n, p in w.items():
        g = grads[n] + weight_decay * p
        if n not in state:
            z = torch.zeros_like(p)
            state[n] = [z.clone(), z.clone(), z.clone()]
        m, v, vmax = state[n]
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        torch.maximum(vmax, v, out=vmax)
        denom = (vmax.sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
        p.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))


def step_seeds(seed: int, draw: int, depth: int) -> list:
    """The dropout seeds of step ``draw`` of a run seeded with ``seed``:
    one int32 per conv layer, from a CPU generator seeded with
    ``(seed mod 2**32) << 32 | draw``."""
    gen = torch.Generator().manual_seed(((int(seed) & _M32) << 32) | draw)
    return torch.randint(0, 2**31 - 1, (depth,), generator=gen,
                         dtype=torch.int64).tolist()
