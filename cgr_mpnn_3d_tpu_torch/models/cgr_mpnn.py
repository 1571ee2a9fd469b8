"""CGR-MPNN model: directed-bond message passing over packed reaction graphs.

The counterpart of ``cgr_mpnn_3d_tpu/models/cgr_mpnn.py``, with the same
math over the same packed batches:

  h0 = act(edge_init([x[src] ++ e_attr]))
  repeat depth times:
      t  = a_message[src] - h[rev]
      h  = act(lin_l(t) + (skip_w[l] *)? h0)        (eval: no dropout)
  s  = incoming-sum(h)        (mean: divided by the in-degree)
  hn = act(edge_to_node([x ++ s]))
  out = ffn(pool(hn)).squeeze(-1)      (pool: sum or mean over the graph)

Parameters keep the JAX pytree's names and layout (``edge_init``,
``convs[l]``, ``edge_to_node``, ``ffn``, ``skip_weights``; weights
``[fan_in, fan_out]``) and PyTorch-default Linear init bounds.

:func:`apply` routes a batch on the card through the whole-model forward
kernel (ops/fused_model.py) and takes the plain gather ops (ops/segment.py)
on the CPU and for ``capture=True``.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..data.batch import PackedGraphBatch, PackSpec
from ..ops.fused_model import fused_model_forward
from ..ops.kernel_math import k_act
from ..ops.segment import (dmpnn_messages, gather_nodes, graph_pool_sum,
                           node_incoming_sum)
from ..utils.device import resolve_device

__all__ = ["CGRMPNNConfig", "CGRMPNN", "init_params", "apply",
           "kernel_inputs", "params_from_jax", "jax_leaf_names",
           "ACTIVATIONS"]

# config activation name -> kernel activation id (ops/kernel_math.k_act)
ACTIVATIONS = {"ReLU": "relu", "SiLU": "silu", "GELU": "gelu"}


@dataclass(frozen=True)
class CGRMPNNConfig:
    num_node_features: int
    num_edge_features: int
    depth: int = 3
    hidden_sizes: tuple[int, ...] = ()     # defaults to (300,)*depth
    dropout_ps: tuple[float, ...] = ()     # defaults to (0.02,)*depth
    activation: str = "ReLU"
    aggr: str = "add"                      # 'add' | 'mean'
    pooling: str = "add"                   # 'add' | 'mean'
    use_learnable_skip: bool = False

    def __post_init__(self):
        object.__setattr__(self, "hidden_sizes",
                           tuple(self.hidden_sizes) or (300,) * self.depth)
        object.__setattr__(self, "dropout_ps",
                           tuple(self.dropout_ps) or (0.02,) * self.depth)
        if len(self.hidden_sizes) != self.depth:
            raise ValueError("hidden_sizes must have one entry per layer")
        if len(set(self.hidden_sizes)) != 1:
            raise ValueError("hidden_sizes must be uniform")
        if self.aggr not in ("add", "mean"):
            raise ValueError(f"unsupported aggr {self.aggr!r}")
        if self.pooling not in ("add", "mean"):
            raise ValueError(f"unsupported pooling {self.pooling!r}")
        if self.activation not in ACTIVATIONS:
            raise ValueError(f"unsupported activation {self.activation!r}")

    @property
    def hidden(self) -> int:
        return self.hidden_sizes[0]


class Linear(nn.Module):
    """y = x @ w + b with ``w`` [fan_in, fan_out] (the JAX layout)."""

    def __init__(self, fan_in: int, fan_out: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        # torch nn.Linear default: U(-1/sqrt(fan_in), 1/sqrt(fan_in))
        bound = 1.0 / math.sqrt(fan_in)

        def uniform(*shape):
            u = torch.rand(shape, generator=generator, dtype=torch.float32)
            return nn.Parameter((2.0 * u - 1.0) * bound)

        self.w = uniform(fan_in, fan_out)
        self.b = uniform(fan_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class CGRMPNN(nn.Module):
    def __init__(self, cfg: CGRMPNNConfig,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        h, F = cfg.hidden, cfg.num_node_features
        self.edge_init = Linear(F + cfg.num_edge_features, h, generator)
        self.convs = nn.ModuleList(Linear(h, h, generator)
                                   for _ in range(cfg.depth))
        self.edge_to_node = Linear(F + h, h, generator)
        self.ffn = Linear(h, 1, generator)
        if cfg.use_learnable_skip:
            self.skip_weights = nn.ParameterList(
                nn.Parameter(torch.ones(())) for _ in range(cfg.depth))

    def forward(self, batch: PackedGraphBatch, spec: PackSpec | None = None,
                **kw):
        return apply(self, batch, spec, **kw)


def init_params(cfg: CGRMPNNConfig, generator: torch.Generator | None = None,
                device: str | torch.device = "cuda") -> CGRMPNN:
    """A freshly initialised model on ``device``; the draws are made on the
    CPU from ``generator``, so a seed gives the same weights everywhere."""
    return CGRMPNN(cfg, generator).to(resolve_device(device))


def jax_leaf_names(cfg: CGRMPNNConfig) -> list[str]:
    """State-dict names in the JAX pytree's leaf order (sorted dict keys):
    convs[0].b, convs[0].w, ..., edge_init.b/w, edge_to_node.b/w, ffn.b/w,
    skip_weights[...] -- the order of a checkpoint's ``arr_i``."""
    names = [f"convs.{l}.{k}" for l in range(cfg.depth) for k in "bw"]
    names += [f"{m}.{k}" for m in ("edge_init", "edge_to_node", "ffn")
              for k in "bw"]
    if cfg.use_learnable_skip:
        names += [f"skip_weights.{l}" for l in range(cfg.depth)]
    return names


def params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """The JAX params pytree (nested dicts/lists of arrays) as this model's
    state dict: ``CGRMPNN.load_state_dict(params_from_jax(tree))``."""
    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.float32))

    state = {}
    for m in ("edge_init", "edge_to_node", "ffn"):
        for k in "wb":
            state[f"{m}.{k}"] = t(tree[m][k])
    for l, conv in enumerate(tree["convs"]):
        for k in "wb":
            state[f"convs.{l}.{k}"] = t(conv[k])
    for l, s in enumerate(tree.get("skip_weights", ())):
        state[f"skip_weights.{l}"] = t(s)
    return state


def _skips(model: CGRMPNN, device) -> torch.Tensor:
    if model.cfg.use_learnable_skip:
        return torch.stack(list(model.skip_weights))
    return torch.ones(model.cfg.depth, device=device)


def kernel_inputs(model: CGRMPNN, batch: PackedGraphBatch) -> tuple:
    """The arguments of ops.fused_model.fused_model_forward: the batch's
    features (f32) and ELL indices, and the weights split at the concat
    boundaries (edge_init.w[:F] multiplies x, [F:] e; edge_to_node.w[:F]
    multiplies x, [F:] s)."""
    x = batch.node_x.float()
    F = x.shape[1]
    wei, wen = model.edge_init.w, model.edge_to_node.w
    return (x, batch.edge_attr.float(), batch.senders, batch.edge_nbr,
            batch.rev, batch.node_inc, batch.graph_nodes, wei[:F], wei[F:],
            model.edge_init.b, torch.stack([c.w for c in model.convs]),
            torch.stack([c.b for c in model.convs]),
            _skips(model, x.device), wen[F:], wen[:F], model.edge_to_node.b,
            model.ffn.w, model.ffn.b)


def apply(model: CGRMPNN, batch: PackedGraphBatch, spec: PackSpec | None = None,
          *, capture: bool = False):
    """Eval-mode forward pass -> per-graph predictions [BT] (padded slots
    garbage -- mask with ``batch.graph_mask``).  With ``capture=True`` also
    returns a dict of intermediate activations.  Dropout arrives with the
    training slice.

    A batch on the card goes through the forward kernel, which needs
    ``spec`` (its pack count); the CPU and ``capture=True`` take the plain
    gather ops."""
    cfg = model.cfg
    kact = ACTIVATIONS[cfg.activation]
    x, e = batch.node_x, batch.edge_attr

    if x.device.type == "cuda" and not capture:
        if spec is None:
            raise ValueError("the forward kernel needs the batch's PackSpec")
        return fused_model_forward(
            *kernel_inputs(model, batch), p=spec.p, act=kact, aggr=cfg.aggr,
            pooling=cfg.pooling)

    x, e = x.float(), e.float()
    ET = batch.senders.shape[0]
    acts: dict[str, torch.Tensor] = {}
    if cfg.aggr == "mean":
        in_deg = (batch.node_inc < ET).sum(dim=1).float()
        inv_deg = torch.where(in_deg > 0, 1.0 / in_deg.clamp_min(1.0), 0.0)
        norm = gather_nodes(inv_deg[:, None], batch.senders)[:, 0]
    else:
        norm = torch.ones(ET, device=x.device)

    F = x.shape[1]
    wei = model.edge_init
    x_src = gather_nodes(x, batch.senders)
    h0 = k_act(kact, x_src @ wei.w[:F] + e @ wei.w[F:] + wei.b)
    if capture:
        acts["h0"] = h0
    skips = _skips(model, x.device)
    h = h0
    for l in range(cfg.depth):
        t = dmpnn_messages(h, batch.edge_nbr, batch.rev, norm)
        h = k_act(kact, model.convs[l](t) + skips[l] * h0)
        if capture:
            acts[f"h_{l}"] = h

    s = node_incoming_sum(h, batch.node_inc)
    if cfg.aggr == "mean":
        s = s * inv_deg[:, None]
    wen = model.edge_to_node
    hn = k_act(kact, x @ wen.w[:F] + s @ wen.w[F:] + wen.b)
    if capture:
        acts["s"] = s
        acts["h_node"] = hn

    pooled = graph_pool_sum(hn, batch.graph_nodes)
    if cfg.pooling == "mean":
        n_cnt = (batch.graph_nodes < x.shape[0]).sum(dim=1).float()
        pooled = pooled * torch.where(n_cnt > 0, 1.0 / n_cnt.clamp_min(1.0),
                                      0.0)[:, None]
    out = model.ffn(pooled)[:, 0]
    if capture:
        acts["pooled"] = pooled
        return out, acts
    return out
