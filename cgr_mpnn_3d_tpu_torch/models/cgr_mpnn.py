"""CGR-MPNN model: directed-bond message passing over packed reaction graphs.

The counterpart of ``cgr_mpnn_3d_tpu/models/cgr_mpnn.py``, with the same
math over the same packed batches:

  h0 = act(edge_init([x[src] ++ e_attr]))
  repeat depth times:
      t  = a_message[src] - h[rev]
      h  = dropout(act(lin_l(t) + (skip_w[l] *)? h0), p[l])   (train only)
  s  = incoming-sum(h)        (mean: divided by the in-degree)
  hn = act(edge_to_node([x ++ s]))
  out = ffn(pool(hn)).squeeze(-1)      (pool: sum or mean over the graph)

Parameters keep the JAX pytree's names and layout (``edge_init``,
``convs[l]``, ``edge_to_node``, ``ffn``, ``skip_weights``; weights
``[fan_in, fan_out]``) and PyTorch-default Linear init bounds.

:func:`apply` routes a batch on the card through the whole-model kernels
(ops/fused_model.py: the forward kernel, with the VJP kernel as its
backward) and takes the plain gather ops (ops/segment.py) on the CPU.
:func:`fused_train_value_and_grad` is the training step's compute in one
kernel launch per step on the card.

With ``capture=True`` and the batch's ``spec``, :func:`apply` runs the
JAX package's per-layer kernel path instead, whatever ``fuse_whole_model``
says: the node gather x[senders], the readout's incoming sum and the
pooling through the ELL gather-sum (ops/onehot_spmm.py), and each conv
layer through the per-layer conv kernel (ops/fused_conv.py), recording
every layer's output; edge_init's and the readout's products, the mean
scales and the FFN head are torch.  On the CPU each kernel takes its plain
version; a CPU batch without ``spec`` keeps the plain gather ops.

With ``CGRMPNNConfig(fuse_whole_model=False)`` (the layered-kernel
configuration) :func:`apply` runs the network as four differentiable
kernels instead -- gather-linear edge_init (ops/gather_linear.py), the conv
stack (ops/conv_stack.py), gather-linear readout, sum pooling
(ops/onehot_spmm.py) -- with mean pooling's scale and the FFN head in
torch; on the CPU each takes its plain version.  Training then goes through
autograd (:func:`supports_fused_train` is False).

``CGRMPNNConfig(compute_dtype="bfloat16")`` is the JAX package's bf16
compute (JAX ``apply`` :209-372): every operand of a product and a gather
rounded to bf16, sums and elementwise work in f32, parameters f32.  With
the batch's ``spec`` every path runs its kernels' bf16 instantiation
(``mat_dtype=bf16``; on the CPU their plain versions at bf16): the
whole-model kernels; in the layered configuration K5, K4, K5, K7 with x, e,
h0 and the conv stack's states held as ``torch.bfloat16`` tensors where JAX
holds bf16 arrays; in capture mode K7 and K6, h0 rounded to bf16 for the
conv layers (``h0c``).  The torch products around the kernels -- capture's
edge_init and readout, the FFN head -- round their operands as JAX's
``_linear`` / ``_linear_cat`` do (autograd then rounds their cotangents,
as JAX's ``astype`` does).  A CPU batch without ``spec`` takes the XLA
path's rounding: f32 gathers, operands rounded at each product.

Dropout is the TPU kernels' hash dropout everywhere (on the card and on the
CPU), driven by one int32 seed per conv layer, so a CPU run and a card run
of the trainer see the same masks.  The JAX package's XLA path draws its
masks with ``jax.random.bernoulli`` instead; the port matches that path
only in distribution (each element kept with probability 1 - p, scaled by
1/(1 - p)), not mask for mask.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..data.batch import PackedGraphBatch, PackSpec
from ..ops._launch import seed_list
from ..ops.conv_stack import conv_stack
from ..ops.fused_conv import fused_conv_layer
from ..ops.fused_model import GRAD_NAMES, fused_model, fused_model_train
from ..ops.gather_linear import gather_linear
from ..ops.kernel_math import (MAT_DTYPES, hash_dropout_keep_full, k_act,
                               round_bf16)
from ..ops.onehot_spmm import spmm
from ..ops.segment import (dmpnn_messages, gather_nodes, graph_pool_sum,
                           node_incoming_sum)
from ..utils.device import resolve_device
from ..utils.tracing import span

__all__ = ["CGRMPNNConfig", "CGRMPNN", "init_params", "apply",
           "kernel_inputs", "adjoint_inputs", "kernel_seeds",
           "kernel_grads_to_params", "fused_train_value_and_grad",
           "fused_train_sse_and_grads", "sum_partials", "sse_loss",
           "params_from_jax", "jax_leaf_names", "supports_fused_train",
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
    fuse_whole_model: bool = True          # False: the layered kernels
    compute_dtype: str = "float32"         # or "bfloat16" (kernels' mat_dtype)
    ep_rdma_exchange: bool = False         # --ep exchanges through K12, one
                                           # launch for every hop and shard
                                           # (parallel/rdma_exchange.py)
    ep_overlap: bool = False               # --ep wired layers: K6 without r
                                           # (act linear), then the compact
                                           # cut-bounded correction, act and
                                           # dropout (parallel/ep_pack.py)

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
        if self.compute_dtype not in MAT_DTYPES:
            raise ValueError(f"unsupported compute_dtype "
                             f"{self.compute_dtype!r}")

    @property
    def hidden(self) -> int:
        return self.hidden_sizes[0]


class Linear(nn.Module):
    """The parameters of y = x @ w + b, ``w`` [fan_in, fan_out] (the JAX
    layout); :func:`apply` multiplies through ``_linear``."""

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




def adjoint_inputs(batch: PackedGraphBatch) -> tuple:
    """The index arrays through which the backward kernels transpose the
    forward's gathers: receivers, edge_nbr_rev, graph_of_node."""
    return batch.receivers, batch.edge_nbr_rev, batch.graph_of_node


def kernel_seeds(cfg: CGRMPNNConfig,
                 generator: torch.Generator) -> torch.Tensor:
    """One int32 dropout seed per conv layer, in [0, 2**31 - 1), drawn on
    the CPU from ``generator`` (the counterpart of the JAX package's
    ``kernel_seeds``, which draws them from a PRNG key)."""
    return torch.randint(0, 2**31 - 1, (cfg.depth,), generator=generator,
                         dtype=torch.int64).to(torch.int32)


def _kernel_kw(cfg: CGRMPNNConfig, spec: PackSpec, train: bool,
               seeds) -> dict:
    return dict(p=spec.p, act=ACTIVATIONS[cfg.activation], aggr=cfg.aggr,
                pooling=cfg.pooling, train=train,
                seeds=seeds if train else None,
                dropout_ps=tuple(cfg.dropout_ps) if train else (),
                mat_dtype=cfg.compute_dtype)


def kernel_grads_to_params(model: CGRMPNN, grads: tuple) -> None:
    """Write the kernels' 11 weight gradients (ops.fused_model.GRAD_NAMES
    order) into the parameters' ``.grad``: the counterpart of the JAX
    package's ``kernel_grads_to_pytree``.  The concat-layout weights take
    their two halves back (edge_init.w = [dwx; dwe], edge_to_node.w =
    [dwxn; dws])."""
    g = dict(zip(GRAD_NAMES, grads))
    model.edge_init.w.grad = torch.cat([g["wx"], g["we"]], dim=0)
    model.edge_init.b.grad = g["be"]
    for l, conv in enumerate(model.convs):
        conv.w.grad = g["wc"][l]
        conv.b.grad = g["bc"][l]
    model.edge_to_node.w.grad = torch.cat([g["wxn"], g["ws"]], dim=0)
    model.edge_to_node.b.grad = g["ben"]
    model.ffn.w.grad = g["wffn"]
    model.ffn.b.grad = g["bffn"]
    if model.cfg.use_learnable_skip:
        for l, w in enumerate(model.skip_weights):
            w.grad = g["skips"][l].reshape(w.shape)


def fused_train_sse_and_grads(model: CGRMPNN, batch: PackedGraphBatch,
                              spec: PackSpec, seeds=None) -> tuple:
    """(the masked SSE of ``batch``, a 0-dim tensor; the kernels' 11 weight
    gradients): on the card by ONE launch of the training kernel (replay,
    loss, gradients -- no autograd, no separate forward), on the CPU by its
    plain version, both with the products of ``model.cfg.compute_dtype``.
    ``seeds`` (one per conv layer) turns on train-mode dropout; None trains
    without it."""
    train = seeds is not None
    with torch.no_grad():
        return fused_model_train(
            kernel_inputs(model, batch), adjoint_inputs(batch),
            batch.labels.float(), batch.graph_mask.float(),
            **_kernel_kw(model.cfg, spec, train, seeds))


def sum_partials(parts) -> tuple:
    """(SSE, gradients) summed over the (partial SSE, 11 gradients) pairs of
    ``parts`` in their order: the training kernel's launches of one step
    over several batches (data-parallel groups, edge-partition shards)."""
    sse, grads = None, None
    for s, g in parts:
        sse = s if sse is None else sse + s
        grads = g if grads is None else tuple(a + c for a, c in zip(grads, g))
    return sse, grads


def fused_train_value_and_grad(model: CGRMPNN, batch: PackedGraphBatch,
                               spec: PackSpec, seeds=None) -> torch.Tensor:
    """The masked SSE of ``batch`` by :func:`fused_train_sse_and_grads`,
    with the gradients of every parameter written into ``.grad``."""
    with span("model.grads"):
        sse, grads = fused_train_sse_and_grads(model, batch, spec, seeds)
        kernel_grads_to_params(model, grads)
    return sse


def supports_fused_train(cfg: CGRMPNNConfig) -> bool:
    """Whether the one-launch training step applies: the whole-model
    configuration (every activation of the config has a kernel)."""
    return cfg.fuse_whole_model


def _pool_scale(batch: PackedGraphBatch) -> torch.Tensor:
    """Mean pooling's 1 / (nodes of the graph), 0 for an empty slot."""
    n_cnt = (batch.graph_nodes < batch.node_x.shape[0]).sum(dim=1).float()
    return torch.where(n_cnt > 0, 1.0 / n_cnt.clamp_min(1.0), 0.0)[:, None]


def _store_dtype(cfg: CGRMPNNConfig) -> torch.dtype:
    """The type of x, e and the edge states between kernels (JAX's
    ``store_dt``)."""
    return (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
            else torch.float32)


def _linear(x: torch.Tensor, lin: Linear, bf16: bool) -> torch.Tensor:
    """x @ w + b; at bf16 JAX's ``_linear``: x and w rounded to bf16, f32
    sums, b f32."""
    if not bf16:
        return x @ lin.w + lin.b
    return round_bf16(x.float()) @ round_bf16(lin.w) + lin.b


def _linear_cat(a: torch.Tensor, b: torch.Tensor, lin: Linear,
                bf16: bool) -> torch.Tensor:
    """Linear over the concat [a ++ b] without building it (JAX's
    ``_linear_cat``, rounding as :func:`_linear`)."""
    na, w = a.shape[1], lin.w
    if bf16:
        a, b, w = round_bf16(a.float()), round_bf16(b.float()), round_bf16(w)
    return a @ w[:na] + b @ w[na:] + lin.b


def _layered(model: CGRMPNN, batch: PackedGraphBatch, spec: PackSpec,
             train: bool, seeds) -> torch.Tensor:
    """The layered-kernel forward (JAX apply's fuse_whole_model=False
    branch): gather-linear edge_init, the conv stack, gather-linear readout,
    sum pooling through the ELL gather-sum, then the mean scale and the FFN
    head in torch.  At bf16 x, e, h0 and the stack's output are bf16
    tensors; the readout writes f32 (JAX's ``h.astype(f32)`` and back to
    ``h0.dtype`` before it is the identity on those values and on their
    cotangents, so the stack's output goes to the readout as it is)."""
    cfg = model.cfg
    md = cfg.compute_dtype
    kw = dict(p=spec.p, act=ACTIVATIONS[cfg.activation], mat_dtype=md)
    mean = cfg.aggr == "mean"
    sd = _store_dtype(cfg)
    x, e = batch.node_x.to(sd), batch.edge_attr.to(sd)
    F = x.shape[1]
    wei, wen = model.edge_init, model.edge_to_node
    h0 = gather_linear(x, e, batch.senders[:, None], batch.node_out,
                       wei.w[:F], wei.w[F:], wei.b, **kw, out_dtype=md)
    h = conv_stack(h0, batch.edge_nbr, batch.rev, batch.edge_nbr_rev,
                   torch.stack([c.w for c in model.convs]),
                   torch.stack([c.b for c in model.convs]),
                   _skips(model, x.device), **kw, mean=mean, train=train,
                   seeds=seeds if train else None,
                   dropout_ps=tuple(cfg.dropout_ps) if train else ())
    hn = gather_linear(h, x, batch.node_inc, batch.receivers[:, None],
                       wen.w[F:], wen.w[:F], wen.b, **kw, mean=mean)
    pooled = spmm(hn, batch.graph_nodes, batch.graph_of_node[:, None],
                  p=spec.p, mat_dtype=md)
    if cfg.pooling == "mean":
        pooled = pooled * _pool_scale(batch)
    return _linear(pooled, model.ffn, md == "bfloat16")[:, 0]


def _inv_degree(batch: PackedGraphBatch) -> torch.Tensor:
    """aggr='mean''s 1 / (in-degree) per node, 0 for a node without
    incoming edges."""
    in_deg = (batch.node_inc < batch.senders.shape[0]).sum(dim=1).float()
    return torch.where(in_deg > 0, 1.0 / in_deg.clamp_min(1.0), 0.0)


def _capture(model: CGRMPNN, batch: PackedGraphBatch, spec: PackSpec,
             train: bool, seeds):
    """The per-layer kernel forward with every intermediate activation (JAX
    apply's capture branch with use_pallas): K7 for x[senders], the
    incoming sum and the pooling, K6 once per conv layer.  At bf16 x and e
    are bf16 tensors, ``acts["h0"]`` is edge_init's f32 output and the conv
    layers take and give bf16 (h0 rounded once, JAX's ``h0c``)."""
    cfg = model.cfg
    kact, p, md = ACTIVATIONS[cfg.activation], spec.p, cfg.compute_dtype
    bf16 = md == "bfloat16"
    sd = _store_dtype(cfg)
    x, e = batch.node_x.to(sd), batch.edge_attr.to(sd)
    wei, wen = model.edge_init, model.edge_to_node
    x_src = spmm(x, batch.senders[:, None], batch.node_out, p=p, mat_dtype=md)
    h0 = k_act(kact, _linear_cat(x_src, e, wei, bf16))
    acts = {"h0": h0}
    h0c = h0.to(sd)
    skips = _skips(model, x.device)
    seeds = seed_list(seeds) if train else [None] * cfg.depth
    h = h0c
    for l, conv in enumerate(model.convs):
        h = fused_conv_layer(h, h0c, batch.edge_nbr, batch.rev,
                             batch.edge_nbr_rev, conv.w, conv.b, skips[l],
                             p=p, act=kact, mean=cfg.aggr == "mean",
                             train=train, seed=seeds[l],
                             dropout_p=cfg.dropout_ps[l] if train else 0.0,
                             mat_dtype=md)
        acts[f"h_{l}"] = h
    s = spmm(h.float(), batch.node_inc, batch.receivers[:, None], p=p,
             mat_dtype=md)
    if cfg.aggr == "mean":
        s = s * _inv_degree(batch)[:, None]
    hn = k_act(kact, _linear_cat(x, s, wen, bf16))
    acts["s"], acts["h_node"] = s, hn
    pooled = spmm(hn, batch.graph_nodes, batch.graph_of_node[:, None], p=p,
                  mat_dtype=md)
    if cfg.pooling == "mean":
        pooled = pooled * _pool_scale(batch)
    acts["pooled"] = pooled
    return _linear(pooled, model.ffn, bf16)[:, 0], acts


def _dropout(h: torch.Tensor, rate: float, seed: int, te: int):
    """The kernels' hash dropout over the stacked [p*te, H] edge states."""
    if rate == 0.0:
        return h
    keep = hash_dropout_keep_full(h.shape[0], h.shape[1], te, seed, rate,
                                  device=h.device)
    return torch.where(keep, h * (1.0 / (1.0 - rate)), 0.0)


def apply(model: CGRMPNN, batch: PackedGraphBatch, spec: PackSpec | None = None,
          *, train: bool = False, seeds=None, capture: bool = False):
    """Forward pass -> per-graph predictions [BT] (padded slots garbage --
    mask with ``batch.graph_mask``).  With ``train=True`` each conv layer's
    output goes through the hash dropout of rate ``cfg.dropout_ps[l]`` under
    ``seeds[l]``.  With ``capture=True`` also returns a dict of intermediate
    activations.

    A batch on the card needs ``spec`` (its pack count) and goes through
    the forward kernel; with gradients enabled, through the autograd
    Function whose backward is the VJP kernel.  The CPU takes the plain
    gather ops (train mode needs ``spec`` there too, for the pack-local
    dropout rows).  With ``cfg.fuse_whole_model`` False and ``spec`` given,
    the layered kernels run instead (their plain versions on the CPU).
    ``capture=True`` with ``spec`` runs the per-layer kernels (see the
    module doc), on the card and, through their plain versions, on the
    CPU.  With ``cfg.compute_dtype="bfloat16"`` each of those paths runs
    its kernels' bf16 instantiation (on the CPU their plain versions at
    bf16), and a CPU batch without ``spec`` rounds as JAX's XLA path."""
    cfg = model.cfg
    kact = ACTIVATIONS[cfg.activation]
    x, e = batch.node_x, batch.edge_attr
    bf16 = cfg.compute_dtype == "bfloat16"

    if x.device.type == "cuda" and spec is None:
        raise ValueError("the kernels need the batch's PackSpec")
    if train and (spec is None or seeds is None):
        raise ValueError("train mode needs the batch's PackSpec and the "
                         "per-layer dropout seeds")
    if capture and spec is not None:
        return _capture(model, batch, spec, train, seeds)
    if not cfg.fuse_whole_model and spec is not None:
        return _layered(model, batch, spec, train, seeds)
    if x.device.type == "cuda" or (bf16 and spec is not None):
        return fused_model(kernel_inputs(model, batch), adjoint_inputs(batch),
                           **_kernel_kw(cfg, spec, train, seeds))
    layer_seeds = seed_list(seeds) if train else None

    # the XLA path: f32 gathers; at bf16 x and e rounded (JAX casts them),
    # and every product's operands rounded (_linear, _linear_cat)
    x, e = x.float(), e.float()
    if bf16:
        x, e = round_bf16(x), round_bf16(e)
    ET = batch.senders.shape[0]
    acts: dict[str, torch.Tensor] = {}
    if cfg.aggr == "mean":
        inv_deg = _inv_degree(batch)
        norm = gather_nodes(inv_deg[:, None], batch.senders)[:, 0]
    else:
        norm = torch.ones(ET, device=x.device)

    x_src = gather_nodes(x, batch.senders)
    h0 = k_act(kact, _linear_cat(x_src, e, model.edge_init, bf16))
    if capture:
        acts["h0"] = h0
    skips = _skips(model, x.device)
    h = h0
    for l in range(cfg.depth):
        t = dmpnn_messages(h, batch.edge_nbr, batch.rev, norm)
        h = k_act(kact, _linear(t, model.convs[l], bf16) + skips[l] * h0)
        if train:
            h = _dropout(h, cfg.dropout_ps[l], layer_seeds[l], spec.te)
        if capture:
            acts[f"h_{l}"] = h

    s = node_incoming_sum(h, batch.node_inc)
    if cfg.aggr == "mean":
        s = s * inv_deg[:, None]
    hn = k_act(kact, _linear_cat(x, s, model.edge_to_node, bf16))
    if capture:
        acts["s"] = s
        acts["h_node"] = hn

    pooled = graph_pool_sum(hn, batch.graph_nodes)
    if cfg.pooling == "mean":
        pooled = pooled * _pool_scale(batch)
    out = _linear(pooled, model.ffn, bf16)[:, 0]
    if capture:
        acts["pooled"] = pooled
        return out, acts
    return out


def sse_loss(model: CGRMPNN, batch: PackedGraphBatch, spec: PackSpec,
             train: bool = False, seeds=None) -> torch.Tensor:
    """Masked sum of squared errors of ``apply`` on ``batch``."""
    preds = apply(model, batch, spec, train=train, seeds=seeds)
    err = (preds - batch.labels) * batch.graph_mask
    return (err * err).sum()
