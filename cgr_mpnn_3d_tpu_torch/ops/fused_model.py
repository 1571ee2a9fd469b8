"""The whole-model kernels per pack: their wrappers and plain PyTorch versions.

The counterparts of ``cgr_mpnn_3d_tpu/ops/pallas_model.py``:

* :func:`fused_model_forward` -- the forward (K3f, ``_fwd_call`` ->
  ``_replay_forward``): edge_init, the L conv layers (with the hash dropout
  in train mode), the readout, pooling (add | mean) and the FFN head ->
  ``preds [p*tb]`` f32 (padded graph slots hold garbage: mask them with
  ``graph_mask``);
* :func:`fused_model_train` -- the training step's compute (K2,
  ``fused_model_train``): the replayed forward, the masked SSE and the 11
  parameter gradients, with dpred = 2·mask·(pred − y);
* :func:`fused_model_vjp` -- the VJP of the forward from dpred (K3b,
  ``_bwd_call``);
* :func:`fused_model` -- the forward as a ``torch.autograd.Function`` whose
  backward is the VJP kernel (``fused_model``'s custom VJP).

The model's inputs are the 18 tensors of ``models.kernel_inputs`` (x, e, the
five forward index arrays, then wx, we, be, wc, bc, skips, ws, wxn, ben,
wffn, bffn); the backward kernels also take the ``adjoint`` index arrays
(receivers, edge_nbr_rev, graph_of_node of ``models.adjoint_inputs``),
through which they transpose the forward's gathers.

Unlike the TPU kernels, which build one-hot matrices from transposed index
rows, everything here gathers straight through the packer's ELL arrays.  An
index outside the pack of the row that holds it -- the sentinel included --
counts as absent, which is what a never-matching one-hot column does on the
TPU.  For mean, the scale is 1 over the number of entries that count, and
the ``rev`` term stays unscaled.

Train mode (``train=True``) takes one int32 ``seed`` and one drop rate per
conv layer; the dropout bits are the TPU kernels' (ops/kernel_math.py).

``mat_dtype`` ("float32" or "bfloat16") is the TPU kernels' ``mat_dtype``:
at bf16 every operand of a product and of a gather-sum is rounded to bf16
(round to nearest even) where it enters, sums run in f32, the mean scale is
``bf16(1/deg)``, and the elementwise work and every stored state stay f32;
the backward rounds the operands of its own products and gathers the same
way (``pallas_model.py::_replay_forward``, ``_bwd_kernel``).  Inputs and
outputs stay f32 at both types.

Each wrapper launches its CUDA kernel (``csrc/fused_model_fwd.cu``,
``csrc/fused_model_bwd.cu``) for CUDA tensors or raises, and takes its plain
version only for CPU tensors.  The plain versions of K2 and K3b are autograd
through :func:`fused_model_forward_ref`, whose bf16 products and gathers
(ops/bf16_ref.py) round their cotangents as the kernels do.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.tracing import span
from ._launch import (I32, PTR, check_cuda, check_train, count_launch,
                      drop_table, library, ptr, raise_on, refuse_grad,
                      seed_list, stream)
from .bf16_ref import bf16_gather, bf16_mm, bf16_onehot
from .kernel_math import (KERNEL_ACTS, MAT_DTYPES, hash_dropout_keep_full,
                          k_act)
from .segment import ext_zero_row, in_pack, pack_gather_sum

__all__ = ["fused_model_forward", "fused_model_forward_ref",
           "fused_model_train", "fused_model_train_ref", "fused_model_vjp",
           "fused_model_vjp_ref", "fused_model", "GRAD_NAMES", "launches",
           "train_launches", "vjp_launches", "bf16_launches",
           "bf16_train_launches", "bf16_vjp_launches", "bwd_grid",
           "fwd_grid"]

# launches of each CUDA kernel by its wrapper (through count_launch,
# nothing else adds here): the forward (K3f), the training step (K2) and
# the VJP (K3b), with f32 products and with bf16 products
# (mat_dtype="bfloat16")
launches = 0
train_launches = 0
vjp_launches = 0
bf16_launches = 0
bf16_train_launches = 0
bf16_vjp_launches = 0

_NAMES = ("x", "e", "senders", "edge_nbr", "rev", "node_inc", "graph_nodes",
          "wx", "we", "be", "wc", "bc", "skips", "ws", "wxn", "ben", "wffn",
          "bffn")
_ADJ_NAMES = ("receivers", "edge_nbr_rev", "graph_of_node")
_INDEX_NAMES = {"senders", "edge_nbr", "rev", "node_inc", "graph_nodes",
                *_ADJ_NAMES}
# the gradients the backward kernels return, one per weight input
GRAD_NAMES = _NAMES[7:]


def _shapes(x, e, edge_nbr, graph_nodes, wc, p: int) -> dict:
    """Expected shape of every argument, from the batch and the weights."""
    if p < 1 or x.shape[0] % p or e.shape[0] % p or graph_nodes.shape[0] % p:
        raise ValueError(f"rows of x {tuple(x.shape)}, e {tuple(e.shape)} "
                         f"and graph_nodes {tuple(graph_nodes.shape)} must "
                         f"split into p={p} packs")
    NT, F = x.shape
    ET, Fe = e.shape
    BT, DN = graph_nodes.shape
    L, H = wc.shape[0], wc.shape[2]
    D = edge_nbr.shape[1]
    return dict(x=(NT, F), e=(ET, Fe), senders=(ET,), edge_nbr=(ET, D),
                rev=(ET,), node_inc=(NT, D), graph_nodes=(BT, DN),
                wx=(F, H), we=(Fe, H), be=(H,), wc=(L, H, H), bc=(L, H),
                skips=(L,), ws=(H, H), wxn=(F, H), ben=(H,), wffn=(H, 1),
                bffn=(1,), receivers=(ET,), edge_nbr_rev=(ET, D),
                graph_of_node=(NT,), labels=(BT,), mask=(BT,), dpred=(BT,))


def _check(args: dict, p: int, act: str, aggr: str, pooling: str,
           train: bool, seeds, dropout_ps, mat_dtype: str) -> None:
    if act not in KERNEL_ACTS:
        raise ValueError(f"unsupported kernel activation {act!r}")
    if mat_dtype not in MAT_DTYPES:
        raise ValueError(f"unsupported mat_dtype {mat_dtype!r}")
    for name, mode in (("aggr", aggr), ("pooling", pooling)):
        if mode not in ("add", "mean"):
            raise ValueError(f"unsupported {name} {mode!r}")
    want = _shapes(args["x"], args["e"], args["edge_nbr"],
                   args["graph_nodes"], args["wc"], p)
    for name, tsr in args.items():
        if tuple(tsr.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(tsr.shape)}, "
                             f"expected {want[name]}")
    check_train(train, seeds, dropout_ps, args["wc"].shape[0])


def fused_model_forward_ref(x, e, senders, edge_nbr, rev, node_inc,
                            graph_nodes, wx, we, be, wc, bc, skips, ws, wxn,
                            ben, wffn, bffn, *, p: int, act: str = "relu",
                            aggr: str = "add", pooling: str = "add",
                            train: bool = False, seeds=None,
                            dropout_ps=(), mat_dtype: str = "float32"
                            ) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel (any device): preds
    [p*tb].  Differentiable in the weights.

    ``mat_dtype="bfloat16"`` rounds as the TPU kernels do at bf16: every
    operand of a product and of a gather-sum to bf16, sums in f32, the mean
    scale ``bf16(1/deg)``, elementwise work (biases, skip·h0, activations,
    dropout) in f32; autograd then rounds the cotangents of every product
    and gather as the kernels' backward does."""
    args = dict(zip(_NAMES, (x, e, senders, edge_nbr, rev, node_inc,
                             graph_nodes, wx, we, be, wc, bc, skips, ws, wxn,
                             ben, wffn, bffn)))
    _check(args, p, act, aggr, pooling, train, seeds, dropout_ps, mat_dtype)
    ET, NT = e.shape[0], x.shape[0]
    H = wc.shape[2]
    mean = aggr == "mean"

    if mat_dtype == "bfloat16":
        def gather(idx, n_src, mean_, rev_=None):
            ids, coef = bf16_onehot(idx, p, n_src, mean_, rev_,
                                    dtype=x.dtype)
            return lambda src: bf16_gather(src, ids, coef)
        mm = bf16_mm
        messages = gather(edge_nbr, ET, mean, rev)
        incoming = gather(node_inc, ET, mean)
        pool = gather(graph_nodes, NT, pooling == "mean")
    else:
        rev_ids, _ = in_pack(rev, p, ET)
        mm = torch.matmul

        def messages(h):
            return (pack_gather_sum(h, edge_nbr, p, mean)
                    - ext_zero_row(h)[rev_ids])

        def incoming(h):
            return pack_gather_sum(h, node_inc, p, mean)

        def pool(hn):
            return pack_gather_sum(hn, graph_nodes, p, pooling == "mean")

    s_ids, _ = in_pack(senders, p, NT)
    h0 = k_act(act, mm(ext_zero_row(x)[s_ids], wx) + mm(e, we) + be)
    h = h0
    for l in range(wc.shape[0]):
        h = k_act(act, mm(messages(h), wc[l]) + bc[l] + skips[l] * h0)
        if train and dropout_ps[l] > 0.0:
            keep = hash_dropout_keep_full(ET, H, ET // p,
                                          seed_list(seeds)[l],
                                          dropout_ps[l], device=x.device)
            h = torch.where(keep, h * (1.0 / (1.0 - dropout_ps[l])), 0.0)
    hn = k_act(act, mm(incoming(h), ws) + mm(x, wxn) + ben)
    return mm(pool(hn), wffn)[:, 0] + bffn


def _weight_grads(inputs, kw, outer):
    """Autograd through the plain forward: (preds, grads of the weights)
    with ``outer(preds)`` the scalar whose gradient is taken."""
    with torch.enable_grad():
        ws = [t.detach().requires_grad_() for t in inputs[7:]]
        preds = fused_model_forward_ref(*inputs[:7], *ws, **kw)
        out = outer(preds)
        grads = torch.autograd.grad(out, ws)
    return out.detach(), grads


def _check_all(inputs, adjoint, extra: dict, kw: dict) -> dict:
    """Every argument of a backward kernel, checked; returns them by name."""
    args = dict(zip(_NAMES, inputs))
    args.update(zip(_ADJ_NAMES, adjoint))
    args.update(extra)
    _check(args, kw["p"], kw["act"], kw["aggr"], kw["pooling"], kw["train"],
           kw["seeds"], kw["dropout_ps"], kw.get("mat_dtype", "float32"))
    return args


def fused_model_train_ref(inputs, adjoint, labels, mask, **kw):
    """Plain version of the training kernel: (sse, the 11 weight grads).
    Autograd transposes the forward's gathers itself: ``adjoint`` is only
    checked."""
    _check_all(inputs, adjoint, dict(labels=labels, mask=mask), kw)

    def sse(preds):
        err = (preds - labels) * mask
        return (err * err).sum()
    return _weight_grads(inputs, kw, sse)


def fused_model_vjp_ref(inputs, adjoint, dpred, **kw):
    """Plain version of the VJP kernel: the 11 weight grads."""
    _check_all(inputs, adjoint, dict(dpred=dpred), kw)
    return _weight_grads(inputs, kw, lambda preds: (preds * dpred).sum())[1]


_LL = ctypes.c_longlong
_SIGNATURES = {
    "fused_model_fwd": {
        "cgr_fused_model_fwd": ([PTR] * 26 + [I32] * 14 + [PTR], I32)},
    "fused_model_bwd": {
        "cgr_fused_model_train": ([PTR] * 27 + [I32] * 14 + [PTR], I32),
        "cgr_fused_model_vjp": ([PTR] * 26 + [I32] * 14 + [PTR], I32),
        "cgr_fused_model_bwd_scratch_floats": ([I32] * 5, _LL),
        "cgr_fused_model_grad_floats": ([I32] * 4, _LL)},
}


def _lib(name: str) -> ctypes.CDLL:
    return library(name, _SIGNATURES[name])


def _grid(name: str, p: int, te: int, H: int, mat_dtype: str,
          device) -> tuple[int, int, int]:
    lib = _lib(name)
    fn = getattr(lib, f"cgr_{name}_grid")
    fn.argtypes, fn.restype = [I32] * 4 + [PTR, PTR], I32
    per_sm, sms = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        grid = fn(MAT_DTYPES.index(mat_dtype), p, te, H,
                  ctypes.byref(per_sm), ctypes.byref(sms))
    raise_on(lib, max(0, -grid), f"{name} grid")
    return grid, per_sm.value, sms.value


def bwd_grid(p: int, te: int, H: int, mat_dtype: str = "float32",
             device="cuda") -> tuple[int, int, int]:
    """(blocks, blocks per SM, SMs) of the cooperative grid that K2 and K3b
    launch at ``mat_dtype`` on ``p`` packs of ``te`` edge rows at width
    ``H`` on ``device`` (a CUDA device): one block per SM while the largest
    tile phases fit the SMs, else two."""
    return _grid("fused_model_bwd", p, te, H, mat_dtype, device)


def fwd_grid(p: int, te: int, H: int, mat_dtype: str = "float32",
             device="cuda") -> tuple[int, int, int]:
    """(blocks, blocks per SM, SMs) of the cooperative grid that K3f
    launches, by the rule of :func:`bwd_grid`."""
    return _grid("fused_model_fwd", p, te, H, mat_dtype, device)


def _dims(x, e, graph_nodes, edge_nbr, wc, p: int) -> list[int]:
    NT, F = x.shape
    ET, Fe = e.shape
    BT, DN = graph_nodes.shape
    L, H = wc.shape[0], wc.shape[2]
    return [p, ET // p, NT // p, BT // p, F, Fe, H, L, edge_nbr.shape[1], DN]


def _modes(act: str, aggr: str, pooling: str, mat_dtype: str) -> list[int]:
    return [KERNEL_ACTS.index(act), int(aggr == "mean"),
            int(pooling == "mean"), MAT_DTYPES.index(mat_dtype)]


def fused_model_forward(x, e, senders, edge_nbr, rev, node_inc, graph_nodes,
                        wx, we, be, wc, bc, skips, ws, wxn, ben, wffn, bffn,
                        *, p: int, act: str = "relu", aggr: str = "add",
                        pooling: str = "add", train: bool = False,
                        seeds=None, dropout_ps=(),
                        mat_dtype: str = "float32") -> torch.Tensor:
    """Whole-model forward -> preds [p*tb] f32.

    CUDA tensors launch ``csrc/fused_model_fwd.cu`` (one cooperative grid
    over the whole card, :func:`fwd_grid`: the forward's phases, each
    phase's tiles, row ranges and graphs of every pack spread over the
    grid) or raise; CPU tensors take :func:`fused_model_forward_ref`.
    Features and weights are float32, indices int32, all contiguous;
    ``wffn`` is [H, 1], ``skips`` [L], ``bffn`` [1].
    ``mat_dtype="bfloat16"`` runs the kernel's bf16 instantiation: the
    operands of every product and gather are rounded to bf16 as they load
    (products on the tensor cores), sums and elementwise work stay f32.
    No backward: for gradients on the card call :func:`fused_model`."""
    tensors = (x, e, senders, edge_nbr, rev, node_inc, graph_nodes, wx, we,
               be, wc, bc, skips, ws, wxn, ben, wffn, bffn)
    kw = dict(p=p, act=act, aggr=aggr, pooling=pooling, train=train,
              seeds=seeds, dropout_ps=dropout_ps, mat_dtype=mat_dtype)
    if x.device.type == "cpu":
        return fused_model_forward_ref(*tensors, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    with span("ops.k3f"):
        args = dict(zip(_NAMES, tensors))
        _check(args, p, act, aggr, pooling, train, seeds, dropout_ps,
               mat_dtype)
        check_cuda(args, x.device, _INDEX_NAMES)
        refuse_grad(tensors, "forward", "fused_model()")

        NT, ET, BT = x.shape[0], e.shape[0], graph_nodes.shape[0]
        H = wc.shape[2]
        scratch = dict(h0=(ET, H), h=(ET, H), t=(ET, H), s=(NT, H),
                       hn=(NT, H), pooled=(BT, H))
        bufs = [torch.empty(shape, device=x.device, dtype=torch.float32)
                for shape in scratch.values()]
        out = torch.empty(BT, device=x.device, dtype=torch.float32)
        drop = drop_table(train, seeds, dropout_ps, x.device)
        lib = _lib("fused_model_fwd")
        with torch.cuda.device(x.device):
            err = lib.cgr_fused_model_fwd(
                *(t.data_ptr() for t in tensors), ptr(drop),
                *(b.data_ptr() for b in bufs), out.data_ptr(),
                *_dims(x, e, graph_nodes, edge_nbr, wc, p),
                *_modes(act, aggr, pooling, mat_dtype), stream(x.device))
        count_launch(globals(), mat_dtype, False)
        raise_on(lib, err, "fused_model_fwd")
    return out


def _backward(inputs, adjoint, extra: dict, *, p, act, aggr, pooling,
              train, seeds, dropout_ps, mat_dtype):
    """Launch csrc/fused_model_bwd.cu: K2 when ``extra`` holds labels and
    mask, K3b when it holds dpred.  Returns (sse, the 11 grads)."""
    args = _check_all(inputs, adjoint, extra, dict(
        p=p, act=act, aggr=aggr, pooling=pooling, train=train, seeds=seeds,
        dropout_ps=dropout_ps, mat_dtype=mat_dtype))
    x, e, wc = args["x"], args["e"], args["wc"]
    check_cuda(args, x.device, _INDEX_NAMES)
    dims = _dims(x, e, args["graph_nodes"], args["edge_nbr"], wc, p)
    _, te, tn, tb, F, Fe, H, L = dims[:8]
    lib = _lib("fused_model_bwd")
    n_scratch = lib.cgr_fused_model_bwd_scratch_floats(te, tn, tb, H, L)
    n_grad = lib.cgr_fused_model_grad_floats(F, Fe, H, L)
    shapes = [(), *(tuple(t.shape) for t in inputs[7:])]
    if 1 + sum(t.numel() for t in inputs[7:]) != n_grad:
        raise RuntimeError("gradient layout of fused_model_bwd.cu differs "
                           "from the wrapper's")
    scratch = torch.empty(p * n_scratch, device=x.device, dtype=torch.float32)
    partial = torch.empty(p * n_grad, device=x.device, dtype=torch.float32)
    out = torch.empty(n_grad, device=x.device, dtype=torch.float32)
    drop = drop_table(train, seeds, dropout_ps, x.device)
    fn = (lib.cgr_fused_model_train if "labels" in extra
          else lib.cgr_fused_model_vjp)
    with torch.cuda.device(x.device):
        err = fn(*(t.data_ptr() for t in inputs), ptr(drop),
                 *(t.data_ptr() for t in adjoint),
                 *(t.data_ptr() for t in extra.values()),
                 scratch.data_ptr(), partial.data_ptr(), out.data_ptr(),
                 *dims, *_modes(act, aggr, pooling, mat_dtype),
                 stream(x.device))
    raise_on(lib, err, fn.__name__)
    parts = torch.split(out, [int(np.prod(s, dtype=np.int64)) for s in shapes])
    return parts[0][0], tuple(t.view(s) for t, s in zip(parts[1:], shapes[1:]))


def fused_model_train(inputs, adjoint, labels, mask, *, p: int,
                      act: str = "relu", aggr: str = "add",
                      pooling: str = "add", train: bool = False, seeds=None,
                      dropout_ps=(), mat_dtype: str = "float32"):
    """The training step's compute: (sse, grads) with grads the 11 weight
    gradients in :data:`GRAD_NAMES` order, shaped like the weights.

    CUDA tensors launch ``csrc/fused_model_bwd.cu`` (K2: one cooperative
    grid over the whole card, :func:`bwd_grid`, replays the forward,
    derives dpred = 2·mask·(pred − y) and the masked SSE, and writes each
    pack's gradients, phase after phase, each phase's tiles and row ranges
    of every pack spread over the grid; its last phase sums them over packs
    in pack order) or raise; CPU tensors take :func:`fused_model_train_ref`.  With
    ``mat_dtype="bfloat16"`` the replay and every backward product round
    their operands to bf16 (the kernel's bf16 instantiation); the partial
    gradients and their sum stay f32."""
    kw = dict(p=p, act=act, aggr=aggr, pooling=pooling, train=train,
              seeds=seeds, dropout_ps=dropout_ps, mat_dtype=mat_dtype)
    if inputs[0].device.type == "cpu":
        return fused_model_train_ref(inputs, adjoint, labels, mask, **kw)
    with span("ops.k2"):
        out = _backward(inputs, adjoint, dict(labels=labels, mask=mask),
                        **kw)
        count_launch(globals(), mat_dtype, False, "train_")
    return out


def fused_model_vjp(inputs, adjoint, dpred, *, p: int, act: str = "relu",
                    aggr: str = "add", pooling: str = "add",
                    train: bool = False, seeds=None, dropout_ps=(),
                    mat_dtype: str = "float32"):
    """The VJP of the forward: the 11 weight gradients from the cotangent
    ``dpred`` [p*tb] of the predictions.  CUDA tensors launch
    ``csrc/fused_model_bwd.cu`` (K3b, f32 or bf16 products) or raise; CPU
    tensors take :func:`fused_model_vjp_ref`."""
    kw = dict(p=p, act=act, aggr=aggr, pooling=pooling, train=train,
              seeds=seeds, dropout_ps=dropout_ps, mat_dtype=mat_dtype)
    if inputs[0].device.type == "cpu":
        return fused_model_vjp_ref(inputs, adjoint, dpred, **kw)
    with span("ops.k3b"):
        _, grads = _backward(inputs, adjoint, dict(dpred=dpred), **kw)
        count_launch(globals(), mat_dtype, False, "vjp_")
    return grads


class _FusedModel(torch.autograd.Function):
    """Forward: the forward kernel.  Backward: the VJP kernel, which
    replays the forward (nothing but the inputs is saved)."""

    @staticmethod
    def forward(ctx, kw, adjoint, *inputs):
        ctx.kw, ctx.adjoint = kw, adjoint
        ctx.save_for_backward(*inputs)
        return fused_model_forward(*inputs, **kw)

    @staticmethod
    def backward(ctx, dpred):
        grads = fused_model_vjp(ctx.saved_tensors, ctx.adjoint,
                                dpred.contiguous(), **ctx.kw)
        return (None, None) + (None,) * 7 + grads


def fused_model(inputs, adjoint, *, p: int, act: str = "relu",
                aggr: str = "add", pooling: str = "add", train: bool = False,
                seeds=None, dropout_ps=(),
                mat_dtype: str = "float32") -> torch.Tensor:
    """The forward, differentiable in the weights: on the card through the
    forward kernel with the VJP kernel as its backward, on the CPU through
    :func:`fused_model_forward_ref` (autograd gives the VJP); both in
    ``mat_dtype``."""
    kw = dict(p=p, act=act, aggr=aggr, pooling=pooling, train=train,
              seeds=seeds, dropout_ps=tuple(dropout_ps), mat_dtype=mat_dtype)
    if inputs[0].device.type == "cpu":
        return fused_model_forward_ref(*inputs, **kw)
    return _FusedModel.apply(kw, tuple(adjoint), *inputs)
