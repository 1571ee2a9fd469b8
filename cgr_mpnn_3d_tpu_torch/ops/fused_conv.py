"""One D-MPNN conv layer (K6): its wrappers, plain versions and autograd
Function.

The counterpart of ``cgr_mpnn_3d_tpu/ops/pallas_fused.py::fused_conv_layer``
(``_fwd_call``, ``_bwd_call``), which capture mode runs once per layer.
Over the edge states of p packs of te rows:

    t   = scale · sum_d h[edge_nbr[:, d]] - h[rev]
    out = drop(act(t · w + b + skip · h0))

with ``h`` [p*te, Hin], ``w`` [Hin, H], ``h0`` and ``out`` [p*te, H], ``b``
[H] and ``skip`` a 0-dim tensor (the learnable skip weight, or a constant
1); ``scale`` is 1, or 1 / (entries counted) when ``mean`` (the rev term
stays unscaled).  Train mode takes one int32 ``seed`` and one drop rate:
the TPU kernels' hash dropout (ops/kernel_math.py), bit for bit.  The
backward takes the transposed ELL array ``edge_nbr_rev`` and the forward's
output, and returns (dh, dh0, dw, db, dskip).

``mat_dtype`` is the TPU kernels' ``mat_dtype`` and ``out_dtype`` at once
(the model's ``store_dt``): at "float32" every float tensor is f32; at
"bfloat16" h, h0, the output, its cotangent, dh and dh0 are bf16, every
operand of a product and of the message gather is rounded to bf16 where
it enters (sums f32, the mean scale ``bf16(1/deg)``), and the backward
rounds dpre and dpre·wᵀ where they enter its products
(``pallas_fused.py``'s ``_bwd_kernel``); w, b, skip and their gradients
stay f32.  ``out_dtype="float32"`` at bf16 keeps the output and its
cotangent f32 (the TPU kernel's out_dtype f32).  ``act`` may also be
"linear" (the identity), K6's alone: the EP overlap path takes its
pre-activations from it (counters ``linear_launches`` and
``linear_bwd_launches``, with the ``bf16_`` prefix at bf16).

* :func:`fused_conv_forward` / :func:`fused_conv_backward` launch
  ``csrc/fused_conv.cu`` for CUDA tensors or raise, and take
  :func:`fused_conv_layer_ref` / :func:`fused_conv_backward_ref` (autograd
  through the plain forward) only for CPU tensors;
* :func:`fused_conv_layer` is the forward differentiable in h, h0, w, b and
  skip, with the backward kernel as its backward on the card.

The edge-partitioned layer (K8, ``pallas_fused.py::fused_conv_layer_r``;
K9 with a ``scale``, ``fused_conv_layer_rm``) adds the boundary
correction ``r`` [p*tn, Hin] (f32) of the layer's node slots at each edge's
sender (``senders`` [p*te], pack-local node slots):

    t[e] = s_e · (sum_d h[edge_nbr[e, d]] + r[senders[e]]) - h[rev[e]]   (K9)
    t[e] = scale · sum_d h[edge_nbr[e, d]] - h[rev[e]] + r[senders[e]]    (K8)

with ``scale`` [p*te] the per-edge global 1/in-degree of the sender (0 on
padding) and K8's scale 1, or the local mean scale when ``mean``.  The
backward also takes ``node_out`` [p*tn, D2] (the adjoint of the sender
gather) and returns (dh, dr, dh0, dw, db, dskip):
:func:`fused_conv_r_forward` / :func:`fused_conv_r_backward` (plain versions
:func:`fused_conv_layer_r_ref` / :func:`fused_conv_r_backward_ref`) and the
autograd :func:`fused_conv_layer_r`.  At ``mat_dtype="bfloat16"`` h, h0,
the output, its cotangent, dh and dh0 are bf16 while r and dr stay f32;
r and K9's scale are rounded to bf16 where they enter the sum, and t is
summed in f32 and rounded once before the product with w
(pallas_fused.py:458-465).  Counters ``r_launches`` / ``r_bwd_launches``
(K8) and ``rm_launches`` / ``rm_bwd_launches`` (K9), with the ``bf16_``
prefix at bf16.

On the card each call is one cooperative launch of
``csrc/conv_grid.cuh``'s conv grid per direction (K4 runs it per layer);
:func:`conv_bm`, :func:`conv_blocks_per_sm` and :func:`fwd_scratch_elems`
mirror its shape rules, and :func:`conv_grid` asks the library for the
grid a launch takes.
"""

from __future__ import annotations

import ctypes

import torch

from ._launch import (I32, PTR, check_cuda, check_train, check_types,
                      count_launch, drop_table, library, mat_index, ptr,
                      raise_on, refuse_grad, split_k, stream)
from .bf16_ref import bf16_gather, bf16_mm, bf16_onehot
from .kernel_math import (CONV_ACTS, KERNEL_ACTS, hash_dropout_keep_full,
                          k_act, mean_colscale, round_bf16)
from .segment import dmpnn_messages, ext_zero_row, in_pack

__all__ = ["fused_conv_forward", "fused_conv_layer_ref",
           "fused_conv_backward", "fused_conv_backward_ref",
           "fused_conv_layer", "fused_conv_r_forward",
           "fused_conv_layer_r_ref", "fused_conv_r_backward",
           "fused_conv_r_backward_ref", "fused_conv_layer_r", "launches",
           "bwd_launches", "bf16_launches", "bf16_bwd_launches",
           "linear_launches", "linear_bwd_launches", "bf16_linear_launches",
           "bf16_linear_bwd_launches", "r_launches", "r_bwd_launches",
           "rm_launches", "rm_bwd_launches", "bf16_r_launches",
           "bf16_r_bwd_launches", "bf16_rm_launches", "bf16_rm_bwd_launches",
           "CONV_ALIGN", "CONV_STAGES", "CONV_SMEM", "conv_bm",
           "conv_blocks_per_sm", "fwd_scratch_elems", "conv_grid"]

# kernel launches by the wrappers (nothing else adds here), at f32 and at
# bf16
launches = 0
bwd_launches = 0
bf16_launches = 0
bf16_bwd_launches = 0
# K6 with act="linear" (the EP overlap path), at f32 and at bf16
linear_launches = 0
linear_bwd_launches = 0
bf16_linear_launches = 0
bf16_linear_bwd_launches = 0
# the edge-partitioned layer: K8, and K9 (with the global mean scale), at
# f32 and at bf16
r_launches = 0
r_bwd_launches = 0
rm_launches = 0
rm_bwd_launches = 0
bf16_r_launches = 0
bf16_r_bwd_launches = 0
bf16_rm_launches = 0
bf16_rm_bwd_launches = 0

# csrc/conv_grid.cuh's constants: kConvAlign (elements), kConvStages,
# kConvSmem (bytes of dynamic shared memory a block)
CONV_ALIGN = 128
CONV_STAGES = 4
CONV_SMEM = CONV_STAGES * 2 * 5120


def conv_bm(rows: int, N: int, sms: int) -> int:
    """The conv grid's tile rows over ``rows`` rows whose widest product
    has N columns: 64, or 32 while the 64-row tiles do not fill the SMs."""
    return 32 if -(-rows // 64) * -(-N // 64) < sms else 64


def conv_blocks_per_sm(rows: int, N: int, bm: int, sms: int) -> int:
    """Blocks per SM: one while the tiles of ``bm`` rows fit the SMs, else
    two (as many as fit, if fewer)."""
    return 1 if -(-rows // bm) * -(-N // 64) <= sms else 2


def fwd_scratch_elems(rows: int, Hin: int, H: int, mat_dtype: str) -> int:
    """Elements of the forward's scratch ``t`` (h's dtype): t [rows, Hin],
    then at bf16 W rounded to bf16 [Hin, H] from the next multiple of
    CONV_ALIGN."""
    t = rows * Hin
    if mat_index(mat_dtype) == 0:
        return t
    return -(-t // CONV_ALIGN) * CONV_ALIGN + Hin * H


_SIGNATURES = {
    "cgr_fused_conv_fwd": ([PTR] * 10 + [I32] * 9 + [PTR], I32),
    "cgr_fused_conv_bwd": ([PTR] * 17 + [I32] * 10 + [PTR], I32),
    "cgr_fused_conv_bwd_scratch_bytes": ([I32] * 6, ctypes.c_longlong),
    "cgr_fused_conv_r_fwd": ([PTR] * 13 + [I32] * 9 + [PTR], I32),
    "cgr_fused_conv_r_bwd": ([PTR] * 22 + [I32] * 11 + [PTR], I32),
}
_INDEX_NAMES = {"edge_nbr", "rev", "edge_nbr_rev"}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _types(mat_dtype: str, out_dtype: str | None = None) -> dict:
    """The dtype of the states and of the output (weights, r and the
    scale f32)."""
    x = _DTYPES[mat_dtype]
    o = _DTYPES[out_dtype or mat_dtype]
    return dict(h=x, h0=x, out=o, g=o)


def _check(args: dict, p: int, act: str, train: bool, seed,
           dropout_p: float, mat_dtype: str, out_dtype) -> None:
    if act not in CONV_ACTS:
        raise ValueError(f"unsupported kernel activation {act!r}")
    mat_index(mat_dtype)
    if out_dtype not in (None, mat_dtype, "float32"):
        raise ValueError(f"unsupported out_dtype {out_dtype!r} at mat_dtype "
                         f"{mat_dtype!r}")
    h, edge_nbr, w = args["h"], args["edge_nbr"], args["w"]
    if p < 1 or h.shape[0] % p:
        raise ValueError(f"rows of h {tuple(h.shape)} must split into p={p} "
                         f"packs")
    ET, (Hin, H) = h.shape[0], w.shape
    D = edge_nbr.shape[1] if edge_nbr.dim() == 2 else -1
    want = dict(h=(ET, Hin), h0=(ET, H), edge_nbr=(ET, D), rev=(ET,),
                edge_nbr_rev=(ET, D), w=(Hin, H), b=(H,), skip=(),
                out=(ET, H), g=(ET, H))
    for name, tsr in args.items():
        if tuple(tsr.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(tsr.shape)}, "
                             f"expected {want[name]}")
    check_train(train, None if seed is None else [seed], (dropout_p,), 1)
    check_types(args, _types(mat_dtype, out_dtype),
                f"mat_dtype={mat_dtype}, out_dtype={out_dtype}")


def fused_conv_layer_ref(h, h0, edge_nbr, rev, w, b, skip, *, p: int,
                         act: str = "relu", mean: bool = False,
                         train: bool = False, seed=None,
                         dropout_p: float = 0.0, mat_dtype: str = "float32",
                         out_dtype: str | None = None) -> torch.Tensor:
    """Plain PyTorch version of the forward (any device), differentiable:
    ``dmpnn_messages`` over the ELL arrays with every index outside its
    row's pack sent to the sentinel, then the layer (at bf16 the one-hot
    gather and product of ops/bf16_ref.py)."""
    _check(dict(h=h, h0=h0, edge_nbr=edge_nbr, rev=rev, w=w, b=b, skip=skip),
           p, act, train, seed, dropout_p, mat_dtype, out_dtype)
    ET, H = h0.shape
    if mat_dtype == "bfloat16":
        t = bf16_gather(h, *bf16_onehot(edge_nbr, p, ET, mean, rev,
                                        dtype=w.dtype))
        out = k_act(act, bf16_mm(t, w) + b + skip * h0.to(w.dtype))
    else:
        nbr, valid = in_pack(edge_nbr, p, ET)
        norm = (mean_colscale(valid) if mean
                else torch.ones(ET, device=h.device))
        t = dmpnn_messages(h, nbr, in_pack(rev, p, ET)[0], norm)
        out = k_act(act, t @ w + b + skip * h0)
    if train and dropout_p > 0.0:
        keep = hash_dropout_keep_full(ET, H, ET // p, int(seed), dropout_p,
                                      device=h.device)
        out = torch.where(keep, out * (1.0 / (1.0 - dropout_p)), 0.0)
    return out.to(h0.dtype if out_dtype is None else
                  _out_like(h0, out_dtype))


def _out_like(h0, out_dtype: str) -> torch.dtype:
    """The output's dtype: ``out_dtype``'s, or float64 for a float64
    evaluation."""
    return torch.float64 if h0.dtype == torch.float64 else _DTYPES[out_dtype]


def fused_conv_backward_ref(h, h0, edge_nbr, rev, edge_nbr_rev, w, b, skip,
                            out, g, *, p: int, act: str = "relu",
                            mean: bool = False, train: bool = False,
                            seed=None, dropout_p: float = 0.0,
                            mat_dtype: str = "float32",
                            out_dtype: str | None = None):
    """Plain version of the backward: (dh, dh0, dw, db, dskip) by autograd
    through :func:`fused_conv_layer_ref`; ``edge_nbr_rev`` and ``out`` are
    only checked."""
    _check(dict(h=h, h0=h0, edge_nbr=edge_nbr, rev=rev,
                edge_nbr_rev=edge_nbr_rev, w=w, b=b, skip=skip, out=out, g=g),
           p, act, train, seed, dropout_p, mat_dtype, out_dtype)
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (h, h0, w, b, skip)]
        y = fused_conv_layer_ref(ins[0], ins[1], edge_nbr, rev, *ins[2:], p=p,
                                 act=act, mean=mean, train=train, seed=seed,
                                 dropout_p=dropout_p, mat_dtype=mat_dtype,
                                 out_dtype=out_dtype)
        grads = torch.autograd.grad(y, ins, g)
    return tuple(grads)


def _lib():
    return library("fused_conv", _SIGNATURES)


def conv_grid(p: int, te: int, Hin: int, H: int, mat_dtype: str = "float32",
              backward: bool = False) -> tuple[int, int, int, int]:
    """(blocks, tile rows, blocks per SM, SMs) of a launch over p·te rows on
    the current CUDA device (the occupancy query, cached per device and
    instantiation, needs the card)."""
    lib = _lib()
    fn = lib.cgr_fused_conv_grid   # typed here: not every build has it
    fn.argtypes, fn.restype = [I32] * 6 + [PTR] * 3, I32
    bm, per_sm, sms = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    grid = fn(p, te, Hin, H, mat_index(mat_dtype), int(backward),
              ctypes.byref(bm), ctypes.byref(per_sm), ctypes.byref(sms))
    raise_on(lib, -grid if grid < 0 else 0, "cgr_fused_conv_grid")
    return grid, bm.value, per_sm.value, sms.value


def _scratch_t(h, Hin: int, H: int, mat_dtype: str) -> torch.Tensor:
    return torch.empty(fwd_scratch_elems(h.shape[0], Hin, H, mat_dtype),
                       device=h.device, dtype=h.dtype)


def _dims(h, h0, edge_nbr, p: int) -> list[int]:
    return [p, h.shape[0] // p, h.shape[1], h0.shape[1], edge_nbr.shape[1]]


def _drop(train: bool, seed, dropout_p: float, device):
    return drop_table(train, None if seed is None else [seed], (dropout_p,),
                      device)


def _out_f32(mat_dtype: str, out_dtype) -> int:
    return int(mat_dtype == "bfloat16" and out_dtype == "float32")


def _count(kw: dict, backward: bool) -> None:
    count_launch(globals(), kw["mat_dtype"], backward,
                 "linear_" if kw["act"] == "linear" else "")


def _launch_fwd(h, h0, edge_nbr, rev, w, b, skip, p, act, mean, train, seed,
                dropout_p, mat_dtype, out_dtype) -> torch.Tensor:
    args = dict(h=h, h0=h0, edge_nbr=edge_nbr, rev=rev, w=w, b=b, skip=skip)
    _check(args, p, act, train, seed, dropout_p, mat_dtype, out_dtype)
    check_cuda(args, h.device, _INDEX_NAMES, _types(mat_dtype, out_dtype))
    dev = h.device
    t = _scratch_t(h, h.shape[1], h0.shape[1], mat_dtype)
    out = torch.empty(h0.shape, device=dev,
                      dtype=_DTYPES[out_dtype or mat_dtype])
    drop = _drop(train, seed, dropout_p, dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.cgr_fused_conv_fwd(
            *(x.data_ptr() for x in (h, h0, edge_nbr, rev, w, b, skip)),
            ptr(drop), t.data_ptr(), out.data_ptr(),
            *_dims(h, h0, edge_nbr, p), CONV_ACTS.index(act), int(mean),
            mat_index(mat_dtype), _out_f32(mat_dtype, out_dtype), stream(dev))
    raise_on(lib, err, "fused_conv_fwd")
    return out


def fused_conv_forward(h, h0, edge_nbr, rev, w, b, skip, *, p: int,
                       act: str = "relu", mean: bool = False,
                       train: bool = False, seed=None,
                       dropout_p: float = 0.0, mat_dtype: str = "float32",
                       out_dtype: str | None = None) -> torch.Tensor:
    """The forward -> out [p*te, H] of h's type (or ``out_dtype``).  CUDA
    tensors launch ``csrc/fused_conv.cu`` (its ``mat_dtype`` instantiation)
    or raise; CPU tensors take :func:`fused_conv_layer_ref`.  Indices
    int32, all contiguous.  No backward: call :func:`fused_conv_layer` for
    one."""
    kw = dict(p=p, act=act, mean=mean, train=train, seed=seed,
              dropout_p=dropout_p, mat_dtype=mat_dtype, out_dtype=out_dtype)
    if h.device.type == "cpu":
        return fused_conv_layer_ref(h, h0, edge_nbr, rev, w, b, skip, **kw)
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    refuse_grad((h, h0, w, b, skip), "fused_conv", "fused_conv_layer()")
    out = _launch_fwd(h, h0, edge_nbr, rev, w, b, skip, **kw)
    _count(kw, False)
    return out


def _launch_bwd(h, h0, edge_nbr, rev, edge_nbr_rev, w, b, skip, out, g, p,
                act, mean, train, seed, dropout_p, mat_dtype, out_dtype,
                needs):
    args = dict(h=h, h0=h0, edge_nbr=edge_nbr, rev=rev,
                edge_nbr_rev=edge_nbr_rev, w=w, b=b, skip=skip, out=out, g=g)
    _check(args, p, act, train, seed, dropout_p, mat_dtype, out_dtype)
    check_cuda(args, h.device, _INDEX_NAMES, _types(mat_dtype, out_dtype))
    dev = h.device
    dims = _dims(h, h0, edge_nbr, p)
    S = split_k(h.shape[0])
    lib = _lib()
    mat = mat_index(mat_dtype)
    n_scratch = lib.cgr_fused_conv_bwd_scratch_bytes(*dims[:4], S, mat)
    scratch = torch.empty(n_scratch, device=dev, dtype=torch.uint8)
    grads = [torch.empty_like(t) if need else None
             for t, need in zip((h, h0, w, b, skip), needs)]
    drop = _drop(train, seed, dropout_p, dev)
    with torch.cuda.device(dev):
        err = lib.cgr_fused_conv_bwd(
            *(x.data_ptr() for x in (h, h0, edge_nbr, rev, edge_nbr_rev, w, b,
                                     skip)),
            ptr(drop), out.data_ptr(), g.data_ptr(), *(ptr(x) for x in grads),
            scratch.data_ptr(), *dims, CONV_ACTS.index(act), int(mean), S,
            mat, _out_f32(mat_dtype, out_dtype), stream(dev))
    raise_on(lib, err, "fused_conv_bwd")
    return tuple(grads)


def fused_conv_backward(h, h0, edge_nbr, rev, edge_nbr_rev, w, b, skip, out,
                        g, *, p: int, act: str = "relu", mean: bool = False,
                        train: bool = False, seed=None,
                        dropout_p: float = 0.0, mat_dtype: str = "float32",
                        out_dtype: str | None = None, needs=(True,) * 5):
    """(dh, dh0, dw, db, dskip) from the cotangent ``g`` of the forward's
    output ``out``; an entry whose ``needs`` flag is False is None (and not
    computed on the card).  CUDA tensors launch ``csrc/fused_conv.cu`` or
    raise; CPU tensors take :func:`fused_conv_backward_ref`."""
    kw = dict(p=p, act=act, mean=mean, train=train, seed=seed,
              dropout_p=dropout_p, mat_dtype=mat_dtype, out_dtype=out_dtype)
    if h.device.type == "cpu":
        grads = fused_conv_backward_ref(h, h0, edge_nbr, rev, edge_nbr_rev, w,
                                        b, skip, out, g, **kw)
        return tuple(d if need else None for d, need in zip(grads, needs))
    grads = _launch_bwd(h, h0, edge_nbr, rev, edge_nbr_rev, w, b, skip, out,
                        g, **kw, needs=needs)
    _count(kw, True)
    return grads


class _FusedConv(torch.autograd.Function):
    """Forward: the forward kernel.  Backward: the backward kernel, which
    recomputes the messages from the saved h, h0 and output."""

    @staticmethod
    def forward(ctx, kw, edge_nbr, rev, edge_nbr_rev, h, h0, w, b, skip):
        out = _launch_fwd(h, h0, edge_nbr, rev, w, b, skip, **kw)
        _count(kw, False)
        ctx.kw = kw
        ctx.save_for_backward(edge_nbr, rev, edge_nbr_rev, h, h0, w, b, skip,
                              out)
        return out

    @staticmethod
    def backward(ctx, g):
        edge_nbr, rev, edge_nbr_rev, h, h0, w, b, skip, out = ctx.saved_tensors
        grads = _launch_bwd(h, h0, edge_nbr, rev, edge_nbr_rev, w, b, skip,
                            out, g.contiguous(), **ctx.kw,
                            needs=ctx.needs_input_grad[4:])
        _count(ctx.kw, True)
        return (None,) * 4 + grads


def fused_conv_layer(h, h0, edge_nbr, rev, edge_nbr_rev, w, b, skip, *,
                     p: int, act: str = "relu", mean: bool = False,
                     train: bool = False, seed=None,
                     dropout_p: float = 0.0, mat_dtype: str = "float32",
                     out_dtype: str | None = None) -> torch.Tensor:
    """The layer, differentiable in h, h0, w, b and skip: on the card the
    forward kernel with the backward kernel as its backward, on the CPU
    :func:`fused_conv_layer_ref` under autograd."""
    kw = dict(p=p, act=act, mean=mean, train=train, seed=seed,
              dropout_p=dropout_p, mat_dtype=mat_dtype, out_dtype=out_dtype)
    if h.device.type == "cpu":
        return fused_conv_layer_ref(h, h0, edge_nbr, rev, w, b, skip, **kw)
    return _FusedConv.apply(kw, edge_nbr, rev, edge_nbr_rev, h, h0, w, b,
                            skip)


# -- the edge-partitioned layer (K8 / K9) ------------------------------------

_R_INDEX_NAMES = {"edge_nbr", "rev", "edge_nbr_rev", "senders", "node_out"}


def _check_r(args: dict, p: int, tn: int, act: str, mean: bool, train: bool,
             seed, dropout_p: float, mat_dtype: str) -> None:
    if act not in KERNEL_ACTS:
        raise ValueError(f"unsupported kernel activation {act!r}")
    mat_index(mat_dtype)
    h, edge_nbr, w = args["h"], args["edge_nbr"], args["w"]
    if p < 1 or h.shape[0] % p:
        raise ValueError(f"rows of h {tuple(h.shape)} must split into p={p} "
                         f"packs")
    if mean and args.get("scale") is not None:
        raise ValueError("the global scale (K9) replaces the local mean")
    ET, (Hin, H) = h.shape[0], w.shape
    D = edge_nbr.shape[1] if edge_nbr.dim() == 2 else -1
    D2 = (args["node_out"].shape[1] if "node_out" in args
          and args["node_out"].dim() == 2 else -1)
    want = dict(h=(ET, Hin), r=(p * tn, Hin), h0=(ET, H), edge_nbr=(ET, D),
                rev=(ET,), senders=(ET,), scale=(ET,), edge_nbr_rev=(ET, D),
                node_out=(p * tn, D2), w=(Hin, H), b=(H,), skip=(),
                out=(ET, H), g=(ET, H))
    for name, tsr in args.items():
        if tsr is not None and tuple(tsr.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(tsr.shape)}, "
                             f"expected {want[name]}")
    check_train(train, None if seed is None else [seed], (dropout_p,), 1)
    check_types({k: v for k, v in args.items() if v is not None},
                _types(mat_dtype),
                f"the edge-partitioned conv layer at mat_dtype={mat_dtype}")


def _messages_r_bf16(h, r, edge_nbr, rev, senders, scale, p: int, tn: int,
                     mean: bool, dtype):
    """t of K8/K9 at bf16 as one one-hot gather-sum over the rows of h and
    r stacked (ops/bf16_ref.py): the neighbour entries bf16(1/deg) (mean),
    bf16(s) (K9) or 1, the rev entry -1, the r entry at the sender bf16(s)
    or 1; every source rounded to bf16, the sum f32, the backward's
    cotangent rounded (``_bwd_kernel_r``'s dh and dr)."""
    ET, PN = h.shape[0], r.shape[0]
    ids, coef = bf16_onehot(edge_nbr, p, ET, mean and scale is None, rev,
                            dtype=dtype)
    s_bf = None if scale is None else round_bf16(scale.to(dtype))
    if s_bf is not None:
        coef = torch.cat([coef[:, :-1] * s_bf[:, None], coef[:, -1:]], dim=1)
    sid, svalid = in_pack(senders, p, PN)
    sent = ET + PN
    ids = torch.cat([torch.where(ids == ET, sent, ids),
                     torch.where(sid == PN, sent, ET + sid)[:, None]], dim=1)
    c_r = svalid.to(dtype) * (1.0 if s_bf is None else s_bf)
    return bf16_gather(torch.cat([h.to(dtype), r.to(dtype)]), ids,
                       torch.cat([coef, c_r[:, None]], dim=1))


def fused_conv_layer_r_ref(h, r, h0, edge_nbr, rev, senders, w, b, skip, *,
                           p: int, tn: int, scale=None, act: str = "relu",
                           mean: bool = False, train: bool = False, seed=None,
                           dropout_p: float = 0.0,
                           mat_dtype: str = "float32") -> torch.Tensor:
    """Plain PyTorch version of K8 (K9 with ``scale``), differentiable:
    ``dmpnn_messages`` with every index outside its row's pack sent to the
    sentinel, plus the (scaled) row of r at the sender, then the layer; at
    bf16 the messages of :func:`_messages_r_bf16` and the product of
    ops/bf16_ref.py."""
    _check_r(dict(h=h, r=r, h0=h0, edge_nbr=edge_nbr, rev=rev,
                  senders=senders, scale=scale, w=w, b=b, skip=skip),
             p, tn, act, mean, train, seed, dropout_p, mat_dtype)
    ET, H = h0.shape
    if mat_dtype == "bfloat16":
        t = _messages_r_bf16(h, r, edge_nbr, rev, senders, scale, p, tn,
                             mean, w.dtype)
        out = k_act(act, bf16_mm(t, w) + b + skip * h0.to(w.dtype))
    else:
        nbr, valid = in_pack(edge_nbr, p, ET)
        if scale is not None:
            norm = scale
        elif mean:
            norm = mean_colscale(valid)
        else:
            norm = torch.ones(ET, dtype=h.dtype, device=h.device)
        t = dmpnn_messages(h, nbr, in_pack(rev, p, ET)[0], norm)
        r_src = ext_zero_row(r)[in_pack(senders, p, r.shape[0])[0]]
        t = t + (r_src if scale is None else scale[:, None] * r_src)
        out = k_act(act, t @ w + b + skip * h0)
    if train and dropout_p > 0.0:
        keep = hash_dropout_keep_full(ET, H, ET // p, int(seed), dropout_p,
                                      device=h.device)
        out = torch.where(keep, out * (1.0 / (1.0 - dropout_p)), 0.0)
    return out.to(h0.dtype)


def fused_conv_r_backward_ref(h, r, h0, edge_nbr, rev, senders, edge_nbr_rev,
                              node_out, w, b, skip, out, g, *, p: int,
                              tn: int, scale=None, act: str = "relu",
                              mean: bool = False, train: bool = False,
                              seed=None, dropout_p: float = 0.0,
                              mat_dtype: str = "float32"):
    """Plain version of the backward: (dh, dr, dh0, dw, db, dskip) by
    autograd through :func:`fused_conv_layer_r_ref`; ``edge_nbr_rev``,
    ``node_out`` and ``out`` are only checked."""
    _check_r(dict(h=h, r=r, h0=h0, edge_nbr=edge_nbr, rev=rev,
                  senders=senders, scale=scale, edge_nbr_rev=edge_nbr_rev,
                  node_out=node_out, w=w, b=b, skip=skip, out=out, g=g),
             p, tn, act, mean, train, seed, dropout_p, mat_dtype)
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (h, r, h0, w, b, skip)]
        y = fused_conv_layer_r_ref(ins[0], ins[1], ins[2], edge_nbr, rev,
                                   senders, *ins[3:], p=p, tn=tn, scale=scale,
                                   act=act, mean=mean, train=train, seed=seed,
                                   dropout_p=dropout_p, mat_dtype=mat_dtype)
        grads = torch.autograd.grad(y, ins, g)
    return tuple(grads)


def _count_r(scale, mat_dtype: str, backward: bool) -> None:
    count_launch(globals(), mat_dtype, backward,
                 "rm_" if scale is not None else "r_")


def _launch_r_fwd(h, r, h0, edge_nbr, rev, senders, w, b, skip, p, tn,
                  scale, act, mean, train, seed, dropout_p,
                  mat_dtype) -> torch.Tensor:
    args = dict(h=h, r=r, h0=h0, edge_nbr=edge_nbr, rev=rev, senders=senders,
                scale=scale, w=w, b=b, skip=skip)
    _check_r(args, p, tn, act, mean, train, seed, dropout_p, mat_dtype)
    dev = h.device
    check_cuda({k: v for k, v in args.items() if v is not None}, dev,
               _R_INDEX_NAMES, _types(mat_dtype))
    ET, Hin, H = h.shape[0], h.shape[1], h0.shape[1]
    t = _scratch_t(h, Hin, H, mat_dtype)
    out = torch.empty_like(h0)
    drop = _drop(train, seed, dropout_p, dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.cgr_fused_conv_r_fwd(
            *(ptr(x) for x in (h, r, h0, edge_nbr, rev, senders, scale, w, b,
                               skip, drop, t, out)),
            p, ET // p, tn, Hin, H, edge_nbr.shape[1], KERNEL_ACTS.index(act),
            int(mean), mat_index(mat_dtype), stream(dev))
    raise_on(lib, err, "fused_conv_r_fwd")
    return out


def fused_conv_r_forward(h, r, h0, edge_nbr, rev, senders, w, b, skip, *,
                         p: int, tn: int, scale=None, act: str = "relu",
                         mean: bool = False, train: bool = False, seed=None,
                         dropout_p: float = 0.0,
                         mat_dtype: str = "float32") -> torch.Tensor:
    """K8 (K9 with ``scale``) forward -> out [p*te, H] of h's type.  CUDA
    tensors launch ``csrc/fused_conv.cu`` (its ``mat_dtype``
    instantiation) or raise; CPU tensors take
    :func:`fused_conv_layer_r_ref`.  No backward: call
    :func:`fused_conv_layer_r` for one."""
    kw = dict(p=p, tn=tn, scale=scale, act=act, mean=mean, train=train,
              seed=seed, dropout_p=dropout_p, mat_dtype=mat_dtype)
    if h.device.type == "cpu":
        return fused_conv_layer_r_ref(h, r, h0, edge_nbr, rev, senders, w, b,
                                      skip, **kw)
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    refuse_grad((h, r, h0, w, b, skip), "fused_conv_r",
                "fused_conv_layer_r()")
    out = _launch_r_fwd(h, r, h0, edge_nbr, rev, senders, w, b, skip, **kw)
    _count_r(scale, mat_dtype, False)
    return out


def _launch_r_bwd(h, r, h0, edge_nbr, rev, senders, edge_nbr_rev, node_out,
                  w, b, skip, out, g, p, tn, scale, act, mean, train, seed,
                  dropout_p, mat_dtype, needs):
    args = dict(h=h, r=r, h0=h0, edge_nbr=edge_nbr, rev=rev, senders=senders,
                scale=scale, edge_nbr_rev=edge_nbr_rev, node_out=node_out,
                w=w, b=b, skip=skip, out=out, g=g)
    _check_r(args, p, tn, act, mean, train, seed, dropout_p, mat_dtype)
    dev = h.device
    check_cuda({k: v for k, v in args.items() if v is not None}, dev,
               _R_INDEX_NAMES, _types(mat_dtype))
    ET, Hin, H = h.shape[0], h.shape[1], h0.shape[1]
    S = split_k(ET)
    lib = _lib()
    mat = mat_index(mat_dtype)
    n_scratch = lib.cgr_fused_conv_bwd_scratch_bytes(p, ET // p, Hin, H, S,
                                                     mat)
    scratch = torch.empty(n_scratch, device=dev, dtype=torch.uint8)
    grads = [torch.empty_like(t) if need else None
             for t, need in zip((h, r, h0, w, b, skip), needs)]
    drop = _drop(train, seed, dropout_p, dev)
    with torch.cuda.device(dev):
        err = lib.cgr_fused_conv_r_bwd(
            *(ptr(x) for x in (h, r, h0, edge_nbr, rev, senders, scale,
                               edge_nbr_rev, node_out, w, b, skip, drop, out,
                               g)),
            *(ptr(x) for x in grads), scratch.data_ptr(), p, ET // p, tn,
            Hin, H, edge_nbr.shape[1], node_out.shape[1],
            KERNEL_ACTS.index(act), int(mean), S, mat, stream(dev))
    raise_on(lib, err, "fused_conv_r_bwd")
    return tuple(grads)


def fused_conv_r_backward(h, r, h0, edge_nbr, rev, senders, edge_nbr_rev,
                          node_out, w, b, skip, out, g, *, p: int, tn: int,
                          scale=None, act: str = "relu", mean: bool = False,
                          train: bool = False, seed=None,
                          dropout_p: float = 0.0, mat_dtype: str = "float32",
                          needs=(True,) * 6):
    """(dh, dr, dh0, dw, db, dskip) from the cotangent ``g`` of ``out``; an
    entry whose ``needs`` flag is False is None (and not computed on the
    card).  CUDA tensors launch ``csrc/fused_conv.cu`` or raise; CPU
    tensors take :func:`fused_conv_r_backward_ref`."""
    kw = dict(p=p, tn=tn, scale=scale, act=act, mean=mean, train=train,
              seed=seed, dropout_p=dropout_p, mat_dtype=mat_dtype)
    if h.device.type == "cpu":
        grads = fused_conv_r_backward_ref(h, r, h0, edge_nbr, rev, senders,
                                          edge_nbr_rev, node_out, w, b, skip,
                                          out, g, **kw)
        return tuple(d if need else None for d, need in zip(grads, needs))
    grads = _launch_r_bwd(h, r, h0, edge_nbr, rev, senders, edge_nbr_rev,
                          node_out, w, b, skip, out, g, **kw, needs=needs)
    _count_r(scale, mat_dtype, True)
    return grads


class _FusedConvR(torch.autograd.Function):
    """Forward: K8 (K9).  Backward: its backward kernel, which recomputes
    the messages from the saved inputs."""

    @staticmethod
    def forward(ctx, kw, edge_nbr, rev, senders, edge_nbr_rev, node_out,
                scale, h, r, h0, w, b, skip):
        out = _launch_r_fwd(h, r, h0, edge_nbr, rev, senders, w, b, skip,
                            scale=scale, **kw)
        _count_r(scale, kw["mat_dtype"], False)
        ctx.kw = kw
        ctx.save_for_backward(edge_nbr, rev, senders, edge_nbr_rev, node_out,
                              scale, h, r, h0, w, b, skip, out)
        return out

    @staticmethod
    def backward(ctx, g):
        (edge_nbr, rev, senders, edge_nbr_rev, node_out, scale, h, r, h0, w,
         b, skip, out) = ctx.saved_tensors
        grads = _launch_r_bwd(h, r, h0, edge_nbr, rev, senders, edge_nbr_rev,
                              node_out, w, b, skip, out, g.contiguous(),
                              scale=scale, **ctx.kw,
                              needs=ctx.needs_input_grad[7:])
        _count_r(scale, ctx.kw["mat_dtype"], True)
        return (None,) * 7 + grads


def fused_conv_layer_r(h, r, h0, edge_nbr, rev, edge_nbr_rev, senders,
                       node_out, w, b, skip, *, p: int, tn: int, scale=None,
                       act: str = "relu", mean: bool = False,
                       train: bool = False, seed=None,
                       dropout_p: float = 0.0,
                       mat_dtype: str = "float32") -> torch.Tensor:
    """K8 (K9 with ``scale``), differentiable in h, r, h0, w, b and skip: on
    the card the forward kernel with the backward kernel as its backward,
    on the CPU :func:`fused_conv_layer_r_ref` under autograd."""
    kw = dict(p=p, tn=tn, act=act, mean=mean, train=train, seed=seed,
              dropout_p=dropout_p, mat_dtype=mat_dtype)
    if h.device.type == "cpu":
        return fused_conv_layer_r_ref(h, r, h0, edge_nbr, rev, senders, w, b,
                                      skip, scale=scale, **kw)
    return _FusedConvR.apply(kw, edge_nbr, rev, senders, edge_nbr_rev,
                             node_out, scale, h, r, h0, w, b, skip)
