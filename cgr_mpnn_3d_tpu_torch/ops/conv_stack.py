"""The D-MPNN conv stack (K4): its wrappers, plain versions and autograd
Function.

The counterpart of ``cgr_mpnn_3d_tpu/ops/pallas_stack.py::fused_conv_stack``
(``_fwd_call``, ``_bwd_call``).  For l < L over the edge states [p*te, H]:

    t = scale · sum_d h[edge_nbr[:, d]] - h[rev]         (h = h0 at l = 0)
    h = drop_l(act(t · w[l] + b[l] + skips[l] · h0))

with ``w`` [L, H, H], ``b`` [L, H], ``skips`` [L]; ``scale`` is 1, or 1 /
(entries counted) when ``mean`` (the rev term stays unscaled).  Train mode
takes one int32 seed and one drop rate per layer: the TPU kernels' hash
dropout (ops/kernel_math.py), bit for bit.  The backward takes the
transposed ELL array ``edge_nbr_rev`` and returns (dh0, dw, db, dskips).

``mat_dtype`` is the TPU kernels' ``mat_dtype`` and ``out_dtype`` at once
(the model's ``store_dt``): at "float32" every float tensor is f32; at
"bfloat16" h0, the output, its cotangent and dh0 are bf16, every operand
of a product and of a message gather is rounded to bf16 where it enters
(sums f32, the mean scale ``bf16(1/deg)``), and the backward rounds dpre
and dpre·wᵀ where they enter its products (``pallas_stack.py``'s
``_bwd_kernel``); weights and their gradients stay f32.

* :func:`conv_stack_forward` / :func:`conv_stack_backward` launch
  ``csrc/conv_stack.cu`` for CUDA tensors or raise, and take
  :func:`conv_stack_forward_ref` / :func:`conv_stack_backward_ref`
  (autograd through the plain forward) only for CPU tensors;
* :func:`conv_stack` is the forward differentiable in h0, w, b and skips,
  with the backward kernel as its backward on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ._launch import (I32, PTR, check_cuda, check_train, check_types,
                      count_launch, drop_table, library, mat_index, ptr,
                      raise_on, refuse_grad, seed_list, split_k, stream)
from .bf16_ref import bf16_gather, bf16_mm, bf16_onehot
from .fused_conv import fwd_scratch_elems
from .kernel_math import KERNEL_ACTS, hash_dropout_keep_full, k_act
from .segment import ext_zero_row, in_pack, pack_gather_sum

__all__ = ["conv_stack_forward", "conv_stack_forward_ref",
           "conv_stack_backward", "conv_stack_backward_ref", "conv_stack",
           "launches", "bwd_launches", "bf16_launches", "bf16_bwd_launches"]

# kernel launches by the wrappers (nothing else adds here), at f32 and at
# bf16
launches = 0
bwd_launches = 0
bf16_launches = 0
bf16_bwd_launches = 0

_SIGNATURES = {
    "cgr_conv_stack_fwd": ([PTR] * 9 + [I32] * 8 + [PTR], I32),
    "cgr_conv_stack_bwd": ([PTR] * 14 + [I32] * 9 + [PTR], I32),
    "cgr_conv_stack_bwd_scratch_bytes": ([I32] * 6, ctypes.c_longlong),
}
_INDEX_NAMES = {"edge_nbr", "rev", "edge_nbr_rev"}


def _types(mat_dtype: str) -> dict:
    """The dtype of the states (weights f32)."""
    x = torch.bfloat16 if mat_dtype == "bfloat16" else torch.float32
    return dict(h0=x, g=x)


def _check(args: dict, p: int, act: str, train: bool, seeds,
           dropout_ps, mat_dtype: str) -> None:
    if act not in KERNEL_ACTS:
        raise ValueError(f"unsupported kernel activation {act!r}")
    mat_index(mat_dtype)
    h0, edge_nbr, w = args["h0"], args["edge_nbr"], args["w"]
    if p < 1 or h0.shape[0] % p:
        raise ValueError(f"rows of h0 {tuple(h0.shape)} must split into "
                         f"p={p} packs")
    ET, L, H = h0.shape[0], w.shape[0], w.shape[-1]
    D = edge_nbr.shape[1] if edge_nbr.dim() == 2 else -1
    want = dict(h0=(ET, H), edge_nbr=(ET, D), rev=(ET,), edge_nbr_rev=(ET, D),
                w=(L, H, H), b=(L, H), skips=(L,), g=(ET, H))
    for name, tsr in args.items():
        if tuple(tsr.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(tsr.shape)}, "
                             f"expected {want[name]}")
    check_train(train, seeds, dropout_ps, L)
    check_types(args, _types(mat_dtype), f"mat_dtype={mat_dtype}")


def conv_stack_forward_ref(h0, edge_nbr, rev, w, b, skips, *, p: int,
                           act: str = "relu", mean: bool = False,
                           train: bool = False, seeds=None, dropout_ps=(),
                           mat_dtype: str = "float32") -> torch.Tensor:
    """Plain PyTorch version of the forward (any device), differentiable
    (at bf16 as the backward kernel rounds: ops/bf16_ref.py)."""
    _check(dict(h0=h0, edge_nbr=edge_nbr, rev=rev, w=w, b=b, skips=skips), p,
           act, train, seeds, dropout_ps, mat_dtype)
    ET, H = h0.shape
    if mat_dtype == "bfloat16":
        # the states stay f32 between layers and are rounded where they
        # enter a gather; h0's cotangent sums in f32 and is rounded once
        ids, coef = bf16_onehot(edge_nbr, p, ET, mean, rev, dtype=w.dtype)
        h0f = h0.to(w.dtype)

        def layer(h, l):
            return bf16_mm(bf16_gather(h, ids, coef), w[l]) + b[l] \
                + skips[l] * h0f
    else:
        rev_ids, _ = in_pack(rev, p, ET)
        h0f = h0

        def layer(h, l):
            t = pack_gather_sum(h, edge_nbr, p, mean) \
                - ext_zero_row(h)[rev_ids]
            return t @ w[l] + b[l] + skips[l] * h0
    h = h0f
    for l in range(w.shape[0]):
        h = k_act(act, layer(h, l))
        if train and dropout_ps[l] > 0.0:
            keep = hash_dropout_keep_full(ET, H, ET // p, seed_list(seeds)[l],
                                          dropout_ps[l], device=h0.device)
            h = torch.where(keep, h * (1.0 / (1.0 - dropout_ps[l])), 0.0)
    return h.to(h0.dtype)


def conv_stack_backward_ref(h0, edge_nbr, rev, edge_nbr_rev, w, b, skips, g,
                            *, p: int, act: str = "relu", mean: bool = False,
                            train: bool = False, seeds=None, dropout_ps=(),
                            mat_dtype: str = "float32"):
    """Plain version of the backward: (dh0, dw, db, dskips) by autograd
    through :func:`conv_stack_forward_ref`; ``edge_nbr_rev`` is only
    checked."""
    _check(dict(h0=h0, edge_nbr=edge_nbr, rev=rev, edge_nbr_rev=edge_nbr_rev,
                w=w, b=b, skips=skips, g=g), p, act, train, seeds, dropout_ps,
           mat_dtype)
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (h0, w, b, skips)]
        y = conv_stack_forward_ref(ins[0], edge_nbr, rev, *ins[1:], p=p,
                                   act=act, mean=mean, train=train,
                                   seeds=seeds, dropout_ps=dropout_ps,
                                   mat_dtype=mat_dtype)
        grads = torch.autograd.grad(y, ins, g)
    return tuple(grads)


def _lib():
    return library("conv_stack", _SIGNATURES)


def _dims(h0, edge_nbr, w, p: int) -> list[int]:
    return [p, h0.shape[0] // p, w.shape[-1], w.shape[0], edge_nbr.shape[1]]


def _launch_fwd(h0, edge_nbr, rev, w, b, skips, p, act, mean, train, seeds,
                dropout_ps, mat_dtype) -> torch.Tensor:
    args = dict(h0=h0, edge_nbr=edge_nbr, rev=rev, w=w, b=b, skips=skips)
    _check(args, p, act, train, seeds, dropout_ps, mat_dtype)
    check_cuda(args, h0.device, _INDEX_NAMES, _types(mat_dtype))
    dev = h0.device
    H = h0.shape[1]
    t = torch.empty(fwd_scratch_elems(h0.shape[0], H, H, mat_dtype),
                    device=dev, dtype=h0.dtype)
    out = torch.empty_like(h0)
    drop = drop_table(train, seeds, dropout_ps, dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.cgr_conv_stack_fwd(
            *(x.data_ptr() for x in (h0, edge_nbr, rev, w, b, skips)),
            ptr(drop), t.data_ptr(), out.data_ptr(),
            *_dims(h0, edge_nbr, w, p), KERNEL_ACTS.index(act), int(mean),
            mat_index(mat_dtype), stream(dev))
    raise_on(lib, err, "conv_stack_fwd")
    return out


def conv_stack_forward(h0, edge_nbr, rev, w, b, skips, *, p: int,
                       act: str = "relu", mean: bool = False,
                       train: bool = False, seeds=None, dropout_ps=(),
                       mat_dtype: str = "float32") -> torch.Tensor:
    """The forward -> the last layer's edge states [p*te, H] of h0's type.
    CUDA tensors launch ``csrc/conv_stack.cu`` (its ``mat_dtype``
    instantiation) or raise; CPU tensors take :func:`conv_stack_forward_ref`.
    No backward: call :func:`conv_stack` for one."""
    kw = dict(p=p, act=act, mean=mean, train=train, seeds=seeds,
              dropout_ps=tuple(dropout_ps), mat_dtype=mat_dtype)
    if h0.device.type == "cpu":
        return conv_stack_forward_ref(h0, edge_nbr, rev, w, b, skips, **kw)
    if h0.device.type != "cuda":
        raise ValueError(f"unsupported device {h0.device}")
    refuse_grad((h0, w, b, skips), "conv_stack", "conv_stack()")
    out = _launch_fwd(h0, edge_nbr, rev, w, b, skips, **kw)
    count_launch(globals(), mat_dtype, False)
    return out


def _launch_bwd(h0, edge_nbr, rev, edge_nbr_rev, w, b, skips, g, p, act,
                mean, train, seeds, dropout_ps, mat_dtype):
    args = dict(h0=h0, edge_nbr=edge_nbr, rev=rev, edge_nbr_rev=edge_nbr_rev,
                w=w, b=b, skips=skips, g=g)
    _check(args, p, act, train, seeds, dropout_ps, mat_dtype)
    check_cuda(args, h0.device, _INDEX_NAMES, _types(mat_dtype))
    dev = h0.device
    dims = _dims(h0, edge_nbr, w, p)
    S = split_k(h0.shape[0])
    lib = _lib()
    mat = mat_index(mat_dtype)
    n_scratch = lib.cgr_conv_stack_bwd_scratch_bytes(*dims[:4], S, mat)
    scratch = torch.empty(n_scratch, device=dev, dtype=torch.uint8)
    grads = [torch.empty_like(t) for t in (h0, w, b, skips)]
    drop = drop_table(train, seeds, dropout_ps, dev)
    with torch.cuda.device(dev):
        err = lib.cgr_conv_stack_bwd(
            *(x.data_ptr() for x in (h0, edge_nbr, rev, edge_nbr_rev, w, b,
                                     skips)),
            ptr(drop), g.data_ptr(), *(x.data_ptr() for x in grads),
            scratch.data_ptr(), *dims, KERNEL_ACTS.index(act), int(mean), S,
            mat, stream(dev))
    raise_on(lib, err, "conv_stack_bwd")
    return tuple(grads)


def conv_stack_backward(h0, edge_nbr, rev, edge_nbr_rev, w, b, skips, g, *,
                        p: int, act: str = "relu", mean: bool = False,
                        train: bool = False, seeds=None, dropout_ps=(),
                        mat_dtype: str = "float32"):
    """(dh0, dw, db, dskips) from the cotangent ``g`` of the forward's
    output.  CUDA tensors launch ``csrc/conv_stack.cu`` (a replay of the
    forward, then the layers in reverse) or raise; CPU tensors take
    :func:`conv_stack_backward_ref`."""
    kw = dict(p=p, act=act, mean=mean, train=train, seeds=seeds,
              dropout_ps=tuple(dropout_ps), mat_dtype=mat_dtype)
    if h0.device.type == "cpu":
        return conv_stack_backward_ref(h0, edge_nbr, rev, edge_nbr_rev, w, b,
                                       skips, g, **kw)
    grads = _launch_bwd(h0, edge_nbr, rev, edge_nbr_rev, w, b, skips, g, **kw)
    count_launch(globals(), mat_dtype, True)
    return grads


class _ConvStack(torch.autograd.Function):
    """Forward: the forward kernel.  Backward: the backward kernel, which
    replays the forward from the saved inputs."""

    @staticmethod
    def forward(ctx, kw, edge_nbr, rev, edge_nbr_rev, h0, w, b, skips):
        out = _launch_fwd(h0, edge_nbr, rev, w, b, skips, **kw)
        count_launch(globals(), kw["mat_dtype"], False)
        ctx.kw = kw
        ctx.save_for_backward(edge_nbr, rev, edge_nbr_rev, h0, w, b, skips)
        return out

    @staticmethod
    def backward(ctx, g):
        edge_nbr, rev, edge_nbr_rev, h0, w, b, skips = ctx.saved_tensors
        grads = _launch_bwd(h0, edge_nbr, rev, edge_nbr_rev, w, b, skips,
                            g.contiguous(), **ctx.kw)
        count_launch(globals(), ctx.kw["mat_dtype"], True)
        return (None,) * 4 + grads


def conv_stack(h0, edge_nbr, rev, edge_nbr_rev, w, b, skips, *, p: int,
               act: str = "relu", mean: bool = False, train: bool = False,
               seeds=None, dropout_ps=(),
               mat_dtype: str = "float32") -> torch.Tensor:
    """The forward, differentiable in h0, w, b and skips: on the card the
    forward kernel with the backward kernel as its backward, on the CPU
    :func:`conv_stack_forward_ref` under autograd."""
    kw = dict(p=p, act=act, mean=mean, train=train, seeds=seeds,
              dropout_ps=tuple(dropout_ps), mat_dtype=mat_dtype)
    if h0.device.type == "cpu":
        return conv_stack_forward_ref(h0, edge_nbr, rev, w, b, skips, **kw)
    return _ConvStack.apply(kw, edge_nbr, rev, edge_nbr_rev, h0, w, b, skips)
