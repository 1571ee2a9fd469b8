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

from ._launch import (I32, PTR, check_cuda, check_train, drop_table, library,
                      ptr, raise_on, refuse_grad, seed_list, split_k, stream)
from .kernel_math import KERNEL_ACTS, hash_dropout_keep_full, k_act
from .segment import ext_zero_row, in_pack, pack_gather_sum

__all__ = ["conv_stack_forward", "conv_stack_forward_ref",
           "conv_stack_backward", "conv_stack_backward_ref", "conv_stack",
           "launches", "bwd_launches"]

# kernel launches by the wrappers (nothing else adds here)
launches = 0
bwd_launches = 0

_SIGNATURES = {
    "cgr_conv_stack_fwd": ([PTR] * 9 + [I32] * 7 + [PTR], I32),
    "cgr_conv_stack_bwd": ([PTR] * 14 + [I32] * 8 + [PTR], I32),
    "cgr_conv_stack_bwd_scratch_floats": ([I32] * 5, ctypes.c_longlong),
}
_INDEX_NAMES = {"edge_nbr", "rev", "edge_nbr_rev"}


def _check(args: dict, p: int, act: str, train: bool, seeds,
           dropout_ps) -> None:
    if act not in KERNEL_ACTS:
        raise ValueError(f"unsupported kernel activation {act!r}")
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


def conv_stack_forward_ref(h0, edge_nbr, rev, w, b, skips, *, p: int,
                           act: str = "relu", mean: bool = False,
                           train: bool = False, seeds=None,
                           dropout_ps=()) -> torch.Tensor:
    """Plain PyTorch version of the forward (any device), differentiable."""
    _check(dict(h0=h0, edge_nbr=edge_nbr, rev=rev, w=w, b=b, skips=skips), p,
           act, train, seeds, dropout_ps)
    ET, H = h0.shape
    rev_ids, _ = in_pack(rev, p, ET)
    h = h0
    for l in range(w.shape[0]):
        t = pack_gather_sum(h, edge_nbr, p, mean) - ext_zero_row(h)[rev_ids]
        h = k_act(act, t @ w[l] + b[l] + skips[l] * h0)
        if train and dropout_ps[l] > 0.0:
            keep = hash_dropout_keep_full(ET, H, ET // p, seed_list(seeds)[l],
                                          dropout_ps[l], device=h0.device)
            h = torch.where(keep, h * (1.0 / (1.0 - dropout_ps[l])), 0.0)
    return h


def conv_stack_backward_ref(h0, edge_nbr, rev, edge_nbr_rev, w, b, skips, g,
                            *, p: int, act: str = "relu", mean: bool = False,
                            train: bool = False, seeds=None, dropout_ps=()):
    """Plain version of the backward: (dh0, dw, db, dskips) by autograd
    through :func:`conv_stack_forward_ref`; ``edge_nbr_rev`` is only
    checked."""
    _check(dict(h0=h0, edge_nbr=edge_nbr, rev=rev, edge_nbr_rev=edge_nbr_rev,
                w=w, b=b, skips=skips, g=g), p, act, train, seeds, dropout_ps)
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (h0, w, b, skips)]
        y = conv_stack_forward_ref(ins[0], edge_nbr, rev, *ins[1:], p=p,
                                   act=act, mean=mean, train=train,
                                   seeds=seeds, dropout_ps=dropout_ps)
        grads = torch.autograd.grad(y, ins, g)
    return tuple(grads)


def _lib():
    return library("conv_stack", _SIGNATURES)


def _dims(h0, edge_nbr, w, p: int) -> list[int]:
    return [p, h0.shape[0] // p, w.shape[-1], w.shape[0], edge_nbr.shape[1]]


def _launch_fwd(h0, edge_nbr, rev, w, b, skips, p, act, mean, train, seeds,
                dropout_ps) -> torch.Tensor:
    args = dict(h0=h0, edge_nbr=edge_nbr, rev=rev, w=w, b=b, skips=skips)
    _check(args, p, act, train, seeds, dropout_ps)
    check_cuda(args, h0.device, _INDEX_NAMES)
    dev = h0.device
    t = torch.empty_like(h0)
    out = torch.empty_like(h0)
    drop = drop_table(train, seeds, dropout_ps, dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.cgr_conv_stack_fwd(
            *(x.data_ptr() for x in (h0, edge_nbr, rev, w, b, skips)),
            ptr(drop), t.data_ptr(), out.data_ptr(),
            *_dims(h0, edge_nbr, w, p), KERNEL_ACTS.index(act), int(mean),
            stream(dev))
    raise_on(lib, err, "conv_stack_fwd")
    return out


def conv_stack_forward(h0, edge_nbr, rev, w, b, skips, *, p: int,
                       act: str = "relu", mean: bool = False,
                       train: bool = False, seeds=None,
                       dropout_ps=()) -> torch.Tensor:
    """The forward -> the last layer's edge states [p*te, H] f32.  CUDA
    tensors launch ``csrc/conv_stack.cu`` or raise; CPU tensors take
    :func:`conv_stack_forward_ref`.  No backward: call :func:`conv_stack`
    for one."""
    global launches
    kw = dict(p=p, act=act, mean=mean, train=train, seeds=seeds,
              dropout_ps=tuple(dropout_ps))
    if h0.device.type == "cpu":
        return conv_stack_forward_ref(h0, edge_nbr, rev, w, b, skips, **kw)
    if h0.device.type != "cuda":
        raise ValueError(f"unsupported device {h0.device}")
    refuse_grad((h0, w, b, skips), "conv_stack", "conv_stack()")
    out = _launch_fwd(h0, edge_nbr, rev, w, b, skips, **kw)
    launches += 1
    return out


def _launch_bwd(h0, edge_nbr, rev, edge_nbr_rev, w, b, skips, g, p, act,
                mean, train, seeds, dropout_ps):
    args = dict(h0=h0, edge_nbr=edge_nbr, rev=rev, edge_nbr_rev=edge_nbr_rev,
                w=w, b=b, skips=skips, g=g)
    _check(args, p, act, train, seeds, dropout_ps)
    check_cuda(args, h0.device, _INDEX_NAMES)
    dev = h0.device
    dims = _dims(h0, edge_nbr, w, p)
    S = split_k(h0.shape[0])
    lib = _lib()
    n_scratch = lib.cgr_conv_stack_bwd_scratch_floats(*dims[:4], S)
    scratch = torch.empty(n_scratch, device=dev, dtype=torch.float32)
    grads = [torch.empty_like(t) for t in (h0, w, b, skips)]
    drop = drop_table(train, seeds, dropout_ps, dev)
    with torch.cuda.device(dev):
        err = lib.cgr_conv_stack_bwd(
            *(x.data_ptr() for x in (h0, edge_nbr, rev, edge_nbr_rev, w, b,
                                     skips)),
            ptr(drop), g.data_ptr(), *(x.data_ptr() for x in grads),
            scratch.data_ptr(), *dims, KERNEL_ACTS.index(act), int(mean), S,
            stream(dev))
    raise_on(lib, err, "conv_stack_bwd")
    return tuple(grads)


def conv_stack_backward(h0, edge_nbr, rev, edge_nbr_rev, w, b, skips, g, *,
                        p: int, act: str = "relu", mean: bool = False,
                        train: bool = False, seeds=None, dropout_ps=()):
    """(dh0, dw, db, dskips) from the cotangent ``g`` of the forward's
    output.  CUDA tensors launch ``csrc/conv_stack.cu`` (a replay of the
    forward, then the layers in reverse) or raise; CPU tensors take
    :func:`conv_stack_backward_ref`."""
    global bwd_launches
    kw = dict(p=p, act=act, mean=mean, train=train, seeds=seeds,
              dropout_ps=tuple(dropout_ps))
    if h0.device.type == "cpu":
        return conv_stack_backward_ref(h0, edge_nbr, rev, edge_nbr_rev, w, b,
                                       skips, g, **kw)
    grads = _launch_bwd(h0, edge_nbr, rev, edge_nbr_rev, w, b, skips, g, **kw)
    bwd_launches += 1
    return grads


class _ConvStack(torch.autograd.Function):
    """Forward: the forward kernel.  Backward: the backward kernel, which
    replays the forward from the saved inputs."""

    @staticmethod
    def forward(ctx, kw, edge_nbr, rev, edge_nbr_rev, h0, w, b, skips):
        global launches
        out = _launch_fwd(h0, edge_nbr, rev, w, b, skips, **kw)
        launches += 1
        ctx.kw = kw
        ctx.save_for_backward(edge_nbr, rev, edge_nbr_rev, h0, w, b, skips)
        return out

    @staticmethod
    def backward(ctx, g):
        global bwd_launches
        edge_nbr, rev, edge_nbr_rev, h0, w, b, skips = ctx.saved_tensors
        grads = _launch_bwd(h0, edge_nbr, rev, edge_nbr_rev, w, b, skips,
                            g.contiguous(), **ctx.kw)
        bwd_launches += 1
        return (None,) * 4 + grads


def conv_stack(h0, edge_nbr, rev, edge_nbr_rev, w, b, skips, *, p: int,
               act: str = "relu", mean: bool = False, train: bool = False,
               seeds=None, dropout_ps=()) -> torch.Tensor:
    """The forward, differentiable in h0, w, b and skips: on the card the
    forward kernel with the backward kernel as its backward, on the CPU
    :func:`conv_stack_forward_ref` under autograd."""
    kw = dict(p=p, act=act, mean=mean, train=train, seeds=seeds,
              dropout_ps=tuple(dropout_ps))
    if h0.device.type == "cpu":
        return conv_stack_forward_ref(h0, edge_nbr, rev, w, b, skips, **kw)
    return _ConvStack.apply(kw, edge_nbr, rev, edge_nbr_rev, h0, w, b, skips)
