"""The gather-linear (K5): its wrappers, plain versions and autograd Function.

The counterpart of ``cgr_mpnn_3d_tpu/ops/pallas_glin.py::fused_gather_linear``
(``_fwd_call``, ``_bwd_call``):

    out = act((G·xa)·wa + xb·wb + b),  (G·xa)[r] = scale_r · sum_d xa[idx[r, d]]

with ``xa`` [p*ca, FA] gathered pack-locally through the ELL array ``idx``
[p*R, D], ``xb`` [p*R, FB], ``wa`` [FA, H], ``wb`` [FB, H], ``b`` [H] ->
``out`` [p*R, H] f32; ``scale_r`` is 1, or 1 / (entries counted) when
``mean``.  The model calls it as edge_init (idx = senders[:, None], xa = x,
xb = e) and as the readout (idx = node_inc, xa = h, xb = x).

The backward takes the transposed ELL array ``adj`` [p*ca, Dadj] through
which dxa is gathered (node_out for edge_init, receivers[:, None] for the
readout) and returns (dxa, dxb, dwa, dwb, db).

* :func:`gather_linear_forward` / :func:`gather_linear_backward` launch
  ``csrc/gather_linear.cu`` for CUDA tensors or raise, and take
  :func:`gather_linear_forward_ref` / :func:`gather_linear_backward_ref`
  (autograd through the plain forward) only for CPU tensors;
* :func:`gather_linear` is the forward differentiable in every float input,
  with the backward kernel as its backward on the card.
"""

from __future__ import annotations

import torch

from ._launch import (I32, PTR, check_cuda, library, ptr, raise_on,
                      refuse_grad, split_k, stream)
from .kernel_math import KERNEL_ACTS, k_act
from .segment import pack_gather_sum

__all__ = ["gather_linear_forward", "gather_linear_forward_ref",
           "gather_linear_backward", "gather_linear_backward_ref",
           "gather_linear", "launches", "bwd_launches"]

# kernel launches by the wrappers (nothing else adds here)
launches = 0
bwd_launches = 0

_SIGNATURES = {
    "cgr_gather_linear_fwd": ([PTR] * 8 + [I32] * 9 + [PTR], I32),
    "cgr_gather_linear_bwd": ([PTR] * 19 + [I32] * 11 + [PTR], I32),
}
_INDEX_NAMES = {"idx", "adj"}


def _check(args: dict, p: int, act: str) -> None:
    if act not in KERNEL_ACTS:
        raise ValueError(f"unsupported kernel activation {act!r}")
    xa, xb, idx, wa = args["xa"], args["xb"], args["idx"], args["wa"]
    if p < 1 or xa.shape[0] % p or xb.shape[0] % p:
        raise ValueError(f"rows of xa {tuple(xa.shape)} and xb "
                         f"{tuple(xb.shape)} must split into p={p} packs")
    rows, H = xb.shape[0], wa.shape[1]
    want = dict(xa=(xa.shape[0], wa.shape[0]), xb=(rows, args["wb"].shape[0]),
                idx=(rows, idx.shape[1] if idx.dim() == 2 else -1),
                adj=(xa.shape[0], args["adj"].shape[1] if "adj" in args
                     and args["adj"].dim() == 2 else -1),
                wa=(wa.shape[0], H), wb=(args["wb"].shape[0], H), b=(H,),
                out=(rows, H), g=(rows, H))
    for name, tsr in args.items():
        if tuple(tsr.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(tsr.shape)}, "
                             f"expected {want[name]}")


def gather_linear_forward_ref(xa, xb, idx, wa, wb, b, *, p: int,
                              act: str = "relu",
                              mean: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the forward (any device), differentiable."""
    _check(dict(xa=xa, xb=xb, idx=idx, wa=wa, wb=wb, b=b), p, act)
    return k_act(act, pack_gather_sum(xa, idx, p, mean) @ wa + xb @ wb + b)


def gather_linear_backward_ref(xa, xb, idx, adj, wa, wb, b, out, g, *,
                               p: int, act: str = "relu", mean: bool = False):
    """Plain version of the backward: (dxa, dxb, dwa, dwb, db) by autograd
    through :func:`gather_linear_forward_ref`; ``adj`` and ``out`` are only
    checked (autograd transposes the gather itself)."""
    _check(dict(xa=xa, xb=xb, idx=idx, adj=adj, wa=wa, wb=wb, b=b, out=out,
                g=g), p, act)
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (xa, xb, wa, wb, b)]
        y = gather_linear_forward_ref(ins[0], ins[1], idx, *ins[2:], p=p,
                                      act=act, mean=mean)
        grads = torch.autograd.grad(y, ins, g)
    return tuple(grads)


def _lib():
    return library("gather_linear", _SIGNATURES)


def _dims(xa, xb, idx, wa, p: int) -> list[int]:
    return [p, xb.shape[0] // p, xa.shape[0] // p, xa.shape[1], xb.shape[1],
            wa.shape[1], idx.shape[1]]


def _launch_fwd(xa, xb, idx, wa, wb, b, p, act, mean) -> torch.Tensor:
    args = dict(xa=xa, xb=xb, idx=idx, wa=wa, wb=wb, b=b)
    _check(args, p, act)
    check_cuda(args, xa.device, _INDEX_NAMES)
    rows, FA, H = xb.shape[0], xa.shape[1], wa.shape[1]
    dev = xa.device
    t1 = torch.empty((rows, FA), device=dev, dtype=torch.float32)
    out = torch.empty((rows, H), device=dev, dtype=torch.float32)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.cgr_gather_linear_fwd(
            *(t.data_ptr() for t in (xa, xb, idx, wa, wb, b, t1, out)),
            *_dims(xa, xb, idx, wa, p), KERNEL_ACTS.index(act), int(mean),
            stream(dev))
    raise_on(lib, err, "gather_linear_fwd")
    return out


def gather_linear_forward(xa, xb, idx, wa, wb, b, *, p: int,
                          act: str = "relu",
                          mean: bool = False) -> torch.Tensor:
    """The forward -> out [p*R, H] f32.  CUDA tensors launch
    ``csrc/gather_linear.cu`` or raise; CPU tensors take
    :func:`gather_linear_forward_ref`.  Floats are float32, indices int32,
    all contiguous.  No backward: call :func:`gather_linear` for one."""
    global launches
    if xa.device.type == "cpu":
        return gather_linear_forward_ref(xa, xb, idx, wa, wb, b, p=p,
                                         act=act, mean=mean)
    if xa.device.type != "cuda":
        raise ValueError(f"unsupported device {xa.device}")
    refuse_grad((xa, xb, wa, wb, b), "gather_linear", "gather_linear()")
    out = _launch_fwd(xa, xb, idx, wa, wb, b, p, act, mean)
    launches += 1
    return out


def _launch_bwd(xa, xb, idx, adj, wa, wb, b, out, g, p, act, mean, needs):
    args = dict(xa=xa, xb=xb, idx=idx, adj=adj, wa=wa, wb=wb, b=b, out=out,
                g=g)
    _check(args, p, act)
    check_cuda(args, xa.device, _INDEX_NAMES)
    rows, FA, FB, H = xb.shape[0], xa.shape[1], xb.shape[1], wa.shape[1]
    dev = xa.device

    def empty(*shape):
        return torch.empty(shape, device=dev, dtype=torch.float32)

    grads = [empty(*t.shape) if need else None
             for t, need in zip((xa, xb, wa, wb, b), needs)]
    S = split_k(rows)
    scratch = [empty(rows, FA), empty(rows, FA), empty(rows, H), empty(rows),
               empty(S * max(FA, FB) * H)]
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.cgr_gather_linear_bwd(
            *(t.data_ptr() for t in (xa, xb, idx, adj, wa, wb, b, out, g)),
            *(ptr(t) for t in grads), *(t.data_ptr() for t in scratch),
            *_dims(xa, xb, idx, wa, p), adj.shape[1], KERNEL_ACTS.index(act),
            int(mean), S, stream(dev))
    raise_on(lib, err, "gather_linear_bwd")
    return tuple(grads)


def gather_linear_backward(xa, xb, idx, adj, wa, wb, b, out, g, *, p: int,
                           act: str = "relu", mean: bool = False,
                           needs=(True,) * 5):
    """(dxa, dxb, dwa, dwb, db) from the cotangent ``g`` of ``out``; an
    entry whose ``needs`` flag is False is None (and not computed on the
    card).  CUDA tensors launch ``csrc/gather_linear.cu`` or raise; CPU
    tensors take :func:`gather_linear_backward_ref`."""
    global bwd_launches
    if xa.device.type == "cpu":
        grads = gather_linear_backward_ref(xa, xb, idx, adj, wa, wb, b, out,
                                           g, p=p, act=act, mean=mean)
        return tuple(d if need else None for d, need in zip(grads, needs))
    grads = _launch_bwd(xa, xb, idx, adj, wa, wb, b, out, g, p, act, mean,
                        needs)
    bwd_launches += 1
    return grads


class _GatherLinear(torch.autograd.Function):
    """Forward: the forward kernel.  Backward: the backward kernel, which
    recomputes the gathered operand from the saved inputs."""

    @staticmethod
    def forward(ctx, kw, idx, adj, xa, xb, wa, wb, b):
        global launches
        out = _launch_fwd(xa, xb, idx, wa, wb, b, **kw)
        launches += 1
        ctx.kw = kw
        ctx.save_for_backward(idx, adj, xa, xb, wa, wb, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        global bwd_launches
        idx, adj, xa, xb, wa, wb, b, out = ctx.saved_tensors
        grads = _launch_bwd(xa, xb, idx, adj, wa, wb, b, out, g.contiguous(),
                            needs=ctx.needs_input_grad[3:], **ctx.kw)
        bwd_launches += 1
        return (None, None, None) + grads


def gather_linear(xa, xb, idx, adj, wa, wb, b, *, p: int, act: str = "relu",
                  mean: bool = False) -> torch.Tensor:
    """The forward, differentiable in xa, xb, wa, wb and b: on the card the
    forward kernel with the backward kernel as its backward, on the CPU
    :func:`gather_linear_forward_ref` under autograd."""
    if xa.device.type == "cpu":
        return gather_linear_forward_ref(xa, xb, idx, wa, wb, b, p=p,
                                         act=act, mean=mean)
    return _GatherLinear.apply(dict(p=p, act=act, mean=mean), idx, adj, xa,
                               xb, wa, wb, b)
