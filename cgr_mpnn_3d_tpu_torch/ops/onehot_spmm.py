"""The pack-local ELL gather-sum (K7): its wrapper, plain version and
autograd Function.

The counterpart of ``cgr_mpnn_3d_tpu/ops/pallas_ops.py::onehot_spmm_t`` and
of ``ops/dispatch.py::spmm_t``:

* :func:`onehot_spmm` -- ``out[r] = sum_d src[idx[r, d]] (- src[sign[r]])``
  for ``idx`` [p*R, D] (the packer's ELL array, not the TPU's transposed
  index rows), ``sign`` [p*R] or None, ``src`` [p*C, H] -> [p*R, H] f32;
* :func:`spmm` -- the same, differentiable in ``src``: its backward is the
  same kernel over the transposed ELL array (``dispatch.py``'s table):

      op             forward ELL (sign)       backward ELL (sign)
      messages       edge_nbr (rev)           edge_nbr_rev (rev)
      incoming sum   node_inc                 receivers[:, None]
      x[senders]     senders[:, None]         node_out
      sum pooling    graph_nodes              graph_of_node[:, None]

An index outside the pack of its row (``row // R``), the sentinel
included, counts as absent.  :func:`onehot_spmm` launches
``csrc/onehot_spmm.cu`` for CUDA tensors or raises, and takes
:func:`onehot_spmm_ref` only for CPU tensors.
"""

from __future__ import annotations

import torch

from ._launch import (I32, PTR, check_cuda, library, ptr, raise_on,
                      refuse_grad, stream)
from .segment import ext_zero_row, in_pack

__all__ = ["onehot_spmm", "onehot_spmm_ref", "spmm", "launches",
           "bwd_launches"]

# kernel launches by the wrappers (nothing else adds here): forward calls,
# and backward calls of the autograd Function
launches = 0
bwd_launches = 0

_SIGNATURES = {"cgr_onehot_spmm": ([PTR] * 4 + [I32] * 5 + [PTR], I32)}


def _check(src, idx, sign, p: int) -> None:
    if idx.dim() != 2 or src.dim() != 2:
        raise ValueError(f"idx {tuple(idx.shape)} and src {tuple(src.shape)} "
                         f"must be 2-d")
    if p < 1 or idx.shape[0] % p or src.shape[0] % p:
        raise ValueError(f"rows of idx {tuple(idx.shape)} and src "
                         f"{tuple(src.shape)} must split into p={p} packs")
    if sign is not None and tuple(sign.shape) != (idx.shape[0],):
        raise ValueError(f"sign has shape {tuple(sign.shape)}, expected "
                         f"({idx.shape[0]},)")


def onehot_spmm_ref(src, idx, sign=None, *, p: int) -> torch.Tensor:
    """Plain PyTorch version (any device); autograd gives its backward."""
    _check(src, idx, sign, p)
    ext = ext_zero_row(src)
    out = ext[in_pack(idx, p, src.shape[0])[0]].sum(dim=1)
    if sign is not None:
        out = out - ext[in_pack(sign, p, src.shape[0])[0]]
    return out


def _launch(src, idx, sign, p: int) -> torch.Tensor:
    _check(src, idx, sign, p)
    args = dict(src=src, idx=idx)
    if sign is not None:
        args["sign"] = sign
    check_cuda(args, src.device, {"idx", "sign"})
    (R, D), (C, H) = idx.shape, src.shape
    out = torch.empty((R, H), device=src.device, dtype=torch.float32)
    lib = library("onehot_spmm", _SIGNATURES)
    with torch.cuda.device(src.device):
        err = lib.cgr_onehot_spmm(src.data_ptr(), idx.data_ptr(), ptr(sign),
                                  out.data_ptr(), p, R // p, C // p, H, D,
                                  stream(src.device))
    raise_on(lib, err, "onehot_spmm")
    return out


def onehot_spmm(src, idx, sign=None, *, p: int) -> torch.Tensor:
    """The gather-sum -> [rows of idx, H] f32.  CUDA tensors launch
    ``csrc/onehot_spmm.cu`` or raise; CPU tensors take
    :func:`onehot_spmm_ref`.  No backward: call :func:`spmm` for one."""
    global launches
    if src.device.type == "cpu":
        return onehot_spmm_ref(src, idx, sign, p=p)
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    refuse_grad([src], "onehot_spmm", "spmm()")
    out = _launch(src, idx, sign, p)
    launches += 1
    return out


class _Spmm(torch.autograd.Function):
    """Forward: K7 on the forward ELL.  Backward: K7 on the transposed ELL."""

    @staticmethod
    def forward(ctx, p, idx, sign, idx_bwd, sign_bwd, src):
        global launches
        ctx.p, ctx.bwd = p, (idx_bwd, sign_bwd)
        out = _launch(src, idx, sign, p)
        launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        global bwd_launches
        idx_bwd, sign_bwd = ctx.bwd
        d_src = _launch(g.contiguous(), idx_bwd, sign_bwd, ctx.p)
        bwd_launches += 1
        return None, None, None, None, None, d_src


def spmm(src, idx, idx_bwd, sign=None, sign_bwd=None, *,
         p: int) -> torch.Tensor:
    """The gather-sum, differentiable in ``src``: on the card K7 forward
    and K7 over ``idx_bwd`` (``sign_bwd``), the transposed ELL array, in
    backward; on the CPU :func:`onehot_spmm_ref` under autograd."""
    if src.device.type == "cpu":
        return onehot_spmm_ref(src, idx, sign, p=p)
    return _Spmm.apply(p, idx, sign, idx_bwd, sign_bwd, src)
