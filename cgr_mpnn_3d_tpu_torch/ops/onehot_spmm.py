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
included, counts as absent.  ``mat_dtype`` is the TPU kernel's: at
"bfloat16" every source value is rounded to bf16 as it is read (``src``
f32 or bf16), the sums and the output stay f32, and the backward rounds
the incoming gradient the same way and casts ``d_src`` to the type of
``src`` (``dispatch.py::_spmm_bwd``).  :func:`onehot_spmm` launches
``csrc/onehot_spmm.cu`` for CUDA tensors or raises, and takes
:func:`onehot_spmm_ref` only for CPU tensors.
"""

from __future__ import annotations

import torch

from ._launch import (I32, PTR, check_cuda, check_types, count_launch,
                      library, mat_index, ptr, raise_on, refuse_grad, stream)
from .bf16_ref import bf16_gather, bf16_onehot
from .segment import ext_zero_row, in_pack

__all__ = ["onehot_spmm", "onehot_spmm_ref", "spmm", "launches",
           "bwd_launches", "bf16_launches", "bf16_bwd_launches"]

# kernel launches by the wrappers (nothing else adds here): forward calls,
# and backward calls of the autograd Function, at f32 and at bf16
launches = 0
bwd_launches = 0
bf16_launches = 0
bf16_bwd_launches = 0

_SIGNATURES = {"cgr_onehot_spmm": ([PTR] * 4 + [I32] * 7 + [PTR], I32)}


def _types(mat_dtype: str) -> dict:
    return {"src": (torch.float32, torch.bfloat16)
            if mat_dtype == "bfloat16" else torch.float32}


def _check(src, idx, sign, p: int, mat_dtype: str) -> None:
    mat_index(mat_dtype)
    if idx.dim() != 2 or src.dim() != 2:
        raise ValueError(f"idx {tuple(idx.shape)} and src {tuple(src.shape)} "
                         f"must be 2-d")
    if p < 1 or idx.shape[0] % p or src.shape[0] % p:
        raise ValueError(f"rows of idx {tuple(idx.shape)} and src "
                         f"{tuple(src.shape)} must split into p={p} packs")
    if sign is not None and tuple(sign.shape) != (idx.shape[0],):
        raise ValueError(f"sign has shape {tuple(sign.shape)}, expected "
                         f"({idx.shape[0]},)")
    check_types(dict(src=src), _types(mat_dtype), f"mat_dtype={mat_dtype}")


def onehot_spmm_ref(src, idx, sign=None, *, p: int,
                    mat_dtype: str = "float32") -> torch.Tensor:
    """Plain PyTorch version (any device); autograd gives its backward (at
    bf16 the kernel's: the gradient rounded, ``d_src`` of src's type)."""
    _check(src, idx, sign, p, mat_dtype)
    if mat_dtype == "bfloat16":
        dt = torch.float64 if src.dtype == torch.float64 else torch.float32
        return bf16_gather(src, *bf16_onehot(idx, p, src.shape[0], False,
                                             sign, dtype=dt))
    ext = ext_zero_row(src)
    out = ext[in_pack(idx, p, src.shape[0])[0]].sum(dim=1)
    if sign is not None:
        out = out - ext[in_pack(sign, p, src.shape[0])[0]]
    return out


def _launch(src, idx, sign, p: int, mat_dtype: str) -> torch.Tensor:
    _check(src, idx, sign, p, mat_dtype)
    args = dict(src=src, idx=idx)
    if sign is not None:
        args["sign"] = sign
    check_cuda(args, src.device, {"idx", "sign"}, _types(mat_dtype))
    (R, D), (C, H) = idx.shape, src.shape
    out = torch.empty((R, H), device=src.device, dtype=torch.float32)
    lib = library("onehot_spmm", _SIGNATURES)
    with torch.cuda.device(src.device):
        err = lib.cgr_onehot_spmm(src.data_ptr(), idx.data_ptr(), ptr(sign),
                                  out.data_ptr(), p, R // p, C // p, H, D,
                                  mat_index(mat_dtype),
                                  int(src.dtype == torch.bfloat16),
                                  stream(src.device))
    raise_on(lib, err, "onehot_spmm")
    return out


def onehot_spmm(src, idx, sign=None, *, p: int,
                mat_dtype: str = "float32") -> torch.Tensor:
    """The gather-sum -> [rows of idx, H] f32.  CUDA tensors launch
    ``csrc/onehot_spmm.cu`` (its ``mat_dtype`` instantiation) or raise; CPU
    tensors take :func:`onehot_spmm_ref`.  No backward: call :func:`spmm`
    for one."""
    if src.device.type == "cpu":
        return onehot_spmm_ref(src, idx, sign, p=p, mat_dtype=mat_dtype)
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    refuse_grad([src], "onehot_spmm", "spmm()")
    out = _launch(src, idx, sign, p, mat_dtype)
    count_launch(globals(), mat_dtype, False)
    return out


class _Spmm(torch.autograd.Function):
    """Forward: K7 on the forward ELL.  Backward: K7 on the transposed ELL,
    its result cast to the type of ``src``."""

    @staticmethod
    def forward(ctx, p, mat_dtype, idx, sign, idx_bwd, sign_bwd, src):
        ctx.p, ctx.mat_dtype, ctx.dtype = p, mat_dtype, src.dtype
        ctx.bwd = idx_bwd, sign_bwd
        out = _launch(src, idx, sign, p, mat_dtype)
        count_launch(globals(), mat_dtype, False)
        return out

    @staticmethod
    def backward(ctx, g):
        idx_bwd, sign_bwd = ctx.bwd
        d_src = _launch(g.contiguous(), idx_bwd, sign_bwd, ctx.p,
                        ctx.mat_dtype)
        count_launch(globals(), ctx.mat_dtype, True)
        return (None,) * 6 + (d_src.to(ctx.dtype),)


def spmm(src, idx, idx_bwd, sign=None, sign_bwd=None, *, p: int,
         mat_dtype: str = "float32") -> torch.Tensor:
    """The gather-sum, differentiable in ``src``: on the card K7 forward
    and K7 over ``idx_bwd`` (``sign_bwd``), the transposed ELL array, in
    backward; on the CPU :func:`onehot_spmm_ref` under autograd."""
    if src.device.type == "cpu":
        return onehot_spmm_ref(src, idx, sign, p=p, mat_dtype=mat_dtype)
    return _Spmm.apply(p, mat_dtype, idx, sign, idx_bwd, sign_bwd, src)
