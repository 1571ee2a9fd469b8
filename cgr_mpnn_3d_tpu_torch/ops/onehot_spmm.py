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
the incoming gradient the same way and gives ``d_src`` the type of
``src`` (``dispatch.py::_spmm_bwd``; the kernel stores a bf16 ``d_src``
itself, one rounding of its f32 sum).  :func:`onehot_spmm` launches
``csrc/onehot_spmm.cu`` for CUDA tensors or raises, and takes
:func:`onehot_spmm_ref` only for CPU tensors.

On the card every call is one launch, through :func:`_run`: a group of
lanes a row, the row's chunks read with the widest vector its width and
the alignment of ``src`` and the output allow (:func:`launch_plan`, the
mirror of the kernel's own plan).  A call checks its tensors once; the
autograd Function checks the backward's ELL in its forward and launches
the backward without another check.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._launch import (I32, PTR, check_cuda, check_types, count_launch,
                      library, mat_index, raise_on, refuse_grad)
from .bf16_ref import bf16_gather, bf16_onehot
from .kernel_math import MAT_DTYPES
from .segment import ext_zero_row, in_pack

__all__ = ["onehot_spmm", "onehot_spmm_ref", "spmm", "launch_plan",
           "kernel_plan", "launches", "bwd_launches", "bf16_launches",
           "bf16_bwd_launches"]

# kernel launches by the wrappers (nothing else adds here): forward calls,
# and backward calls of the autograd Function, at f32 and at bf16
launches = 0
bwd_launches = 0
bf16_launches = 0
bf16_bwd_launches = 0

_SIGNATURES = {
    "cgr_onehot_spmm": ([PTR] * 4 + [I32] * 8 + [PTR], I32),
    "cgr_onehot_spmm_plan": ([ctypes.c_longlong, I32, I32, I32,
                              ctypes.c_ulonglong, ctypes.c_ulonglong, PTR],
                             I32)}

# csrc/onehot_spmm.cu's launch constants (tests/test_torch_spmm_grid.py
# holds them against the source): threads a block, columns a lane sums in
# a pass, fewest lanes a row, widest load in bytes
THREADS = 256
LANE_ELEMS = 16
MIN_LANES = 4
VEC_BYTES = 16

_MAT = {md: i for i, md in enumerate(MAT_DTYPES)}   # the kernel's mat
_SRC_TYPES = {0: (torch.float32,), 1: (torch.float32, torch.bfloat16)}


def launch_plan(rows: int, W: int, src_size: int, out_size: int,
                src_ptr: int, out_ptr: int, vec_bytes: int = VEC_BYTES,
                lanes: int = 0) -> tuple[int, int, int, int]:
    """(elements a chunk, lanes a row, rows a block, blocks) of a launch
    over ``rows`` rows of width ``W``, source and output elements of
    ``src_size`` and ``out_size`` bytes at these addresses -- the kernel's
    ``plan_of``: the widest chunk of at most ``vec_bytes`` of source (16 of
    output a store) that divides the row and that both addresses are
    aligned to; the fewest lanes (a power of two from MIN_LANES to 32) that
    hold the row's chunks in LANE_ELEMS columns a lane, or ``lanes`` (the
    ``-DCGR_SPMM_LANES`` build)."""
    vec, v = 1, vec_bytes // src_size
    while v >= 1:
        ob = min(v * out_size, 16)
        if (v * src_size <= 16 and W % v == 0
                and src_ptr % (v * src_size) == 0 and out_ptr % ob == 0):
            vec = v
            break
        v //= 2
    if not lanes:
        per_lane = LANE_ELEMS // vec
        need = -(-(W // vec) // per_lane)
        lanes = MIN_LANES
        while lanes < need and lanes < 32:
            lanes *= 2
    return vec, lanes, THREADS // lanes, -(-rows * lanes // THREADS)


def kernel_plan(rows: int, W: int, src_size: int, out_size: int,
                src_ptr: int, out_ptr: int) -> tuple[int, int, int, int]:
    """The plan that the current build of csrc/onehot_spmm.cu takes for
    these arguments (its ``cgr_onehot_spmm_plan``; needs nvcc), as
    :func:`launch_plan` gives it."""
    _kernel()
    plan = (ctypes.c_longlong * 4)()
    _lib.cgr_onehot_spmm_plan(rows, W, src_size, out_size, src_ptr, out_ptr,
                              plan)
    return tuple(plan)


def _types(mat_dtype: str) -> dict:
    return {"src": _SRC_TYPES[_MAT[mat_dtype]]}


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


def _fits(src, idx, sign, p: int, mat: int | None) -> bool:
    """Whether the kernel takes these tensors (one pass; :func:`_refuse`
    says why not)."""
    if (mat is None or src.dtype not in _SRC_TYPES[mat]
            or idx.dtype != torch.int32 or src.dim() != 2 or idx.dim() != 2
            or not (src.is_contiguous() and idx.is_contiguous())):
        return False
    rows, dev = idx.shape[0], src.device
    if p < 1 or rows % p or src.shape[0] % p or idx.device != dev:
        return False
    return sign is None or (sign.dtype == torch.int32 and sign.dim() == 1
                            and sign.shape[0] == rows and sign.device == dev
                            and sign.is_contiguous())


def _refuse(src, idx, sign, p: int, mat_dtype: str) -> None:
    """Raise what :func:`_fits` found wrong."""
    _check(src, idx, sign, p, mat_dtype)
    args = dict(src=src, idx=idx)
    if sign is not None:
        args["sign"] = sign
    check_cuda(args, src.device, {"idx", "sign"}, _types(mat_dtype))
    raise ValueError("onehot_spmm: inputs the kernel does not take")


_lib = _fn = None


def _kernel():
    """The launch function of the current build of csrc/onehot_spmm.cu,
    typed at the first call through each build (a build swapped into
    ``_build``'s table is typed at its own first call)."""
    global _lib, _fn
    lib = _build._libs.get("onehot_spmm")
    if lib is None or lib is not _lib:
        lib = library("onehot_spmm", _SIGNATURES)
        _lib, _fn = lib, lib.cgr_onehot_spmm
    return _fn


def _run(src, idx, sign, p: int, mat: int, out_bf16: bool = False):
    """One launch of K7 on checked tensors -> [rows of idx, W] f32, or bf16
    with ``out_bf16`` (a backward at mat 1 from an f32 gradient)."""
    (rows, D), (C, W) = idx.shape, src.shape
    out = src.new_empty((rows, W), dtype=torch.bfloat16 if out_bf16
                        else torch.float32)
    index = src.device.index
    args = (src.data_ptr(), idx.data_ptr(),
            None if sign is None else sign.data_ptr(), out.data_ptr(), p,
            rows // p, C // p, W, D, mat, src.dtype == torch.bfloat16,
            out_bf16, torch._C._cuda_getCurrentRawStream(index))
    fn = _kernel()
    if index == torch._C._cuda_getDevice():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err:
        raise_on(_lib, err, "onehot_spmm")
    return out


def _launch(src, idx, sign, p: int, mat_dtype: str) -> torch.Tensor:
    """K7 on the card, its tensors checked once -> [rows of idx, W] f32."""
    mat = _MAT.get(mat_dtype)
    if not _fits(src, idx, sign, p, mat):
        _refuse(src, idx, sign, p, mat_dtype)
    return _run(src, idx, sign, p, mat)


def onehot_spmm(src, idx, sign=None, *, p: int,
                mat_dtype: str = "float32") -> torch.Tensor:
    """The gather-sum -> [rows of idx, H] f32.  CUDA tensors launch
    ``csrc/onehot_spmm.cu`` (its ``mat_dtype`` instantiation) or raise; CPU
    tensors take :func:`onehot_spmm_ref`.  No backward: call :func:`spmm`
    for one."""
    if not src.is_cuda:
        if src.device.type == "cpu":
            return onehot_spmm_ref(src, idx, sign, p=p, mat_dtype=mat_dtype)
        raise ValueError(f"unsupported device {src.device}")
    refuse_grad([src], "onehot_spmm", "spmm()")
    out = _launch(src, idx, sign, p, mat_dtype)
    count_launch(globals(), mat_dtype, False)
    return out


def _check_bwd(src, idx_bwd, sign_bwd) -> None:
    """The backward's ELL: one int32 row per row of ``src`` (and a sign of
    as many), contiguous, on its device."""
    dev, rows = src.device, src.shape[0]
    for name, t, dim in (("idx_bwd", idx_bwd, 2), ("sign_bwd", sign_bwd, 1)):
        if t is None:
            continue
        if t.dim() != dim or t.shape[0] != rows:
            raise ValueError(f"{name} has shape {tuple(t.shape)}; the "
                             f"backward needs {dim}-d with {rows} rows, one "
                             f"per row of src")
        check_cuda({name: t}, dev, {name})


class _Spmm(torch.autograd.Function):
    """Forward: K7 on the forward ELL.  Backward: K7 on the transposed ELL,
    its result of the type of ``src``."""

    @staticmethod
    def forward(ctx, p, mat_dtype, idx, sign, idx_bwd, sign_bwd, src):
        _check_bwd(src, idx_bwd, sign_bwd)
        out = _launch(src, idx, sign, p, mat_dtype)
        ctx.p, ctx.mat_dtype, ctx.dtype = p, mat_dtype, src.dtype
        ctx.bwd = idx_bwd, sign_bwd
        count_launch(globals(), mat_dtype, False)
        return out

    @staticmethod
    def backward(ctx, g):
        idx_bwd, sign_bwd = ctx.bwd
        # g is the f32 [rows of idx, W] cotangent of the checked forward
        d_src = _run(g.contiguous(), idx_bwd, sign_bwd, ctx.p,
                     _MAT[ctx.mat_dtype], ctx.dtype == torch.bfloat16)
        count_launch(globals(), ctx.mat_dtype, True)
        return (None,) * 6 + (d_src,)


def spmm(src, idx, idx_bwd, sign=None, sign_bwd=None, *, p: int,
         mat_dtype: str = "float32") -> torch.Tensor:
    """The gather-sum, differentiable in ``src``: on the card K7 forward
    and K7 over ``idx_bwd`` (``sign_bwd``), the transposed ELL array, in
    backward (one launch without a gradient to take); on the CPU
    :func:`onehot_spmm_ref` under autograd."""
    if not src.is_cuda:
        if src.device.type == "cpu":
            return onehot_spmm_ref(src, idx, sign, p=p, mat_dtype=mat_dtype)
        raise ValueError(f"unsupported device {src.device}")
    if src.requires_grad and torch.is_grad_enabled():
        return _Spmm.apply(p, mat_dtype, idx, sign, idx_bwd, sign_bwd, src)
    out = _launch(src, idx, sign, p, mat_dtype)
    count_launch(globals(), mat_dtype, False)
    return out
