"""The gather-linear (K5): its wrappers, plain versions and autograd Function.

The counterpart of ``cgr_mpnn_3d_tpu/ops/pallas_glin.py::fused_gather_linear``
(``_fwd_call``, ``_bwd_call``):

    out = act((G·xa)·wa + xb·wb + b),  (G·xa)[r] = scale_r · sum_d xa[idx[r, d]]

with ``xa`` [p*ca, FA] gathered pack-locally through the ELL array ``idx``
[p*R, D], ``xb`` [p*R, FB], ``wa`` [FA, H], ``wb`` [FB, H], ``b`` [H] ->
``out`` [p*R, H]; ``scale_r`` is 1, or 1 / (entries counted) when
``mean``.  The model calls it as edge_init (idx = senders[:, None], xa = x,
xb = e) and as the readout (idx = node_inc, xa = h, xb = x).

The backward takes the transposed ELL array ``adj`` [p*ca, Dadj] through
which dxa is gathered (node_out for edge_init, receivers[:, None] for the
readout) and returns (dxa, dxb, dwa, dwb, db).

``mat_dtype`` and ``out_dtype`` are the TPU kernel's: at "float32" every
float tensor is f32.  At "bfloat16" ``xa`` and ``xb`` are bf16 tensors
(the model's x, e and h are), every operand of a product and of the
gather is rounded to bf16 where it enters (sums f32, the mean scale
``bf16(1/deg)``), ``out`` and its cotangent are at ``out_dtype`` (bf16 for
edge_init's h0, f32 for the readout), and dxa, dxb come back bf16
(``_fgl_bwd``'s ``.astype(xa.dtype)``); the backward rounds dpre and the
gathered dpre·waᵀ where they enter its products; weights and their
gradients stay f32.

* :func:`gather_linear_forward` / :func:`gather_linear_backward` launch
  ``csrc/gather_linear.cu`` for CUDA tensors or raise, and take
  :func:`gather_linear_forward_ref` / :func:`gather_linear_backward_ref`
  (autograd through the plain forward) only for CPU tensors;
* :func:`gather_linear` is the forward differentiable in every float input,
  with the backward kernel as its backward on the card.

The edge-partitioned readout: K10
(``pallas_glin.py::fused_gather_linear_r``) adds ``xr`` [p*R, FA] (f32),
rows aligned with the output's, to the gathered sum,

    out = act((G·xa + xr)·wa + xb·wb + b),      dxr = dpre·waᵀ,

and K11 (``fused_gather_linear_pool``) also returns the per-pack group pool
``pool[q] = sum_{n in pool_ell[q]} out[n]`` [p*GP, H] through the per-group
node ELL ``pool_ell`` [p*GP, DN] (on the card an ordered split sum: each
row's entries in :func:`pool_chunks` chunks of ``POOL_CHUNK``, partials
summed in chunk order); its backward takes the pool's cotangent
through ``node_group`` [p*R] (the transpose: the group of each row).  One
CUDA entry point serves both (K10 is K11 with the pool off):
:func:`gather_linear_r_forward` / :func:`gather_linear_r_backward` /
:func:`gather_linear_r` and :func:`gather_linear_pool_forward` /
:func:`gather_linear_pool_backward` / :func:`gather_linear_pool`, with the
plain versions ``*_ref``.  ``mat_dtype`` is K5's with the readout's f32
output: at bf16 xa, xb, dxa and dxb are bf16 while xr, dxr, the output,
the pool and their cotangents stay f32; xr joins the gathered sum
unrounded, the pool sums bf16(out) and its cotangent enters the backward
rounded (pallas_glin.py:316-319, :497, :527).  Counters ``r_launches`` /
``r_bwd_launches`` (K10) and ``pool_launches`` / ``pool_bwd_launches``
(K11), with the ``bf16_`` prefix at bf16.

On the card each call is one cooperative launch per direction of
``csrc/gather_linear.cu``'s grid (on ``csrc/conv_grid.cuh``'s tile), with
one scratch allocation sized by the library
(``cgr_gather_linear_{fwd,bwd}_scratch_bytes``); :func:`padded`,
:func:`xb_copied`, :func:`scratch_bytes` and :func:`glin_tiles` mirror its
layout and shape rule, and :func:`glin_grid` asks the library for the grid
a launch takes.
"""

from __future__ import annotations

import ctypes

import torch

from ._launch import (I32, PTR, check_cuda, check_types, count_launch,
                      library, mat_index, ptr, raise_on, refuse_grad,
                      split_k, stream)
from .bf16_ref import bf16_gather, bf16_mm, bf16_onehot
from .fused_conv import conv_blocks_per_sm, conv_bm
from .kernel_math import KERNEL_ACTS, k_act
from .segment import ext_zero_row, in_pack, pack_gather_sum

__all__ = ["gather_linear_forward", "gather_linear_forward_ref",
           "gather_linear_backward", "gather_linear_backward_ref",
           "gather_linear", "gather_linear_r_forward",
           "gather_linear_r_forward_ref", "gather_linear_r_backward",
           "gather_linear_r_backward_ref", "gather_linear_r",
           "gather_linear_pool_forward", "gather_linear_pool_forward_ref",
           "gather_linear_pool_backward", "gather_linear_pool_backward_ref",
           "gather_linear_pool", "launches", "bwd_launches", "bf16_launches",
           "bf16_bwd_launches", "r_launches", "r_bwd_launches",
           "pool_launches", "pool_bwd_launches", "bf16_r_launches",
           "bf16_r_bwd_launches", "bf16_pool_launches",
           "bf16_pool_bwd_launches", "POOL_CHUNK", "pool_chunks",
           "GLIN_PAD", "padded", "xb_copied", "scratch_bytes", "glin_tiles",
           "glin_grid"]

# kernel launches by the wrappers (nothing else adds here), at f32 and at
# bf16
launches = 0
bwd_launches = 0
bf16_launches = 0
bf16_bwd_launches = 0
# the edge-partitioned readout: K10, and K11 (with the group pool), at f32
# and at bf16
r_launches = 0
r_bwd_launches = 0
pool_launches = 0
pool_bwd_launches = 0
bf16_r_launches = 0
bf16_r_bwd_launches = 0
bf16_pool_launches = 0
bf16_pool_bwd_launches = 0

_SIGNATURES = {
    "cgr_gather_linear_fwd": ([PTR] * 8 + [I32] * 11 + [PTR], I32),
    "cgr_gather_linear_bwd": ([PTR] * 15 + [I32] * 13 + [PTR], I32),
    "cgr_gather_linear_r_fwd": ([PTR] * 11 + [I32] * 13 + [PTR], I32),
    "cgr_gather_linear_r_bwd": ([PTR] * 19 + [I32] * 13 + [PTR], I32),
    "cgr_gather_linear_fwd_scratch_bytes": ([I32] * 8, ctypes.c_longlong),
    "cgr_gather_linear_bwd_scratch_bytes": ([I32] * 7, ctypes.c_longlong),
    "cgr_gather_linear_grid": ([I32] * 7 + [ctypes.POINTER(I32)] * 3, I32),
}
# csrc/gather_linear.cu's kGlinPad: t1's (and a copied xb's) row stride is
# a multiple of it (whole 16-byte chunks at f32 and bf16)
GLIN_PAD = 8
_CARVE = 256        # layered_common.cuh::Carve aligns each buffer to it


def padded(n: int) -> int:
    """The row stride of t1 (width n) in the scratch: n rounded up to a
    multiple of GLIN_PAD."""
    return -(-n // GLIN_PAD) * GLIN_PAD


def xb_copied(FB: int) -> bool:
    """Whether the kernel copies xb (width FB) to its padded stride: when
    its rows are not whole chunks."""
    return padded(FB) != FB


def scratch_bytes(backward: bool, p: int, R: int, FA: int, FB: int, H: int,
                  mat_dtype: str, S: int = 0, GP: int = 0,
                  chunks: int = 1) -> int:
    """Bytes of a direction's scratch, the layout the kernel carves:
    forward t1 [rows, padded(FA)], xb's copy, at bf16 wa and wb rounded,
    K11's pool partials and flags (more than one chunk); backward t1,
    xb's copy, the bf16 weights, dt [rows, FA] (at f32), dpre, rscale,
    dpre rounded at bf16, and S split-K partials [S, FA + FB + 1, H]; each
    buffer 256-byte aligned."""
    e = 2 if mat_dtype == "bfloat16" else 4
    bf16 = e == 2
    rows = p * R
    sizes = [rows * padded(FA) * e]
    if xb_copied(FB):
        sizes.append(rows * padded(FB) * e)
    if bf16:
        sizes += [FA * H * e, FB * H * e]
    if not backward:
        if GP and chunks > 1:
            sizes += [p * GP * chunks * H * 4, p * GP * chunks * 4]
    else:
        sizes += [rows * FA * 4, rows * H * 4, rows * 4]
        if bf16:
            sizes.append(rows * H * 2)
        sizes.append(S * (FA + FB + 1) * H * 4)
    return sum(-(-n // _CARVE) * _CARVE for n in sizes)


_INDEX_NAMES = {"idx", "adj"}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _types(mat_dtype: str, out_dtype: str) -> dict:
    """The dtype of every float argument at these types (weights f32)."""
    x = _DTYPES[mat_dtype]
    return dict(xa=x, xb=x, out=_DTYPES[out_dtype], g=_DTYPES[out_dtype])


def _check(args: dict, p: int, act: str, mat_dtype: str,
           out_dtype: str) -> None:
    if act not in KERNEL_ACTS:
        raise ValueError(f"unsupported kernel activation {act!r}")
    mat_index(mat_dtype)
    if out_dtype not in _DTYPES or (mat_dtype == "float32"
                                    and out_dtype != "float32"):
        raise ValueError(f"unsupported out_dtype {out_dtype!r} at mat_dtype "
                         f"{mat_dtype!r}")
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
    check_types(args, _types(mat_dtype, out_dtype),
                f"mat_dtype={mat_dtype}, out_dtype={out_dtype}")


def gather_linear_forward_ref(xa, xb, idx, wa, wb, b, *, p: int,
                              act: str = "relu", mean: bool = False,
                              mat_dtype: str = "float32",
                              out_dtype: str = "float32") -> torch.Tensor:
    """Plain PyTorch version of the forward (any device), differentiable
    (at bf16 as the backward kernel rounds: ops/bf16_ref.py)."""
    _check(dict(xa=xa, xb=xb, idx=idx, wa=wa, wb=wb, b=b), p, act, mat_dtype,
           out_dtype)
    if mat_dtype == "float32":
        return k_act(act, pack_gather_sum(xa, idx, p, mean) @ wa + xb @ wb
                     + b)
    t1 = bf16_gather(xa, *bf16_onehot(idx, p, xa.shape[0], mean,
                                      dtype=wa.dtype))
    pre = bf16_mm(t1, wa) + bf16_mm(xb, wb) + b
    return k_act(act, pre).to(_DTYPES[out_dtype])


def gather_linear_backward_ref(xa, xb, idx, adj, wa, wb, b, out, g, *,
                               p: int, act: str = "relu", mean: bool = False,
                               mat_dtype: str = "float32",
                               out_dtype: str = "float32"):
    """Plain version of the backward: (dxa, dxb, dwa, dwb, db) by autograd
    through :func:`gather_linear_forward_ref`; ``adj`` and ``out`` are only
    checked (autograd transposes the gather itself)."""
    kw = dict(mat_dtype=mat_dtype, out_dtype=out_dtype)
    _check(dict(xa=xa, xb=xb, idx=idx, adj=adj, wa=wa, wb=wb, b=b, out=out,
                g=g), p, act, **kw)
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (xa, xb, wa, wb, b)]
        y = gather_linear_forward_ref(ins[0], ins[1], idx, *ins[2:], p=p,
                                      act=act, mean=mean, **kw)
        grads = torch.autograd.grad(y, ins, g)
    return tuple(grads)


def glin_tiles(rows: int, FA: int, FB: int, H: int, backward: bool,
               sms: int) -> tuple[int, int]:
    """(tile rows, blocks per SM) of a launch over ``rows`` rows: the conv
    grid's rule (ops.fused_conv.conv_bm, conv_blocks_per_sm) over the
    widest product, H forward and the widest of FA, FB and H backward."""
    N = max(FA, FB, H) if backward else H
    bm = conv_bm(rows, N, sms)
    return bm, conv_blocks_per_sm(rows, N, bm, sms)


def _lib():
    return library("gather_linear", _SIGNATURES)


def glin_grid(p: int, R: int, FA: int, FB: int, H: int,
              mat_dtype: str = "float32", backward: bool = False):
    """(blocks, tile rows, blocks per SM, SMs) of a launch over p·R rows
    on the current card (the library's shape rule and occupancy query)."""
    lib = _lib()
    bm, per_sm, sms = I32(), I32(), I32()
    grid = lib.cgr_gather_linear_grid(p, R, FA, FB, H, mat_index(mat_dtype),
                                      int(backward), ctypes.byref(bm),
                                      ctypes.byref(per_sm), ctypes.byref(sms))
    raise_on(lib, -grid if grid < 0 else 0, "cgr_gather_linear_grid")
    return grid, bm.value, per_sm.value, sms.value


def _scratch(lib, backward: bool, dims: list, mat: int, dev, S: int = 0,
             GP: int = 0, chunks: int = 1) -> torch.Tensor:
    """One allocation of the bytes the library asks for a direction."""
    p, R, _, FA, FB, H = dims[:6]
    n = (lib.cgr_gather_linear_bwd_scratch_bytes(p, R, FA, FB, H, S, mat)
         if backward else
         lib.cgr_gather_linear_fwd_scratch_bytes(p, R, FA, FB, H, GP, chunks,
                                                 mat))
    return torch.empty(n, device=dev, dtype=torch.uint8)


def _dims(xa, xb, idx, wa, p: int) -> list[int]:
    return [p, xb.shape[0] // p, xa.shape[0] // p, xa.shape[1], xb.shape[1],
            wa.shape[1], idx.shape[1]]


def _modes(act: str, mean: bool, mat_dtype: str, out_dtype: str) -> list:
    return [KERNEL_ACTS.index(act), int(mean), mat_index(mat_dtype),
            int(out_dtype == "bfloat16")]


def _launch_fwd(xa, xb, idx, wa, wb, b, p, act, mean, mat_dtype,
                out_dtype) -> torch.Tensor:
    args = dict(xa=xa, xb=xb, idx=idx, wa=wa, wb=wb, b=b)
    _check(args, p, act, mat_dtype, out_dtype)
    check_cuda(args, xa.device, _INDEX_NAMES, _types(mat_dtype, out_dtype))
    rows, H = xb.shape[0], wa.shape[1]
    dev = xa.device
    out = torch.empty((rows, H), device=dev, dtype=_DTYPES[out_dtype])
    lib = _lib()
    dims = _dims(xa, xb, idx, wa, p)
    with torch.cuda.device(dev):
        scratch = _scratch(lib, False, dims, mat_index(mat_dtype), dev)
        err = lib.cgr_gather_linear_fwd(
            *(t.data_ptr() for t in (xa, xb, idx, wa, wb, b, scratch, out)),
            *dims, *_modes(act, mean, mat_dtype, out_dtype), stream(dev))
    raise_on(lib, err, "gather_linear_fwd")
    return out


def gather_linear_forward(xa, xb, idx, wa, wb, b, *, p: int,
                          act: str = "relu", mean: bool = False,
                          mat_dtype: str = "float32",
                          out_dtype: str = "float32") -> torch.Tensor:
    """The forward -> out [p*R, H] at ``out_dtype``.  CUDA tensors launch
    ``csrc/gather_linear.cu`` (its ``mat_dtype`` instantiation) or raise;
    CPU tensors take :func:`gather_linear_forward_ref`.  Indices int32, all
    contiguous.  No backward: call :func:`gather_linear` for one."""
    kw = dict(p=p, act=act, mean=mean, mat_dtype=mat_dtype,
              out_dtype=out_dtype)
    if xa.device.type == "cpu":
        return gather_linear_forward_ref(xa, xb, idx, wa, wb, b, **kw)
    if xa.device.type != "cuda":
        raise ValueError(f"unsupported device {xa.device}")
    refuse_grad((xa, xb, wa, wb, b), "gather_linear", "gather_linear()")
    out = _launch_fwd(xa, xb, idx, wa, wb, b, **kw)
    count_launch(globals(), mat_dtype, False)
    return out


def _launch_bwd(xa, xb, idx, adj, wa, wb, b, out, g, p, act, mean,
                mat_dtype, out_dtype, needs):
    args = dict(xa=xa, xb=xb, idx=idx, adj=adj, wa=wa, wb=wb, b=b, out=out,
                g=g)
    _check(args, p, act, mat_dtype, out_dtype)
    check_cuda(args, xa.device, _INDEX_NAMES, _types(mat_dtype, out_dtype))
    dev = xa.device
    grads = [torch.empty_like(t) if need else None
             for t, need in zip((xa, xb, wa, wb, b), needs)]
    S = split_k(xb.shape[0])
    lib = _lib()
    dims, mat = _dims(xa, xb, idx, wa, p), mat_index(mat_dtype)
    with torch.cuda.device(dev):
        scratch = _scratch(lib, True, dims, mat, dev, S)
        err = lib.cgr_gather_linear_bwd(
            *(t.data_ptr() for t in (xa, xb, idx, adj, wa, wb, b, out, g)),
            *(ptr(t) for t in grads), scratch.data_ptr(), *dims,
            adj.shape[1], KERNEL_ACTS.index(act), int(mean), S, mat,
            int(out_dtype == "bfloat16"), stream(dev))
    raise_on(lib, err, "gather_linear_bwd")
    return tuple(grads)


def gather_linear_backward(xa, xb, idx, adj, wa, wb, b, out, g, *, p: int,
                           act: str = "relu", mean: bool = False,
                           mat_dtype: str = "float32",
                           out_dtype: str = "float32", needs=(True,) * 5):
    """(dxa, dxb, dwa, dwb, db) from the cotangent ``g`` of ``out``; an
    entry whose ``needs`` flag is False is None (and not computed on the
    card).  CUDA tensors launch ``csrc/gather_linear.cu`` or raise; CPU
    tensors take :func:`gather_linear_backward_ref`."""
    kw = dict(p=p, act=act, mean=mean, mat_dtype=mat_dtype,
              out_dtype=out_dtype)
    if xa.device.type == "cpu":
        grads = gather_linear_backward_ref(xa, xb, idx, adj, wa, wb, b, out,
                                           g, **kw)
        return tuple(d if need else None for d, need in zip(grads, needs))
    grads = _launch_bwd(xa, xb, idx, adj, wa, wb, b, out, g, **kw,
                        needs=needs)
    count_launch(globals(), mat_dtype, True)
    return grads


class _GatherLinear(torch.autograd.Function):
    """Forward: the forward kernel.  Backward: the backward kernel, which
    recomputes the gathered operand from the saved inputs."""

    @staticmethod
    def forward(ctx, kw, idx, adj, xa, xb, wa, wb, b):
        out = _launch_fwd(xa, xb, idx, wa, wb, b, **kw)
        count_launch(globals(), kw["mat_dtype"], False)
        ctx.kw = kw
        ctx.save_for_backward(idx, adj, xa, xb, wa, wb, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        idx, adj, xa, xb, wa, wb, b, out = ctx.saved_tensors
        grads = _launch_bwd(xa, xb, idx, adj, wa, wb, b, out, g.contiguous(),
                            needs=ctx.needs_input_grad[3:], **ctx.kw)
        count_launch(globals(), ctx.kw["mat_dtype"], True)
        return (None, None, None) + grads


def gather_linear(xa, xb, idx, adj, wa, wb, b, *, p: int, act: str = "relu",
                  mean: bool = False, mat_dtype: str = "float32",
                  out_dtype: str = "float32") -> torch.Tensor:
    """The forward, differentiable in xa, xb, wa, wb and b: on the card the
    forward kernel with the backward kernel as its backward, on the CPU
    :func:`gather_linear_forward_ref` under autograd."""
    kw = dict(p=p, act=act, mean=mean, mat_dtype=mat_dtype,
              out_dtype=out_dtype)
    if xa.device.type == "cpu":
        return gather_linear_forward_ref(xa, xb, idx, wa, wb, b, **kw)
    return _GatherLinear.apply(kw, idx, adj, xa, xb, wa, wb, b)


# -- the edge-partitioned readout (K10 / K11) ---------------------------------

_R_INDEX_NAMES = {"idx", "adj", "node_group", "pool_ell"}
# entries of pool_ell that one partial of K11's split pool sums
# (kPoolChunk in csrc/gather_linear.cu, which refuses another count)
POOL_CHUNK = 32


def pool_chunks(DN: int) -> int:
    """The chunks K11's forward splits each group's ``pool_ell`` row of
    ``DN`` entries into (a function of DN alone, so reruns sum in the same
    order): ceil(DN / POOL_CHUNK), at least 1."""
    return max(1, -(-DN // POOL_CHUNK))


def _check_r(args: dict, p: int, act: str, mat_dtype: str) -> None:
    if act not in KERNEL_ACTS:
        raise ValueError(f"unsupported kernel activation {act!r}")
    mat_index(mat_dtype)
    xa, xb, idx, wa = args["xa"], args["xb"], args["idx"], args["wa"]
    if p < 1 or xa.shape[0] % p or xb.shape[0] % p:
        raise ValueError(f"rows of xa {tuple(xa.shape)} and xb "
                         f"{tuple(xb.shape)} must split into p={p} packs")
    rows, FA, H = xb.shape[0], wa.shape[0], wa.shape[1]

    def width(name):
        t = args.get(name)
        return t.shape[1] if t is not None and t.dim() == 2 else -1

    GP = args["pool_ell"].shape[0] if args.get("pool_ell") is not None else 0
    want = dict(xa=(xa.shape[0], FA), xr=(rows, FA),
                xb=(rows, args["wb"].shape[0]), idx=(rows, width("idx")),
                adj=(xa.shape[0], width("adj")), node_group=(rows,),
                pool_ell=(GP, width("pool_ell")), wa=(FA, H),
                wb=(args["wb"].shape[0], H), b=(H,), out=(rows, H),
                g=(rows, H), gpool=(GP, H))
    if GP % p:
        raise ValueError(f"pool_ell's {GP} rows must split into p={p} packs")
    for name, tsr in args.items():
        if tsr is not None and tuple(tsr.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(tsr.shape)}, "
                             f"expected {want[name]}")
    check_types({k: v for k, v in args.items() if v is not None},
                _types(mat_dtype, "float32"),
                f"the edge-partitioned readout at mat_dtype={mat_dtype}")


def gather_linear_r_forward_ref(xa, xr, xb, idx, wa, wb, b, *, p: int,
                                act: str = "relu", mean: bool = False,
                                mat_dtype: str = "float32") -> torch.Tensor:
    """Plain PyTorch version of K10 (any device), differentiable (at bf16
    through ops/bf16_ref.py, xr added unrounded)."""
    _check_r(dict(xa=xa, xr=xr, xb=xb, idx=idx, wa=wa, wb=wb, b=b), p, act,
             mat_dtype)
    if mat_dtype == "float32":
        return k_act(act, (pack_gather_sum(xa, idx, p, mean) + xr) @ wa
                     + xb @ wb + b)
    t1 = bf16_gather(xa, *bf16_onehot(idx, p, xa.shape[0], mean,
                                      dtype=wa.dtype)) + xr.to(wa.dtype)
    return k_act(act, bf16_mm(t1, wa) + bf16_mm(xb, wb) + b)


def gather_linear_pool_forward_ref(xa, xr, xb, idx, node_group, pool_ell, wa,
                                   wb, b, *, p: int, act: str = "relu",
                                   mean: bool = False,
                                   mat_dtype: str = "float32"):
    """Plain version of K11: (out, pool), the pool a sum of out's rows
    through ``pool_ell`` (entries outside the group's pack absent; at bf16
    of bf16(out), its cotangent rounded); ``node_group`` is only
    checked."""
    _check_r(dict(xa=xa, xr=xr, xb=xb, idx=idx, node_group=node_group,
                  pool_ell=pool_ell, wa=wa, wb=wb, b=b), p, act, mat_dtype)
    out = gather_linear_r_forward_ref(xa, xr, xb, idx, wa, wb, b, p=p,
                                      act=act, mean=mean, mat_dtype=mat_dtype)
    if mat_dtype == "bfloat16":
        return out, bf16_gather(out, *bf16_onehot(pool_ell, p, out.shape[0],
                                                  False, dtype=out.dtype))
    ids = in_pack(pool_ell, p, out.shape[0])[0]
    return out, ext_zero_row(out)[ids].sum(dim=1)


def gather_linear_r_backward_ref(xa, xr, xb, idx, adj, wa, wb, b, out, g, *,
                                 p: int, act: str = "relu",
                                 mean: bool = False,
                                 mat_dtype: str = "float32"):
    """(dxa, dxr, dxb, dwa, dwb, db) by autograd through
    :func:`gather_linear_r_forward_ref`; ``adj`` and ``out`` are only
    checked."""
    _check_r(dict(xa=xa, xr=xr, xb=xb, idx=idx, adj=adj, wa=wa, wb=wb, b=b,
                  out=out, g=g), p, act, mat_dtype)
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (xa, xr, xb, wa, wb, b)]
        y = gather_linear_r_forward_ref(ins[0], ins[1], ins[2], idx,
                                        *ins[3:], p=p, act=act, mean=mean,
                                        mat_dtype=mat_dtype)
        return tuple(torch.autograd.grad(y, ins, g))


def gather_linear_pool_backward_ref(xa, xr, xb, idx, adj, node_group,
                                    pool_ell, wa, wb, b, out, g, gpool, *,
                                    p: int, act: str = "relu",
                                    mean: bool = False,
                                    mat_dtype: str = "float32"):
    """K11's (dxa, dxr, dxb, dwa, dwb, db) from the cotangents of out and
    pool, by autograd through :func:`gather_linear_pool_forward_ref`."""
    _check_r(dict(xa=xa, xr=xr, xb=xb, idx=idx, adj=adj,
                  node_group=node_group, pool_ell=pool_ell, wa=wa, wb=wb,
                  b=b, out=out, g=g, gpool=gpool), p, act, mat_dtype)
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (xa, xr, xb, wa, wb, b)]
        y = gather_linear_pool_forward_ref(ins[0], ins[1], ins[2], idx,
                                           node_group, pool_ell, *ins[3:],
                                           p=p, act=act, mean=mean,
                                           mat_dtype=mat_dtype)
        return tuple(torch.autograd.grad(y, ins, (g, gpool)))


def _count_r(pool: bool, mat_dtype: str, backward: bool) -> None:
    count_launch(globals(), mat_dtype, backward, "pool_" if pool else "r_")


def _launch_r_fwd(xa, xr, xb, idx, wa, wb, b, p, act, mean, mat_dtype,
                  node_group=None, pool_ell=None):
    args = dict(xa=xa, xr=xr, xb=xb, idx=idx, node_group=node_group,
                pool_ell=pool_ell, wa=wa, wb=wb, b=b)
    _check_r(args, p, act, mat_dtype)
    dev = xa.device
    check_cuda({k: v for k, v in args.items() if v is not None}, dev,
               _R_INDEX_NAMES, _types(mat_dtype, "float32"))
    rows, H = xb.shape[0], wa.shape[1]
    out = torch.empty((rows, H), device=dev)
    GP = 0 if pool_ell is None else pool_ell.shape[0] // p
    DN = 0 if pool_ell is None else pool_ell.shape[1]
    pool = None if pool_ell is None else torch.empty((p * GP, H), device=dev)
    chunks = pool_chunks(DN)
    lib = _lib()
    dims, mat = _dims(xa, xb, idx, wa, p), mat_index(mat_dtype)
    with torch.cuda.device(dev):
        scratch = _scratch(lib, False, dims, mat, dev, GP=GP, chunks=chunks)
        err = lib.cgr_gather_linear_r_fwd(
            *(ptr(t) for t in (xa, xr, xb, idx, pool_ell, wa, wb, b, scratch,
                               out, pool)),
            *dims, GP, DN, chunks, KERNEL_ACTS.index(act), int(mean), mat,
            stream(dev))
    raise_on(lib, err, "gather_linear_r_fwd")
    return out, pool


def _launch_r_bwd(xa, xr, xb, idx, adj, wa, wb, b, out, g, p, act, mean,
                  mat_dtype, needs, node_group=None, pool_ell=None,
                  gpool=None):
    args = dict(xa=xa, xr=xr, xb=xb, idx=idx, adj=adj, node_group=node_group,
                pool_ell=pool_ell, wa=wa, wb=wb, b=b, out=out, g=g,
                gpool=gpool)
    _check_r(args, p, act, mat_dtype)
    dev = xa.device
    check_cuda({k: v for k, v in args.items() if v is not None}, dev,
               _R_INDEX_NAMES, _types(mat_dtype, "float32"))
    grads = [torch.empty_like(t) if need else None
             for t, need in zip((xa, xr, xb, wa, wb, b), needs)]
    S = split_k(xb.shape[0])
    GP = 0 if gpool is None else gpool.shape[0] // p
    lib = _lib()
    dims, mat = _dims(xa, xb, idx, wa, p), mat_index(mat_dtype)
    with torch.cuda.device(dev):
        scratch = _scratch(lib, True, dims, mat, dev, S)
        err = lib.cgr_gather_linear_r_bwd(
            *(ptr(t) for t in (xa, xr, xb, idx, adj, node_group, wa, wb, b,
                               out, g, gpool)),
            *(ptr(t) for t in grads), scratch.data_ptr(), *dims,
            adj.shape[1], GP, KERNEL_ACTS.index(act), int(mean), S, mat,
            stream(dev))
    raise_on(lib, err, "gather_linear_r_bwd")
    return tuple(grads)


def _cpu_or_cuda(xa) -> bool:
    """True for CPU tensors (the plain version); raises off CPU and CUDA."""
    if xa.device.type == "cpu":
        return True
    if xa.device.type != "cuda":
        raise ValueError(f"unsupported device {xa.device}")
    return False


def gather_linear_r_forward(xa, xr, xb, idx, wa, wb, b, *, p: int,
                            act: str = "relu", mean: bool = False,
                            mat_dtype: str = "float32") -> torch.Tensor:
    """K10's forward -> out [p*R, H] f32.  CUDA tensors launch
    ``csrc/gather_linear.cu`` (its ``mat_dtype`` instantiation) or raise;
    CPU tensors take :func:`gather_linear_r_forward_ref`."""
    kw = dict(p=p, act=act, mean=mean, mat_dtype=mat_dtype)
    if _cpu_or_cuda(xa):
        return gather_linear_r_forward_ref(xa, xr, xb, idx, wa, wb, b, **kw)
    refuse_grad((xa, xr, xb, wa, wb, b), "gather_linear_r",
                "gather_linear_r()")
    out, _ = _launch_r_fwd(xa, xr, xb, idx, wa, wb, b, **kw)
    _count_r(False, mat_dtype, False)
    return out


def gather_linear_pool_forward(xa, xr, xb, idx, node_group, pool_ell, wa, wb,
                               b, *, p: int, act: str = "relu",
                               mean: bool = False,
                               mat_dtype: str = "float32"):
    """K11's forward -> (out [p*R, H], pool [p*GP, H]), f32.  CUDA tensors
    launch ``csrc/gather_linear.cu`` or raise; CPU tensors take
    :func:`gather_linear_pool_forward_ref`."""
    kw = dict(p=p, act=act, mean=mean, mat_dtype=mat_dtype)
    if _cpu_or_cuda(xa):
        return gather_linear_pool_forward_ref(xa, xr, xb, idx, node_group,
                                              pool_ell, wa, wb, b, **kw)
    refuse_grad((xa, xr, xb, wa, wb, b), "gather_linear_pool",
                "gather_linear_pool()")
    res = _launch_r_fwd(xa, xr, xb, idx, wa, wb, b, **kw,
                        node_group=node_group, pool_ell=pool_ell)
    _count_r(True, mat_dtype, False)
    return res


def gather_linear_r_backward(xa, xr, xb, idx, adj, wa, wb, b, out, g, *,
                             p: int, act: str = "relu", mean: bool = False,
                             mat_dtype: str = "float32", needs=(True,) * 6):
    """K10's (dxa, dxr, dxb, dwa, dwb, db) from the cotangent ``g`` of
    ``out``; an entry whose ``needs`` flag is False is None."""
    kw = dict(p=p, act=act, mean=mean, mat_dtype=mat_dtype)
    if _cpu_or_cuda(xa):
        grads = gather_linear_r_backward_ref(xa, xr, xb, idx, adj, wa, wb, b,
                                             out, g, **kw)
        return tuple(d if need else None for d, need in zip(grads, needs))
    grads = _launch_r_bwd(xa, xr, xb, idx, adj, wa, wb, b, out, g, **kw,
                          needs=needs)
    _count_r(False, mat_dtype, True)
    return grads


def gather_linear_pool_backward(xa, xr, xb, idx, adj, node_group, pool_ell,
                                wa, wb, b, out, g, gpool, *, p: int,
                                act: str = "relu", mean: bool = False,
                                mat_dtype: str = "float32",
                                needs=(True,) * 6):
    """K11's (dxa, dxr, dxb, dwa, dwb, db) from the cotangents ``g`` of
    ``out`` and ``gpool`` of the pool."""
    kw = dict(p=p, act=act, mean=mean, mat_dtype=mat_dtype)
    if _cpu_or_cuda(xa):
        grads = gather_linear_pool_backward_ref(
            xa, xr, xb, idx, adj, node_group, pool_ell, wa, wb, b, out, g,
            gpool, **kw)
        return tuple(d if need else None for d, need in zip(grads, needs))
    grads = _launch_r_bwd(xa, xr, xb, idx, adj, wa, wb, b, out, g, **kw,
                          needs=needs, node_group=node_group,
                          pool_ell=pool_ell, gpool=gpool)
    _count_r(True, mat_dtype, True)
    return grads


class _GatherLinearR(torch.autograd.Function):
    """Forward: K10 (K11 with the pool tables).  Backward: its backward
    kernel, which recomputes the gathered operand."""

    @staticmethod
    def forward(ctx, kw, idx, adj, node_group, pool_ell, xa, xr, xb, wa, wb,
                b):
        out, pool = _launch_r_fwd(xa, xr, xb, idx, wa, wb, b, **kw,
                                  node_group=node_group, pool_ell=pool_ell)
        ctx.kw, ctx.pooled = kw, pool is not None
        _count_r(ctx.pooled, kw["mat_dtype"], False)
        ctx.save_for_backward(idx, adj, node_group, pool_ell, xa, xr, xb, wa,
                              wb, b, out)
        return (out, pool) if ctx.pooled else out

    @staticmethod
    def backward(ctx, g, gpool=None):
        (idx, adj, node_group, pool_ell, xa, xr, xb, wa, wb, b,
         out) = ctx.saved_tensors
        pool_kw = (dict(node_group=node_group, pool_ell=pool_ell,
                        gpool=gpool.contiguous()) if ctx.pooled else {})
        grads = _launch_r_bwd(xa, xr, xb, idx, adj, wa, wb, b, out,
                              g.contiguous(), **ctx.kw,
                              needs=ctx.needs_input_grad[5:], **pool_kw)
        _count_r(ctx.pooled, ctx.kw["mat_dtype"], True)
        return (None,) * 5 + grads


def gather_linear_r(xa, xr, xb, idx, adj, wa, wb, b, *, p: int,
                    act: str = "relu", mean: bool = False,
                    mat_dtype: str = "float32") -> torch.Tensor:
    """K10, differentiable in xa, xr, xb, wa, wb and b: on the card the
    forward kernel with the backward kernel as its backward, on the CPU
    :func:`gather_linear_r_forward_ref` under autograd."""
    kw = dict(p=p, act=act, mean=mean, mat_dtype=mat_dtype)
    if _cpu_or_cuda(xa):
        return gather_linear_r_forward_ref(xa, xr, xb, idx, wa, wb, b, **kw)
    return _GatherLinearR.apply(kw, idx, adj, None, None, xa, xr, xb, wa, wb,
                                b)


def gather_linear_pool(xa, xr, xb, idx, adj, node_group, pool_ell, wa, wb, b,
                       *, p: int, act: str = "relu", mean: bool = False,
                       mat_dtype: str = "float32"):
    """K11 -> (out, pool), differentiable in xa, xr, xb, wa, wb and b: on
    the card the forward kernel with the backward kernel as its backward,
    on the CPU :func:`gather_linear_pool_forward_ref` under autograd."""
    kw = dict(p=p, act=act, mean=mean, mat_dtype=mat_dtype)
    if _cpu_or_cuda(xa):
        return gather_linear_pool_forward_ref(xa, xr, xb, idx, node_group,
                                              pool_ell, wa, wb, b, **kw)
    return _GatherLinearR.apply(kw, idx, adj, node_group, pool_ell, xa, xr,
                                xb, wa, wb, b)
