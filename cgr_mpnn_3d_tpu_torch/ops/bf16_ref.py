"""The bf16 products and one-hot gathers of the kernels' plain versions.

At ``mat_dtype=bf16`` a TPU kernel rounds every operand of a product and
of a one-hot gather-sum to bf16 where it enters, sums in f32, and its
backward rounds the incoming cotangent the same way before its own
products.  Autograd through ``round_bf16`` would round the cotangent of
each operand instead, so the plain versions multiply and gather through the
``torch.autograd.Function``s here, whose backward rounds as the kernels'
backward does.  A bf16 operand's cotangent comes back as bf16 (the
``.astype(x.dtype)`` of every custom VJP of the JAX package).
"""

from __future__ import annotations

import torch

from .kernel_math import mean_colscale, round_bf16
from .segment import ext_zero_row, in_pack

__all__ = ["bf16_mm", "bf16_gather", "bf16_onehot"]


def _sum_dtype(*ts) -> torch.dtype:
    """f32 sums, or float64 ones for a float64 evaluation."""
    return (torch.float64 if any(t.dtype == torch.float64 for t in ts)
            else torch.float32)


class _Bf16MatMul(torch.autograd.Function):
    """a @ b with both operands rounded to bf16 and f32 (or float64) sums:
    ``_mm`` of the TPU kernels at ``mat_dtype=bf16``.  The backward rounds
    the incoming gradient too before its two products, as the TPU
    kernels' backward does (``_outerT``, ``_mmT``)."""

    @staticmethod
    def forward(ctx, a, b):
        dt = _sum_dtype(a, b)
        ctx.dtypes = a.dtype, b.dtype
        a, b = round_bf16(a).to(dt), round_bf16(b).to(dt)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_bf16(g)
        return ((g @ b.T).to(ctx.dtypes[0]) if ctx.needs_input_grad[0]
                else None,
                (a.T @ g).to(ctx.dtypes[1]) if ctx.needs_input_grad[1]
                else None)


class _Bf16Gather(torch.autograd.Function):
    """out[r] = Σ_d coef[r, d] · bf16(src)[ids[r, d]], ``ids`` holding the
    sentinel row (zero) for absent entries: a one-hot product of the TPU
    kernels at bf16 (``_BlockDiag.dot0``, ``onehot_spmm_t``), whose entries
    ``coef`` are bf16 values.  The backward is the transposed product
    (``_BlockDiag.mm``, ``spmm_t``'s backward) with the incoming gradient
    rounded to bf16, cast to the type of ``src``."""

    @staticmethod
    def forward(ctx, src, ids, coef):
        ctx.save_for_backward(ids, coef)
        ctx.rows, ctx.dtype = src.shape[0], src.dtype
        src = round_bf16(src).to(coef.dtype)
        return (coef[..., None] * ext_zero_row(src)[ids]).sum(1)

    @staticmethod
    def backward(ctx, g):
        ids, coef = ctx.saved_tensors
        part = coef[..., None] * round_bf16(g)[:, None, :]
        out = g.new_zeros((ctx.rows + 1, g.shape[1]))
        out.index_add_(0, ids.reshape(-1), part.reshape(-1, g.shape[1]))
        return out[:-1].to(ctx.dtype), None, None


def bf16_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16(a) @ bf16(b) with f32 sums, differentiable as the kernels'
    backward computes it."""
    return _Bf16MatMul.apply(a, b)


def bf16_gather(src: torch.Tensor, ids: torch.Tensor,
                coef: torch.Tensor) -> torch.Tensor:
    """The one-hot gather-sum of :func:`bf16_onehot`'s (ids, coef) at bf16,
    differentiable as the kernels' backward computes it."""
    return _Bf16Gather.apply(src, ids, coef)


def bf16_onehot(idx, p: int, n_src: int, mean: bool, rev=None, *, dtype):
    """(ids, coef) of one pack-local gather as the bf16 one-hot matrix of
    the TPU kernels (``pallas_model.py::_onehot``, ``_build_mt``) has it:
    each counted entry is ``bf16(1/deg)`` for mean, else 1; with ``rev``
    (the D-MPNN message's reverse row, or a K7 sign row) one more entry of
    -1 (exact, unscaled)."""
    ids, valid = in_pack(idx, p, n_src)
    scale = (mean_colscale(valid, "bfloat16") if mean
             else torch.ones(idx.shape[0], device=idx.device))
    coef = valid * scale[:, None]
    if rev is not None:
        rid, rvalid = in_pack(rev, p, n_src)
        ids = torch.cat([ids, rid[:, None]], dim=1)
        coef = torch.cat([coef, -rvalid[:, None].float()], dim=1)
    return ids, coef.to(dtype)
