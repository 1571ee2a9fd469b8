"""Elementwise helpers of the kernels, in plain PyTorch.

The counterparts of ``k_act``, ``k_dact``, ``mean_colscale``, ``_hash_bits``,
``k_dropout_mask`` and ``hash_dropout_keep_full`` in
``cgr_mpnn_3d_tpu/ops/pallas_fused.py``, and the rounding of a product's
operands to ``mat_dtype`` (``x.astype(md)`` in the kernels).
``csrc/fused_model_common.cuh`` has ``__device__`` twins of all of them.  GELU is the exact erf form
(``torch.erf`` here, ``erff`` in CUDA); the JAX kernels build erf from the
Abramowitz-Stegun approximation, which differs by about f32 epsilon.

Hash dropout: the keep bits of element (row, col) of pack ``pack`` are a
murmur3 finalizer over ``row*65537 + col + seed*0x9E3779B9 +
pack*0x85EBCA6B`` in uint32 arithmetic, with ``row`` the pack-local edge
row; an element is kept where ``bits >= min(int(rate * 2**32), 2**32 - 1)``
and then scaled by the f32 constant ``1 / (1 - rate)``.  The bits here are
computed in int64 and masked to 32 bits after every product, so they equal
the TPU kernels' and the CUDA kernels' bit for bit.
"""

from __future__ import annotations

import math

import torch

__all__ = ["KERNEL_ACTS", "CONV_ACTS", "MAT_DTYPES", "round_bf16", "k_act", "k_dact", "mean_colscale",
           "dropout_threshold", "hash_bits", "k_dropout_mask",
           "hash_dropout_keep_full"]

# activation ids shared with the CUDA kernels (the ``act`` argument)
KERNEL_ACTS = ("relu", "silu", "gelu")
# ... and the per-layer conv kernel's (K6), which also takes "linear" (the
# identity: the EP overlap path's pre-activations, JAX k_act :120)
CONV_ACTS = KERNEL_ACTS + ("linear",)
# operand types of the whole-model kernels' products (the ``mat_dtype`` int
# of the CUDA kernels is the index here)
MAT_DTYPES = ("float32", "bfloat16")

_SQRT_HALF = 1.0 / math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
_M32 = 0xFFFFFFFF


def k_act(name: str, pre: torch.Tensor) -> torch.Tensor:
    """Activation on the f32 pre-activation: relu, silu (x * sigmoid(x)),
    exact-erf gelu or linear (the identity).  ReLU's gradient at 0 is 0, as
    in JAX."""
    if name == "linear":
        return pre
    if name == "relu":
        return torch.relu(pre)
    if name == "silu":
        return pre * torch.sigmoid(pre)
    if name == "gelu":
        return 0.5 * pre * (1.0 + torch.erf(pre * _SQRT_HALF))
    raise ValueError(f"unsupported kernel activation {name!r}")


def k_dact(name: str, pre: torch.Tensor) -> torch.Tensor:
    """d act(pre) / d pre, as the backward kernels compute it."""
    if name == "linear":
        return torch.ones_like(pre)
    if name == "relu":
        return (pre > 0.0).to(torch.float32)
    if name == "silu":
        s = torch.sigmoid(pre)
        return s * (1.0 + pre * (1.0 - s))
    if name == "gelu":
        cdf = 0.5 * (1.0 + torch.erf(pre * _SQRT_HALF))
        return cdf + pre * (_INV_SQRT_2PI * torch.exp(-0.5 * pre * pre))
    raise ValueError(f"unsupported kernel activation {name!r}")


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (round to nearest even) and back to its
    own type: what ``x.astype(jnp.bfloat16)`` gives an operand of a
    kernel's product."""
    return t.to(torch.bfloat16).to(t.dtype)


def mean_colscale(valid: torch.Tensor,
                  mat_dtype: str = "float32") -> torch.Tensor:
    """Per-row 1/degree scale for aggr or pooling 'mean': ``valid`` [R, D]
    marks the ELL entries that count (in-pack, not the sentinel).  A row
    with no entries divides by 1 -- its sum is zero anyway.  In the TPU
    kernel this is the column sum of the one-hot matrix, and the scale is
    an entry of that matrix: with ``mat_dtype="bfloat16"`` it is
    ``bf16(1/deg)``, not the f32 ``1/deg``."""
    deg = valid.sum(dim=1, dtype=torch.float32)
    scale = 1.0 / torch.clamp_min(deg, 1.0)
    return round_bf16(scale) if mat_dtype == "bfloat16" else scale


def dropout_threshold(rate: float) -> int:
    """The uint32 keep threshold of a drop rate: keep where bits >= it."""
    return min(int(rate * 2**32), 2**32 - 1)


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2**32 for int64 ``a`` in [0, 2**32) and a uint32
    constant ``b``, without overflowing int64: split ``b`` in 16-bit
    halves."""
    lo = (a * (b & 0xFFFF)) & _M32
    hi = (a * (b >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def hash_bits(row: torch.Tensor, col: torch.Tensor, seed,
              pack) -> torch.Tensor:
    """The dropout bits (uint32 values in an int64 tensor) of elements
    (row, col) under ``seed`` in pack ``pack``; the arguments broadcast.
    ``seed`` is an int32 reinterpreted as uint32, as in the TPU kernel."""
    row = torch.as_tensor(row, dtype=torch.int64)
    seed = torch.as_tensor(seed, dtype=torch.int64, device=row.device) & _M32
    pack = torch.as_tensor(pack, dtype=torch.int64, device=row.device)
    x = (_mul32(row, 65537) + torch.as_tensor(col, dtype=torch.int64)
         + _mul32(seed, 0x9E3779B9) + _mul32(pack, 0x85EBCA6B)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def k_dropout_mask(shape: tuple[int, int], seed, pack: int,
                   keep: float, device=None) -> torch.Tensor:
    """The keep mask (f32 0/1) of one pack's [rows, cols] tile."""
    rows = torch.arange(shape[0], device=device)[:, None]
    cols = torch.arange(shape[1], device=device)[None, :]
    thr = dropout_threshold(1.0 - keep)
    return (hash_bits(rows, cols, seed, pack) >= thr).to(torch.float32)


def hash_dropout_keep_full(pe: int, h: int, te: int, seed, rate: float,
                           device=None) -> torch.Tensor:
    """The per-pack keep mask over the stacked [pe, h] layout (pe = p*te):
    row ``r`` is pack-local row ``r % te`` of pack ``r // te``."""
    grow = torch.arange(pe, device=device)[:, None]
    cols = torch.arange(h, device=device)[None, :]
    bits = hash_bits(grow % te, cols, seed, grow // te)
    return bits >= dropout_threshold(rate)
