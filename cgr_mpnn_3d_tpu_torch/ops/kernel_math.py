"""Elementwise helpers of the kernels, in plain PyTorch.

The counterparts of ``k_act`` and ``mean_colscale`` in
``cgr_mpnn_3d_tpu/ops/pallas_fused.py``.  ``csrc/fused_model_fwd.cu`` has
``__device__`` twins of both.  GELU is the exact erf form (``torch.erf``
here, ``erff`` in CUDA); the JAX kernels build erf from the
Abramowitz-Stegun approximation, which differs by about f32 epsilon.
"""

from __future__ import annotations

import math

import torch

__all__ = ["KERNEL_ACTS", "k_act", "mean_colscale"]

# activation ids shared with the CUDA kernel (the ``act`` argument)
KERNEL_ACTS = ("relu", "silu", "gelu")

_SQRT_HALF = 1.0 / math.sqrt(2.0)


def k_act(name: str, pre: torch.Tensor) -> torch.Tensor:
    """Activation on the f32 pre-activation: relu, silu (x * sigmoid(x)) or
    exact-erf gelu."""
    if name == "relu":
        return torch.clamp_min(pre, 0.0)
    if name == "silu":
        return pre * torch.sigmoid(pre)
    if name == "gelu":
        return 0.5 * pre * (1.0 + torch.erf(pre * _SQRT_HALF))
    raise ValueError(f"unsupported kernel activation {name!r}")


def mean_colscale(valid: torch.Tensor) -> torch.Tensor:
    """Per-row 1/degree scale for aggr or pooling 'mean': ``valid`` [R, D]
    marks the ELL entries that count (in-pack, not the sentinel).  A row
    with no entries divides by 1 -- its sum is zero anyway.  In the TPU
    kernel this is the column sum of the one-hot matrix."""
    deg = valid.sum(dim=1, dtype=torch.float32)
    return 1.0 / torch.clamp_min(deg, 1.0)
