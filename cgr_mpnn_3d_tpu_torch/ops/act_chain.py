"""The activation-chain probe's kernel (P1): its wrapper and plain version.

The counterpart of the Pallas kernel in ``tools/gelu_roofline.py::main``
(``pallas_chain``): one launch applies ``y = fn(0.5 * y) - 0.1`` ``k`` times
to every element of an f32 array, with ``fn`` one of :data:`FNS`:

    relu, silu, gelu      kernel_math.k_act
    gelu_bwd              kernel_math.k_dact("gelu", .)
    gelu_bwd_from_out     gelu(y) / y + y * pdf(y)   (0.5 + y * pdf(y) where
                          |y| <= 1e-6): the derivative from a stored output

:func:`act_chain` launches ``csrc/act_chain.cu``, whose ``fn`` are the
``__device__`` ``k_act``/``k_dact`` the model's kernels inline, for CUDA
tensors or raises, and takes :func:`act_chain_ref` only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ._launch import I32, PTR, check_cuda, library, raise_on, stream
from .kernel_math import k_act, k_dact

__all__ = ["FNS", "act_chain", "act_chain_ref", "launches"]

# fn ids shared with csrc/act_chain.cu
FNS = ("relu", "silu", "gelu", "gelu_bwd", "gelu_bwd_from_out")

# kernel launches by the wrapper (nothing else adds here)
launches = 0

_SIGNATURES = {"cgr_act_chain": ([PTR, PTR, ctypes.c_longlong, I32, I32, PTR],
                                 I32)}
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _fn(name: str, y: torch.Tensor) -> torch.Tensor:
    if name in ("relu", "silu", "gelu"):
        return k_act(name, y)
    if name == "gelu_bwd":
        return k_dact("gelu", y)
    if name == "gelu_bwd_from_out":
        cdf = torch.where(y.abs() > 1e-6, k_act("gelu", y) / y, 0.5)
        return cdf + y * _INV_SQRT_2PI * torch.exp(-y * y * 0.5)
    raise ValueError(f"unsupported chain function {name!r}")


def _check(fn: str, k: int) -> None:
    if fn not in FNS:
        raise ValueError(f"unsupported chain function {fn!r}")
    if k < 0:
        raise ValueError(f"chain length k={k} must be >= 0")


def act_chain_ref(x: torch.Tensor, fn: str, k: int) -> torch.Tensor:
    """Plain PyTorch version (any device): ``k`` applications of
    ``y = fn(0.5 * y) - 0.1``."""
    _check(fn, k)
    y = x
    for _ in range(k):
        y = _fn(fn, y * 0.5) - 0.1
    return y


def act_chain(x: torch.Tensor, fn: str, k: int) -> torch.Tensor:
    """The chain -> an f32 tensor of ``x``'s shape.  CUDA tensors launch
    ``csrc/act_chain.cu`` or raise; CPU tensors take
    :func:`act_chain_ref`."""
    global launches
    if x.device.type == "cpu":
        return act_chain_ref(x, fn, k)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(fn, k)
    check_cuda(dict(x=x), x.device, ())
    y = torch.empty_like(x)
    lib = library("act_chain", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.cgr_act_chain(x.data_ptr(), y.data_ptr(), x.numel(),
                                FNS.index(fn), k, stream(x.device))
    raise_on(lib, err, "act_chain")
    launches += 1
    return y
