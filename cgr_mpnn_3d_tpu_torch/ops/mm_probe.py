"""The matmul rate probe's kernel (P2): its wrapper and plain version.

The counterpart of ``tools/int8_microbench.py::pallas_mm`` (the Pallas body
``_pk``): ``C = A · B`` with

    bfloat16   bf16 operands, f32 sums, C rounded to bf16;
    int8       int8 operands, int32 sums, C the low 8 bits of each sum
               (XLA's ``astype(int8)`` of an int32 wraps).

:func:`mm_probe` launches ``csrc/mm_probe.cu`` (``mma.sync`` on the tensor
cores, 128 x 128 tiles) for CUDA tensors or raises, and takes
:func:`mm_probe_ref` only for CPU tensors.  The kernel takes row-major
``A [M, K]`` and ``B [K, N]`` with M and N multiples of 128 and K of 64.
"""

from __future__ import annotations

import torch

from ._launch import I32, PTR, library, raise_on, stream

__all__ = ["mm_probe", "mm_probe_ref", "launches"]

# kernel launches by the wrapper (nothing else adds here)
launches = 0

_SIGNATURES = {"cgr_mm_probe": ([PTR, PTR, PTR, I32, I32, I32, I32, PTR],
                                I32)}
_DTYPES = (torch.bfloat16, torch.int8)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"mm_probe takes two bfloat16 or two int8 matrices, "
                        f"got {a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} and {tuple(b.shape)} do "
                         f"not multiply")


def mm_probe_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (any device).  bf16: the f32 product rounded
    to bf16.  int8: the product in float64, exact while |sum| <= 127² · K
    < 2**53, then its low 8 bits as int8."""
    _check(a, b)
    if a.dtype == torch.bfloat16:
        return (a.float() @ b.float()).bfloat16()
    acc = (a.double() @ b.double()).to(torch.int64)
    return (torch.remainder(acc + 128, 256) - 128).to(torch.int8)


def mm_probe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``A · B`` as the TPU probe computes it, in ``a``'s type.  CUDA
    tensors launch ``csrc/mm_probe.cu`` or raise; CPU tensors take
    :func:`mm_probe_ref`."""
    global launches
    if a.device.type == "cpu":
        return mm_probe_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    _check(a, b)
    (M, K), N = a.shape, b.shape[1]
    if b.device != a.device:
        raise ValueError(f"b is on {b.device}, expected {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("mm_probe takes contiguous row-major matrices")
    if M % 128 or N % 128 or K % 64:
        raise ValueError(f"mm_probe's tiles need M and N multiples of 128 "
                         f"and K of 64, got M={M}, N={N}, K={K}")
    c = torch.empty((M, N), device=a.device, dtype=a.dtype)
    lib = library("mm_probe", _SIGNATURES)
    with torch.cuda.device(a.device):
        err = lib.cgr_mm_probe(a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N,
                               K, int(a.dtype == torch.int8),
                               stream(a.device))
    raise_on(lib, err, "mm_probe")
    launches += 1
    return c
