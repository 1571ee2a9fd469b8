"""The matmul rate probe's kernel (P2): its wrapper and plain version.

The counterpart of ``tools/int8_microbench.py::pallas_mm`` (the Pallas body
``_pk``): ``C = A · B`` with

    bfloat16   bf16 operands, f32 sums, C rounded to bf16;
    int8       int8 operands, int32 sums, C the low 8 bits of each sum
               (XLA's ``astype(int8)`` of an int32 wraps).

:func:`mm_probe` launches ``csrc/mm_probe.cu`` (TMA loads into a ring of
shared-memory stages feeding ``wgmma`` on the tensor cores, 128 x 256
tiles; for int8 first the transpose of B, which ``wgmma`` wants K-major)
for CUDA tensors or raises, and takes :func:`mm_probe_ref` only for CPU
tensors.  The kernel takes row-major ``A [M, K]`` and ``B [K, N]`` with M
and N multiples of 128 and K of 64.  :func:`transpose_s8` is the int8
transpose alone, with its plain version :func:`transpose_s8_ref`.
"""

from __future__ import annotations

import torch

from ._launch import I32, PTR, library, ptr, raise_on, stream

__all__ = ["mm_probe", "mm_probe_ref", "transpose_s8", "transpose_s8_ref",
           "launches", "transpose_launches"]

# kernel launches by the wrappers (nothing else adds here): one per
# mm_probe call; the int8 transpose's, in mm_probe's int8 calls and alone
launches = 0
transpose_launches = 0

_SIGNATURES = {
    "cgr_mm_probe": ([PTR, PTR, PTR, PTR, I32, I32, I32, I32, PTR], I32),
    "cgr_mm_probe_transpose_s8": ([PTR, PTR, I32, I32, PTR], I32)}
_DTYPES = (torch.bfloat16, torch.int8)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"mm_probe takes two bfloat16 or two int8 matrices, "
                        f"got {a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} and {tuple(b.shape)} do "
                         f"not multiply")


def _check_cuda(what: str, *ts: torch.Tensor) -> None:
    """On one device, contiguous, 16-byte aligned (the TMA loads)."""
    for t in ts:
        if t.device != ts[0].device:
            raise ValueError(f"{what}: a tensor is on {t.device}, expected "
                             f"{ts[0].device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous row-major matrices")
        if t.data_ptr() % 16:
            raise ValueError(f"{what} takes 16-byte aligned matrices")


def mm_probe_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (any device).  bf16: the f32 product rounded
    to bf16.  int8: the product in float64, exact while |sum| <= 128² · K
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
    global launches, transpose_launches
    if a.device.type == "cpu":
        return mm_probe_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    _check(a, b)
    (M, K), N = a.shape, b.shape[1]
    _check_cuda("mm_probe", a, b)
    if M % 128 or N % 128 or K % 64:
        raise ValueError(f"mm_probe's tiles need M and N multiples of 128 "
                         f"and K of 64, got M={M}, N={N}, K={K}")
    int8 = a.dtype == torch.int8
    c = torch.empty((M, N), device=a.device, dtype=a.dtype)
    bt = torch.empty((N, K), device=a.device, dtype=a.dtype) if int8 \
        else None
    lib = library("mm_probe", _SIGNATURES)
    with torch.cuda.device(a.device):
        err = lib.cgr_mm_probe(a.data_ptr(), b.data_ptr(), ptr(bt),
                               c.data_ptr(), M, N, K, int(int8),
                               stream(a.device))
    raise_on(lib, err, "mm_probe")
    launches += 1
    transpose_launches += int8
    return c


def transpose_s8_ref(b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the int8 transpose: ``b.t()``, contiguous."""
    return b.t().contiguous()


def transpose_s8(b: torch.Tensor) -> torch.Tensor:
    """``Bt [N, K]`` of an int8 ``B [K, N]`` (K and N multiples of 64):
    the transpose mm_probe runs before an int8 product.  CUDA tensors
    launch its kernel or raise; CPU tensors take :func:`transpose_s8_ref`."""
    global transpose_launches
    if b.device.type == "cpu":
        return transpose_s8_ref(b)
    if b.device.type != "cuda":
        raise ValueError(f"unsupported device {b.device}")
    if b.dtype != torch.int8 or b.dim() != 2:
        raise TypeError(f"transpose_s8 takes an int8 matrix, got {b.dtype} "
                        f"of {b.dim()} dimensions")
    K, N = b.shape
    _check_cuda("transpose_s8", b)
    if K % 64 or N % 64:
        raise ValueError(f"transpose_s8 needs K and N multiples of 64, got "
                         f"K={K}, N={N}")
    bt = torch.empty((N, K), device=b.device, dtype=b.dtype)
    lib = library("mm_probe", _SIGNATURES)
    with torch.cuda.device(b.device):
        err = lib.cgr_mm_probe_transpose_s8(b.data_ptr(), bt.data_ptr(), K,
                                            N, stream(b.device))
    raise_on(lib, err, "transpose_s8")
    transpose_launches += 1
    return bt
