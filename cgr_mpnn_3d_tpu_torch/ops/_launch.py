"""What every kernel wrapper does around a launch: load and type its ctypes
library, check its tensors, build the dropout table, pass the stream, and
raise on a failed launch."""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from .kernel_math import MAT_DTYPES, dropout_threshold

__all__ = ["PTR", "I32", "library", "check_types", "check_cuda",
           "seed_list", "check_train", "drop_table", "stage_rates", "stream",
           "raise_on", "refuse_grad", "ptr", "split_k", "mat_index",
           "count_launch"]

PTR, I32 = ctypes.c_void_p, ctypes.c_int


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` (built if needed), its functions
    typed from ``signatures``: {function: (argtypes, restype)}."""
    lib = _build.load(name)
    if not getattr(lib, "_cgr_typed", False):
        for fn, (argtypes, restype) in signatures.items():
            f = getattr(lib, fn)
            f.argtypes, f.restype = list(argtypes), restype
        lib.cgr_cuda_error_string.argtypes = [I32]
        lib.cgr_cuda_error_string.restype = ctypes.c_char_p
        lib._cgr_typed = True
    return lib


def _allowed(types, name: str) -> tuple:
    want = (types or {}).get(name, torch.float32)
    return want if isinstance(want, tuple) else (want,)


def check_types(args: dict, types: dict, what: str) -> None:
    """Each float tensor of ``args`` has a dtype that ``types`` allows for
    its name (a dtype or a tuple of them; float32 where the name is
    missing), on any device; float64 passes where float32 does (the plain
    versions' float64 evaluations).  Index tensors are not looked at."""
    for name, tsr in args.items():
        if not tsr.is_floating_point():
            continue
        ok = _allowed(types, name)
        if tsr.dtype not in ok and not (tsr.dtype == torch.float64
                                        and torch.float32 in ok):
            raise TypeError(f"{name} is {tsr.dtype}; {what} takes "
                            f"{' or '.join(str(t) for t in ok)} there")


def check_cuda(args: dict, device, index_names, types=None) -> None:
    """Every tensor on ``device``, contiguous, int32 when its name is in
    ``index_names`` and otherwise of a dtype ``types`` allows for its name
    (float32 where it is missing)."""
    for name, tsr in args.items():
        ok = (torch.int32,) if name in index_names else _allowed(types, name)
        if tsr.device != device:
            raise ValueError(f"{name} is on {tsr.device}, expected {device}")
        if tsr.dtype not in ok:
            raise TypeError(f"{name} is {tsr.dtype}, the kernel takes "
                            f"{' or '.join(str(t) for t in ok)}")
        if not tsr.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def seed_list(seeds) -> list[int]:
    return [int(s) for s in (seeds.tolist() if torch.is_tensor(seeds)
                             else seeds)]


def check_train(train: bool, seeds, dropout_ps, L: int) -> None:
    if train:
        if seeds is None or len(seeds) != L or len(dropout_ps) != L:
            raise ValueError(f"train mode needs one seed and one drop rate "
                             f"per conv layer ({L})")
        if not all(0.0 <= r < 1.0 for r in dropout_ps):
            raise ValueError(f"drop rates must lie in [0, 1): {dropout_ps}")


@functools.cache
def _rate_rows(dropout_ps: tuple, device: torch.device | None = None):
    """[2, L] int32: the keep thresholds (uint32 bits) and the scales
    1/(1 - rate) (f32 bits) of the drop rates, made once per rates: in
    numpy, or on ``device`` (one copy).  Callers only read it."""
    thr = np.asarray([dropout_threshold(r) for r in dropout_ps], np.uint32)
    scale = np.asarray([1.0 / (1.0 - r) for r in dropout_ps], np.float32)
    rows = np.stack([thr.view(np.int32), scale.view(np.int32)])
    return rows if device is None else torch.from_numpy(rows).to(device)


def stage_rates(dropout_ps, device: torch.device) -> None:
    """Copy the rate rows of ``dropout_ps``, and of each of its layers alone
    (a one-layer kernel's table), to the card ``device`` now, so that a
    later :func:`drop_table` of seeds on the card copies nothing (a staged
    epoch copies nothing to the card)."""
    for rates in (tuple(dropout_ps), *((r,) for r in dropout_ps)):
        _rate_rows(rates, device)


def drop_table(train: bool, seeds, dropout_ps, device):
    """[3, L] int32 on ``device``: seeds, keep thresholds (uint32 bits) and
    scales 1/(1 - rate) (f32 bits); None in eval mode.  A layer of rate 0
    keeps every element at scale 1, which leaves it unchanged.  Seeds that
    are already an int32 tensor on the CUDA ``device`` stay there: the
    table is built on the card, with no host read, and copies nothing once
    :func:`stage_rates` has put its rates there; host seeds
    (a list, or a CPU tensor) are built into the table on the host and
    copied with it."""
    if not train:
        return None
    rates = tuple(dropout_ps)
    if torch.is_tensor(seeds) and seeds.device.type == "cuda":
        if seeds.dtype != torch.int32 or seeds.device != device:
            raise ValueError(f"device seeds must be int32 on {device}, got "
                             f"{seeds.dtype} on {seeds.device}")
        return torch.cat([seeds.reshape(1, -1),
                          _rate_rows(rates, seeds.device)])
    seeds = np.asarray(seed_list(seeds), np.int64) & 0xFFFFFFFF
    table = np.concatenate([seeds.astype(np.uint32).view(np.int32)[None],
                            _rate_rows(rates)])
    # not blocking: the copy of a pageable host buffer is staged before the
    # call returns, and a blocking one would wait for the card's queue
    return torch.from_numpy(table).to(device, non_blocking=True)


def mat_index(mat_dtype: str) -> int:
    """The ``mat`` argument of the CUDA kernels: 0 for f32, 1 for bf16."""
    if mat_dtype not in MAT_DTYPES:
        raise ValueError(f"unsupported mat_dtype {mat_dtype!r}")
    return MAT_DTYPES.index(mat_dtype)


def count_launch(counters: dict, mat_dtype: str, backward: bool,
                 kind: str = "") -> None:
    """One more launch on a layered wrapper's counter (``counters`` is its
    module's globals()): ``<kind>launches`` or ``<kind>bwd_launches``, with a
    ``bf16_`` prefix at mat_dtype bf16."""
    key = kind + ("bwd_launches" if backward else "launches")
    counters[("bf16_" if mat_dtype == "bfloat16" else "") + key] += 1


def split_k(rows: int) -> int:
    """Split-K partials of a weight gradient over ``rows`` rows: one per
    256 rows, at most 64 (a function of the shape only, so reruns sum in
    the same order)."""
    return min(64, max(1, -(-rows // 256)))


def stream(device) -> int:
    """The current CUDA stream of ``device``, as the kernels take it."""
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t) -> int | None:
    """A tensor's device pointer; None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.cgr_cuda_error_string(err).decode())


def refuse_grad(tensors, what: str, instead: str) -> None:
    """A forward-only kernel wrapper under autograd would cut the graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"the {what} kernel has no backward of its own: "
                           f"call {instead} for gradients, or call this "
                           f"under torch.no_grad()")
