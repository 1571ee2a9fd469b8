"""The hop exchange of edge partitioning as one kernel (K12).

The counterpart of ``cgr_mpnn_3d_tpu/parallel/rdma_exchange.py``
(``ring_exchange_rdma``, ``_exchange_call``), selected the same way:
``CGRMPNNConfig.ep_rdma_exchange`` (``--ep_rdma``).  Each shard holds a wire
buffer [TW, H] in the hop-aligned layout of :mod:`.ep_pack`; hop h owns the
rows [off_h, off_h + caps[h-1]) and moves them from shard k to shard k + h
(``inverse``: k - h), mod n_ep.  The semantics are those of the ppermute
ring (:func:`_ring_move`, the plain version, which
``ep_pack.ring_exchange`` runs by default): a blockwise permutation, whose
adjoint is the inverse exchange.

Every shard of a step lies on one card here (``ep_pack.run_lockstep``), so
:func:`ring_exchange_rdma` moves every active hop block of every shard in
ONE launch of ``csrc/ring_exchange.cu`` for CUDA tensors (or raises), and
its backward is one more launch in the other direction; CPU tensors take
:func:`_ring_move`.  The hop table (distance, byte offset, bytes) is built
once per (caps, row bytes) and cached; the n_ep source and output pointers
go into the kernel's parameters with the launch, so the shards' tensors
stay separate.  With no active hop (TW = 0) the buffers come back as they
are, as in JAX.  Counters ``launches`` and ``bwd_launches``.  Peer copies
between cards (``torch.distributed``) are not ported (ROADMAP.md).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops._launch import I32, PTR, library, raise_on, stream

__all__ = ["ring_exchange_rdma", "launches", "bwd_launches", "MAX_SHARDS"]

# kernel launches by the wrapper (nothing else adds here)
launches = 0
bwd_launches = 0
MAX_SHARDS = 32      # csrc/ring_exchange.cu's kMaxShards

_SIGNATURES = {
    "cgr_ring_exchange": ([PTR, PTR, I32, PTR, PTR, PTR, I32, I32, PTR], I32),
}


def _active_hops(caps: tuple[int, ...]) -> list[tuple[int, int, int]]:
    """[(hop, row offset, rows)] of the hops with a non-empty block."""
    out, off = [], 0
    for h, s_h in enumerate(caps, start=1):
        if s_h > 0:
            out.append((h, off, s_h))
        off += s_h
    return out


def _ring_move(bufs, caps, inverse: bool) -> list:
    """The plain version: shard k's block of hop h, as shard k + h's
    (``inverse``: k - h), by slices and one concatenation per shard."""
    n = len(bufs)
    outs = [[] for _ in range(n)]
    off = 0
    for h, s_h in enumerate(caps, start=1):
        for k in range(n):
            src = (k + h) % n if inverse else (k - h) % n
            outs[k].append(bufs[src][off:off + s_h])
        off += s_h
    return [torch.cat(o, dim=0) for o in outs]


@functools.lru_cache(maxsize=64)
def _hop_table(caps: tuple[int, ...], row_bytes: int):
    """(hops, byte offsets, bytes, count) of the active hops as ctypes
    arrays, built once per spec and row width."""
    active = _active_hops(caps)
    n = len(active)
    return ((ctypes.c_int * n)(*(h for h, _, _ in active)),
            (ctypes.c_longlong * n)(*(off * row_bytes for _, off, _ in active)),
            (ctypes.c_longlong * n)(*(s * row_bytes for _, _, s in active)),
            n)


def _check(bufs, caps) -> None:
    n, tw = len(bufs), sum(caps)
    if n != len(caps) + 1:
        raise ValueError(f"{n} buffers for {len(caps)} hops (n_ep - 1)")
    if n > MAX_SHARDS:
        raise ValueError(f"the kernel takes at most {MAX_SHARDS} shards")
    b0 = bufs[0]
    for k, b in enumerate(bufs):
        if b.dim() != 2 or b.shape != b0.shape or b.shape[0] != tw:
            raise ValueError(f"buffer {k} has shape {tuple(b.shape)}; every "
                             f"buffer must be [TW={tw}, H] alike")
        if b.dtype not in (torch.float32, torch.bfloat16) \
                or b.dtype != b0.dtype:
            raise TypeError(f"buffer {k} is {b.dtype}; the kernel takes "
                            f"float32 or bfloat16, one type for all")
        if b.device != b0.device:
            raise ValueError(f"buffer {k} is on {b.device}, not {b0.device}")
        if not b.is_contiguous():
            raise ValueError(f"buffer {k} is not contiguous")


def _launch(bufs, caps, inverse: bool) -> list:
    _check(bufs, caps)
    dev = bufs[0].device
    outs = [torch.empty_like(b) for b in bufs]
    hops, offs, lens, n_active = _hop_table(
        caps, bufs[0].shape[1] * bufs[0].element_size())
    n = len(bufs)
    srcs = (ctypes.c_void_p * n)(*(b.data_ptr() for b in bufs))
    dsts = (ctypes.c_void_p * n)(*(o.data_ptr() for o in outs))
    lib = library("ring_exchange", _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.cgr_ring_exchange(srcs, dsts, n, hops, offs, lens,
                                    n_active, int(inverse), stream(dev))
    raise_on(lib, err, "ring_exchange")
    return outs


def _exchange(bufs, caps, inverse: bool, backward: bool) -> list:
    """The exchange: the kernel for CUDA tensors (or a raise), the plain
    version for CPU tensors."""
    global launches, bwd_launches
    dev = bufs[0].device
    if dev.type == "cpu":
        return _ring_move(bufs, caps, inverse)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    outs = _launch(bufs, caps, inverse)
    if backward:
        bwd_launches += 1
    else:
        launches += 1
    return outs


class _RdmaExchange(torch.autograd.Function):
    """Forward: the exchange.  Backward: the inverse exchange of the
    cotangents (``_rer_bwd``)."""

    @staticmethod
    def forward(ctx, caps, inverse, *bufs):
        ctx.caps, ctx.inverse = caps, inverse
        return tuple(_exchange(bufs, caps, inverse, False))

    @staticmethod
    def backward(ctx, *grads):
        grads = [g.contiguous() for g in grads]
        return (None, None,
                *_exchange(grads, ctx.caps, not ctx.inverse, True))


def ring_exchange_rdma(bufs, caps, inverse: bool = False) -> list:
    """Every shard's wire buffer through the hop exchange (one launch on
    the card), differentiable; the buffers themselves when no hop is
    active."""
    caps = tuple(int(c) for c in caps)
    if not _active_hops(caps):
        return list(bufs)
    return list(_RdmaExchange.apply(caps, inverse, *bufs))
