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
:func:`_ring_move`.  With no active hop (TW = 0) the buffers come back as
they are, as in JAX.  Counters ``launches`` and ``bwd_launches``.  Peer
copies between cards (``torch.distributed``) are not ported (ROADMAP.md).

The kernel takes microseconds, so a call's cost is the wrapper's host
work, which is kept to what each call needs:

* a plan per (caps, row bytes), cached: the active hops, TW and the hop
  table the kernel reads, passed by address;
* one check of the buffers against the first one's shape, dtype, device
  and layout;
* ONE output allocation [n_ep, TW, H], returned as n_ep views; nothing is
  kept across calls (the EP generators hold the received buffers for
  later layers, and autograd saves them, while the kernel writes through
  raw pointers that bump no version counter);
* the source pointers in one ctypes array, and no device switch when the
  buffers lie on the current device;
* autograd only when a buffer requires a gradient.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..ops._launch import I32, PTR, library, raise_on

__all__ = ["ring_exchange_rdma", "launches", "bwd_launches", "MAX_SHARDS"]

# kernel launches by the wrapper (nothing else adds here)
launches = 0
bwd_launches = 0
MAX_SHARDS = 32      # csrc/ring_exchange.cu's kMaxShards

_SIGNATURES = {"cgr_ring_exchange": ([PTR, PTR, PTR, I32, PTR], I32)}
_DTYPES = (torch.float32, torch.bfloat16)


class _HopTable(ctypes.Structure):
    """csrc/ring_exchange.cu's HopTable."""
    _fields_ = [("n", ctypes.c_int), ("n_active", ctypes.c_int),
                ("stride", ctypes.c_longlong),
                ("hop", ctypes.c_int * MAX_SHARDS),
                ("off", ctypes.c_longlong * MAX_SHARDS),
                ("len", ctypes.c_longlong * MAX_SHARDS)]


class _Plan(NamedTuple):
    """What one spec and row width need at every call."""
    tw: int
    srcs: type            # ctypes array type of the n source pointers
    table: int            # address of the kept _HopTable
    keep: _HopTable


def _active_hops(caps: tuple[int, ...]) -> list[tuple[int, int, int]]:
    """[(hop, row offset, rows)] of the hops with a non-empty block."""
    out, off = [], 0
    for h, s_h in enumerate(caps, start=1):
        if s_h > 0:
            out.append((h, off, s_h))
        off += s_h
    return out


@functools.lru_cache(maxsize=256)
def _active(caps: tuple[int, ...]) -> tuple[tuple[int, int, int], ...]:
    """:func:`_active_hops` of ``caps``, computed once per spec."""
    return tuple(_active_hops(caps))


@functools.lru_cache(maxsize=256)
def _plan(caps: tuple[int, ...], row_bytes: int) -> _Plan:
    n, active = len(caps) + 1, _active(caps)
    if n > MAX_SHARDS:
        raise ValueError(f"the kernel takes at most {MAX_SHARDS} shards")
    tw = int(sum(caps))
    t = _HopTable(n=n, n_active=len(active), stride=tw * row_bytes)
    for i, (h, off, s_h) in enumerate(active):
        t.hop[i], t.off[i], t.len[i] = h, int(off) * row_bytes, \
            int(s_h) * row_bytes
    return _Plan(tw, ctypes.c_void_p * n, ctypes.addressof(t), t)


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


def _check(bufs, caps) -> None:
    """Every buffer [TW, H] like the first one: shape, dtype (f32 or bf16),
    device, contiguous; one buffer per shard, at most MAX_SHARDS."""
    n, tw = len(bufs), sum(caps)
    if n != len(caps) + 1:
        raise ValueError(f"{n} buffers for {len(caps)} hops (n_ep - 1)")
    if n > MAX_SHARDS:
        raise ValueError(f"the kernel takes at most {MAX_SHARDS} shards")
    b0 = bufs[0]
    shape, dtype, dev = b0.shape, b0.dtype, b0.device
    if len(shape) == 2 and shape[0] == tw and dtype in _DTYPES:
        if all(b.shape == shape and b.dtype == dtype and b.device == dev
               and b.is_contiguous() for b in bufs):
            return
    for k, b in enumerate(bufs):
        if b.dim() != 2 or b.shape != shape or b.shape[0] != tw:
            raise ValueError(f"buffer {k} has shape {tuple(b.shape)}; every "
                             f"buffer must be [TW={tw}, H] alike")
        if b.dtype not in _DTYPES or b.dtype != dtype:
            raise TypeError(f"buffer {k} is {b.dtype}; the kernel takes "
                            f"float32 or bfloat16, one type for all")
        if b.device != dev:
            raise ValueError(f"buffer {k} is on {b.device}, not {dev}")
        if not b.is_contiguous():
            raise ValueError(f"buffer {k} is not contiguous")


def _pointers(plan: _Plan, bufs, out) -> tuple:
    """(the source pointer array, the output's base, the current stream of
    the buffers' device)."""
    return (plan.srcs(*[b.data_ptr() for b in bufs]), out.data_ptr(),
            torch._C._cuda_getCurrentRawStream(bufs[0].device.index))


def _outputs(plan: _Plan, bufs):
    """One allocation [n_ep, TW, H] like the buffers."""
    b0 = bufs[0]
    return b0.new_empty((len(bufs), plan.tw, b0.shape[1]))


@functools.cache
def _kernel():
    """The library and its launch function, loaded (and built) once."""
    lib = library("ring_exchange", _SIGNATURES)
    return lib, lib.cgr_ring_exchange


def _launch(bufs, caps, inverse: bool) -> list:
    _check(bufs, caps)
    b0 = bufs[0]
    plan = _plan(caps, b0.shape[1] * b0.element_size())
    out = _outputs(plan, bufs)
    srcs, dst, st = _pointers(plan, bufs, out)
    lib, fn = _kernel()
    index = b0.device.index
    if index == torch._C._cuda_getDevice():
        err = fn(plan.table, srcs, dst, int(inverse), st)
    else:
        with torch.cuda.device(index):
            err = fn(plan.table, srcs, dst, int(inverse), st)
    if err:
        raise_on(lib, err, "ring_exchange")
    return list(out.unbind(0))


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
    if type(caps) is not tuple:
        caps = tuple(caps)
    if not _active(caps):
        return list(bufs)
    if torch.is_grad_enabled() and any(b.requires_grad for b in bufs):
        return list(_RdmaExchange.apply(caps, inverse, *bufs))
    if bufs[0].is_cuda:
        global launches
        outs = _launch(bufs, caps, inverse)
        launches += 1
        return outs
    return _exchange(bufs, caps, inverse, False)
