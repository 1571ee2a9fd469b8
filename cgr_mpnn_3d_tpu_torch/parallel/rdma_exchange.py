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

Where every shard of a step lies on one card in one process
(``ep_pack.run_lockstep``), :func:`ring_exchange_rdma` moves every active
hop block of every shard in ONE launch of ``csrc/ring_exchange.cu`` for
CUDA tensors (or raises), and its backward is one more launch in the other
direction; CPU tensors take :func:`_ring_move`.  With no active hop (TW =
0) the buffers come back as they are, as in JAX.  Counters ``launches``
and ``bwd_launches``.

With one EP shard a rank (``multihost`` layout (b), ``ep_pack.
run_distributed``), :func:`rank_exchange_rdma` moves this rank's buffer
to its peers by ``csrc/rank_exchange.cu``: peer copies into regions that
each rank made with ``cudaMalloc`` and opened in the others through CUDA
IPC (ranks sharing one card, or peer cards over NVLink), with the barrier
and the arrival signals in device memory and no host call that waits on a
peer.  A plan per (caps, row bytes, EP group, device) is made at its first
forward exchange: every rank of the group allocates its region and the
handles are swapped once with ``dist.all_gather`` over the group, the only
rendezvous (all ranks reach it at the same request).  Every rank must then
issue the same exchanges on the same plans in the same order, forward and
backward; the backward (``_rer_bwd``: the inverse exchange) finds its plan
made.  Each spin is bounded by ``timeout_s`` (default: the process group's
timeout); a peer that never arrives sets an error word that
:func:`check_errors` (called at each exchange and at the step's
synchronizing reads) raises on, naming the peer rank.  :func:`close` ends
every plan (the trainer calls it at its end, before the process group
goes away).  CPU tensors take the gloo point-to-point move
(``ep_pack._rank_ring_move``); a CUDA tensor launches the kernel or
raises.  Counters ``rank_launches`` and ``rank_bwd_launches``.

The one-card kernel takes microseconds, so a call's cost is the
wrapper's host work, which is kept to what each call needs:

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

__all__ = ["ring_exchange_rdma", "rank_exchange_rdma", "check_errors",
           "close", "launches", "bwd_launches", "rank_launches",
           "rank_bwd_launches", "MAX_SHARDS"]

# kernel launches by the wrappers (nothing else adds here)
launches = 0
bwd_launches = 0
rank_launches = 0
rank_bwd_launches = 0
MAX_SHARDS = 32      # kMaxShards of csrc/ring_exchange.cu, rank_exchange.cu

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


# ---------------------------------------------------------------------------
# across ranks: one EP shard a rank (csrc/rank_exchange.cu)
# ---------------------------------------------------------------------------

_RANK_SIGNATURES = {
    "cgr_rank_region_create": ([ctypes.c_longlong, PTR, PTR], I32),
    "cgr_rank_region_open": ([PTR, PTR], I32),
    "cgr_rank_region_close": ([PTR], I32),
    "cgr_rank_region_free": ([PTR], I32),
    "cgr_rank_errors": ([PTR, PTR], I32),
    "cgr_rank_exchange": ([PTR, PTR, PTR, I32, ctypes.c_uint,
                           ctypes.c_ulonglong, PTR], I32)}
_HANDLE_BYTES = 64       # sizeof(cudaIpcMemHandle_t)
_SLOT_ALIGN = 256        # rank_exchange.cu's kSlotAlign
_WAITED_FOR = {1: "release its receive slot", 2: "arrive"}


class _RankTable(ctypes.Structure):
    """csrc/rank_exchange.cu's RankTable."""
    _fields_ = [("n", ctypes.c_int), ("me", ctypes.c_int),
                ("n_active", ctypes.c_int), ("plan", ctypes.c_int),
                ("slot_bytes", ctypes.c_longlong),
                ("tw_bytes", ctypes.c_longlong),
                ("sig_off", ctypes.c_longlong),
                ("hop", ctypes.c_int * MAX_SHARDS),
                ("off", ctypes.c_longlong * MAX_SHARDS),
                ("len", ctypes.c_longlong * MAX_SHARDS),
                ("region", ctypes.c_void_p * MAX_SHARDS),
                ("err", ctypes.c_void_p)]


class _RankPlan:
    """One (caps, row bytes, EP group, device)'s regions and epoch."""

    def __init__(self, key, comm, table, region: int, peers: list):
        self.key, self.comm, self.table = key, comm, table
        self.addr = ctypes.addressof(table)
        self.region, self.peers = region, peers
        self.epoch = 0               # exchanges so far, the same on every rank
        self.timeout_s = 0.0         # the last exchange's limit


_rank_plans: dict = {}               # key -> _RankPlan, the open ones
_plans_made: list = []               # every plan made, by its id
_words = None                        # the error words' host view


@functools.cache
def _rank_kernel():
    """The library of csrc/rank_exchange.cu, loaded (and built) once."""
    return library("rank_exchange", _RANK_SIGNATURES)


@functools.cache
def _errors() -> int:
    """The process's error words [code, peer shard, epoch, plan id] in
    mapped pinned host memory, made once: their device address (the host
    view is ``_words``)."""
    global _words
    lib = _rank_kernel()
    host, dev = ctypes.c_void_p(), ctypes.c_void_p()
    err = lib.cgr_rank_errors(ctypes.byref(host), ctypes.byref(dev))
    if err:
        raise_on(lib, err, "cross-rank K12 error words")
    _words = (ctypes.c_uint * 4).from_address(host.value)
    return dev.value


def check_errors() -> None:
    """Raise, once, if an exchange of this process gave up waiting on a
    peer (the kernel's error words, read without a device sync), naming
    the peer's rank, the plan and the exchange."""
    if _words is None or not _words[0]:
        return
    code, peer, epoch, plan = (int(w) for w in _words)
    _words[0] = 0
    p = _plans_made[plan]
    ranks = p.comm.ranks
    raise RuntimeError(
        f"cross-rank K12: rank {ranks[peer]} (EP shard {peer}) did not "
        f"{_WAITED_FOR.get(code, f'answer (code {code})')} within "
        f"{p.timeout_s} s at exchange {epoch} of the plan caps={p.key[0]} "
        f"over ranks {ranks}")


def _open_plan(key, caps, row_bytes: int, comm):
    """This rank's region for ``caps`` rows of ``row_bytes``, its handle
    swapped with the group's (``dist.all_gather``, the plan's only
    rendezvous) and the peers' regions opened."""
    import torch.distributed as dist
    lib = _rank_kernel()
    n, active = len(caps) + 1, _active(caps)
    if n != len(comm.ranks):
        raise ValueError(f"caps of {n} shards for an EP group of "
                         f"{len(comm.ranks)} ranks")
    if n > MAX_SHARDS:
        raise ValueError(f"the kernel takes at most {MAX_SHARDS} shards")
    tw_bytes = int(sum(caps)) * row_bytes
    slot = -(-tw_bytes // _SLOT_ALIGN) * _SLOT_ALIGN
    region, handle = ctypes.c_void_p(), (ctypes.c_ubyte * _HANDLE_BYTES)()
    err = lib.cgr_rank_region_create(slot, ctypes.byref(region), handle)
    if err:
        raise_on(lib, err, "cross-rank K12 region (cudaMalloc, "
                           "cudaIpcGetMemHandle)")
    mine = torch.tensor([comm.shard, *handle], dtype=torch.int64)
    got = [torch.empty_like(mine) for _ in comm.ranks]
    dist.all_gather(got, mine, group=comm.group)
    peers = [None] * n
    try:
        for g in got:
            k = int(g[0])
            if k == comm.shard:
                continue
            their = (ctypes.c_ubyte * _HANDLE_BYTES)(*g[1:].tolist())
            ptr = ctypes.c_void_p()
            err = lib.cgr_rank_region_open(their, ctypes.byref(ptr))
            if err:
                raise RuntimeError(
                    f"cross-rank K12: cudaIpcOpenMemHandle of rank "
                    f"{comm.ranks[k]}'s region failed: "
                    + lib.cgr_cuda_error_string(err).decode())
            peers[k] = ptr.value
    except BaseException:
        for ptr in peers:
            if ptr:
                lib.cgr_rank_region_close(ptr)
        lib.cgr_rank_region_free(region)
        raise
    t = _RankTable(n=n, me=comm.shard, n_active=len(active),
                   plan=len(_plans_made), slot_bytes=slot,
                   tw_bytes=tw_bytes, sig_off=2 * slot, err=_errors())
    for i, (h, off, s_h) in enumerate(active):
        t.hop[i], t.off[i], t.len[i] = h, int(off) * row_bytes, \
            int(s_h) * row_bytes
    for k in range(n):
        t.region[k] = region.value if k == comm.shard else peers[k]
    plan = _RankPlan(key, comm, t, region.value, [p for p in peers if p])
    _plans_made.append(plan)
    return plan


def _rank_plan(caps, row_bytes: int, comm, device, create: bool):
    key = (caps, row_bytes, tuple(comm.ranks), device.index)
    plan = _rank_plans.get(key)
    if plan is None:
        if not create:
            raise RuntimeError(
                f"cross-rank K12: no plan for caps={caps} over ranks "
                f"{comm.ranks}; plans are made by a forward exchange, and "
                f"the backward's must exist already")
        plan = _rank_plans[key] = _open_plan(key, caps, row_bytes, comm)
    return plan


def _check_rank(buf, caps) -> None:
    """This rank's buffer [TW, H], f32 or bf16, contiguous."""
    tw = sum(caps)
    if buf.dim() != 2 or buf.shape[0] != tw:
        raise ValueError(f"the buffer has shape {tuple(buf.shape)}; the "
                         f"exchange takes [TW={tw}, H]")
    if buf.dtype not in _DTYPES:
        raise TypeError(f"the buffer is {buf.dtype}; the kernel takes "
                        f"float32 or bfloat16")
    if not buf.is_contiguous():
        raise ValueError("the buffer is not contiguous")


def _rank_launch(buf, caps, inverse: bool, comm, timeout_s: float,
                 create: bool):
    check_errors()
    _check_rank(buf, caps)
    index = buf.device.index
    if index != torch._C._cuda_getDevice():
        with torch.cuda.device(index):
            return _rank_launch(buf, caps, inverse, comm, timeout_s, create)
    plan = _rank_plan(caps, buf.shape[1] * buf.element_size(), comm,
                      buf.device, create)
    out = torch.empty_like(buf)
    plan.epoch += 1
    plan.timeout_s = timeout_s
    lib = _rank_kernel()
    err = lib.cgr_rank_exchange(
        plan.addr, buf.data_ptr(), out.data_ptr(), int(inverse), plan.epoch,
        int(timeout_s * 1e9), torch._C._cuda_getCurrentRawStream(index))
    if err:
        raise_on(lib, err, "cross-rank K12")
    return out


def _rank_exchange(buf, caps, inverse: bool, comm, timeout_s: float,
                   backward: bool):
    """The cross-rank exchange: the kernel for CUDA tensors (or a raise),
    gloo's point-to-point move for CPU tensors."""
    global rank_launches, rank_bwd_launches
    dev = buf.device
    if dev.type == "cpu":
        from . import ep_pack
        return ep_pack._rank_ring_move(buf, caps, inverse, comm)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = _rank_launch(buf, caps, inverse, comm, timeout_s, not backward)
    if backward:
        rank_bwd_launches += 1
    else:
        rank_launches += 1
    return out


class _RankRdmaExchange(torch.autograd.Function):
    """Forward: this rank's share of the exchange.  Backward: the inverse
    exchange of its cotangent (``_rer_bwd``) on the same plan."""

    @staticmethod
    def forward(ctx, buf, caps, inverse, comm, timeout_s):
        ctx.args = (caps, inverse, comm, timeout_s)
        return _rank_exchange(buf, caps, inverse, comm, timeout_s, False)

    @staticmethod
    def backward(ctx, g):
        caps, inverse, comm, timeout_s = ctx.args
        return (_rank_exchange(g.contiguous(), caps, not inverse, comm,
                               timeout_s, True), None, None, None, None)


def rank_exchange_rdma(buf: torch.Tensor, caps, inverse: bool, comm,
                       timeout_s: float | None = None) -> torch.Tensor:
    """This rank's wire buffer [TW, H] through the hop exchange with the
    other ranks of its EP group (``comm``: ``multihost.ep_comm``), one
    launch on the card, differentiable; the buffer itself when no hop is
    active.  Each wait on a peer gives up after ``timeout_s`` (default: the
    process group's timeout)."""
    if type(caps) is not tuple:
        caps = tuple(caps)
    if not _active(caps):
        return buf
    if timeout_s is None:
        from .multihost import group_timeout_s
        timeout_s = group_timeout_s()
    if torch.is_grad_enabled() and buf.requires_grad:
        return _RankRdmaExchange.apply(buf, caps, inverse, comm, timeout_s)
    return _rank_exchange(buf, caps, inverse, comm, timeout_s, False)


def close(barrier: bool = True) -> None:
    """End every cross-rank plan of this process: wait for its card, close
    the peers' regions, meet the group's other ranks (a gloo barrier, so
    that no rank frees a region another still maps), free its own region;
    then raise an error of the kernel not raised yet.  Every rank of a
    group calls it at the same point; a no-op without plans.  With
    ``barrier=False`` (a rank leaving on an error, whose peers may not come)
    it meets no one and frees nothing: a peer may still write into its
    region, which goes with the process."""
    global _rank_plans
    plans, _rank_plans = list(_rank_plans.values()), {}
    if not plans:
        return
    import torch.distributed as dist
    lib = _rank_kernel()
    for index in sorted({p.key[3] for p in plans}):
        torch.cuda.synchronize(index)
    for p in plans:
        for ptr in p.peers:
            lib.cgr_rank_region_close(ptr)
    if not barrier:
        return
    try:
        if dist.is_initialized():
            groups = {p.comm.ranks: p.comm.group for p in plans}
            for ranks in sorted(groups):
                dist.barrier(group=groups[ranks])
    finally:
        for p in plans:
            lib.cgr_rank_region_free(p.region)
    check_errors()
