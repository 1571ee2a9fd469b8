"""Where the host time of the hop exchange's wrapper (K12,
``parallel/rdma_exchange.py``) goes, step by step.

Each step of one call of the wrapper is run alone ``--calls`` times
between two ``time.perf_counter_ns`` reads, on seeded buffers of the wired
batch's wire shapes (TW 8 rows of hidden 400 per shard; chip_smoke.py
passes the wire itself to :func:`split`) at n_ep 2 and 4, f32 and bf16;
then the whole call
(``ring_exchange_rdma``, no gradient) and ``index_select`` over the
stacked buffers, the library call that computes the same rows, the same
way.  The steps of the wrapper as it stands:

    check       the single-pass check of the buffers
    plan        the cached hop table and active hops of the spec
    allocation  one allocation [n, TW, H]
    views       its n views
    pointers    the source pointers and the stream
    launch      the C call that launches the kernel (no Python around it)

A tree from before the single-allocation wrapper (its ``_launch`` built n
outputs with ``empty_like``, two ctypes pointer arrays and a device
context around the call) is timed by the same tool with that wrapper's
steps (``check``, ``outputs``, ``hop table``, ``pointer arrays``,
``library``, ``device context``, ``stream``, ``launch``), so the two
splits can be set side by side.  Times are µs per call, the least mean of
five runs; the steps' sum is below the whole call by the Python calls
between them.

  python -m cgr_mpnn_3d_tpu_torch.tools.k12_host [--calls 2000]

Needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import time

import torch

__all__ = ["main", "split"]


def _us(fn, calls: int, rounds: int = 5) -> float:
    """µs a call of ``fn``: the least mean of ``rounds`` runs of ``calls``
    calls (the host is shared, so the least is the cost without others'
    interruptions)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter_ns()
        torch.cuda.synchronize()
        best = min(best, (t1 - t0) / calls / 1e3)
    return best


def _steps(rx, bufs, caps) -> dict:
    """{step: a call of that step alone} for the wrapper module ``rx``."""
    from ..ops._launch import library, stream
    dev = bufs[0].device
    row_bytes = bufs[0].shape[1] * bufs[0].element_size()
    n = len(bufs)
    if hasattr(rx, "_hop_table"):            # the n-allocation wrapper
        lib = library("ring_exchange", rx._SIGNATURES)
        outs = [torch.empty_like(b) for b in bufs]
        hops, offs, lens, n_active = rx._hop_table(caps, row_bytes)
        srcs = (ctypes.c_void_p * n)(*(b.data_ptr() for b in bufs))
        dsts = (ctypes.c_void_p * n)(*(o.data_ptr() for o in outs))
        st = stream(dev)

        def device_context():
            with torch.cuda.device(dev):
                pass
        return {
            "check": lambda: rx._check(bufs, caps),
            "outputs": lambda: [torch.empty_like(b) for b in bufs],
            "hop table": lambda: rx._hop_table(caps, row_bytes),
            "pointer arrays": lambda: (
                (ctypes.c_void_p * n)(*(b.data_ptr() for b in bufs)),
                (ctypes.c_void_p * n)(*(o.data_ptr() for o in outs))),
            "library": lambda: library("ring_exchange", rx._SIGNATURES),
            "device context": device_context,
            "stream": lambda: stream(dev),
            "launch": lambda: lib.cgr_ring_exchange(
                srcs, dsts, n, hops, offs, lens, n_active, 0, st)}
    lib = rx._kernel()[0]
    plan = rx._plan(caps, row_bytes)
    out = rx._outputs(plan, bufs)
    srcs, dst, st = rx._pointers(plan, bufs, out)
    return {
        "check": lambda: rx._check(bufs, caps),
        "plan": lambda: rx._plan(caps, row_bytes),
        "allocation": lambda: rx._outputs(plan, bufs),
        "views": lambda: out.unbind(0),
        "pointers": lambda: rx._pointers(plan, bufs, out),
        "launch": lambda: lib.cgr_ring_exchange(plan.table, srcs, dst, 0,
                                                st)}


def split(bufs, caps, calls: int) -> dict:
    """{step: µs per call} of the wrapper's steps, "whole call" and
    "index_select" (the library call) on these buffers."""
    from ..parallel import rdma_exchange as rx
    caps = tuple(int(c) for c in caps)
    out = {name: _us(fn, calls) for name, fn in
           _steps(rx, bufs, caps).items()}
    torch.cuda.synchronize()
    out["whole call"] = _us(lambda: rx.ring_exchange_rdma(bufs, caps),
                            calls)
    n, tw = len(bufs), sum(caps)
    rows = torch.empty(n * tw, dtype=torch.int64)
    off = 0
    for hop, s_h in enumerate(caps, start=1):
        for k in range(n):
            src = (k - hop) % n
            rows[k * tw + off:k * tw + off + s_h] = src * tw + torch.arange(
                off, off + s_h)
        off += s_h
    row_map = rows.to(bufs[0].device)
    stacked = torch.stack(bufs).reshape(n * tw, -1)
    out["index_select"] = _us(lambda: stacked.index_select(0, row_map),
                              calls)
    return out


def main(argv=None) -> dict:
    """Print and return {"n_ep <n> <dtype>": split} on seeded buffers of
    the wired batch's wire shapes: caps (8,) at n_ep 2 and (8, 0, 0) at
    n_ep 4, hidden 400."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    from ..utils.device import resolve_device
    dev = resolve_device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    res = {}
    for caps in ((8,), (8, 0, 0)):
        n = len(caps) + 1
        bufs32 = [torch.randn((sum(caps), 400), generator=gen).to(dev)
                  for _ in range(n)]
        for dtype in (torch.float32, torch.bfloat16):
            bufs = [b.to(dtype).contiguous() for b in bufs32]
            key = f"n_ep {n} {str(dtype)[6:]}"
            res[key] = split(bufs, caps, args.calls)
            print(f"K12 wrapper host split, {key}, caps {caps} (µs per "
                  f"call): " + "; ".join(f"{k} {v:.3f}"
                                         for k, v in res[key].items()))
    return res


if __name__ == "__main__":
    main()
