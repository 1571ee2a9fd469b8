"""Matmul rate probe (P2): is int8 about twice bf16 on this card's tensor
cores, through the library and through a hand-written kernel (TMA loads
feeding ``wgmma``; for int8 with the transpose of B it needs)?

The counterpart of ``tools/int8_microbench.py``.  It times N x N products
(2 N^3 operations each) and prints the JAX tool's four rate lines and its
int8/bf16 ratio line:

    cuBLAS bf16->f32        torch.matmul on bf16 (the JAX tool's XLA line)
    cuBLASLt int8->int32    torch._int_mm (the JAX tool's XLA int8 line)
    P2 bf16->f32            ops/mm_probe.py::mm_probe on bf16, C in bf16
    P2 int8->int32          mm_probe on int8, C the low 8 bits (the Pallas
                            kernel's wrapping astype)

The two library lines are yardsticks: no path of the port calls them.  Each
rate is the best of ``--repeats`` runs of ``--steps`` calls on the same
seeded inputs (bf16 normal, int8 in [-3, 3]) between two CUDA events, after
a warm-up call; the card caches no results, so the calls need no chain.
cuBLASLt gets its column-major B made once, outside the timed calls; P2's
int8 line times its transpose of B in every call.  A failing line raises
instead of printing 0.0.  ``--cpu`` runs the plain
version and the CPU's library calls (their rates are the CPU's).

  python -m cgr_mpnn_3d_tpu_torch.tools.int8_microbench [--cpu] [--n 4096]
      [--steps 32] [--repeats 3]
"""

from __future__ import annotations

import argparse
import time

import torch

__all__ = ["main", "LINES"]

LINES = ("cuBLAS bf16->f32", "cuBLASLt int8->int32", "P2 bf16->f32",
         "P2 int8->int32")


def main(argv=None) -> dict:
    """Run the probe, print its lines; returns {"device", "n", "steps",
    "tops": {line: T(FL)OP/s}, "ms": {line: ms per call}, "ratio": {"cuBLAS",
    "P2": int8 / bf16 rate}}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)

    from ..ops.mm_probe import mm_probe
    from ..utils.device import resolve_device

    dev = resolve_device("cpu" if args.cpu else "cuda")
    N = args.n
    gen = torch.Generator().manual_seed(0)
    a16 = torch.randn((N, N), generator=gen).bfloat16().to(dev)
    b16 = torch.randn((N, N), generator=gen).bfloat16().to(dev)
    a8 = torch.randint(-3, 4, (N, N), generator=gen, dtype=torch.int8).to(dev)
    b8 = torch.randint(-3, 4, (N, N), generator=gen, dtype=torch.int8).to(dev)
    b8_cols = b8.t().contiguous().t()     # cuBLASLt's int8 layout
    calls = {LINES[0]: lambda: torch.matmul(a16, b16),
             LINES[1]: lambda: torch._int_mm(a8, b8_cols),
             LINES[2]: lambda: mm_probe(a16, b16),
             LINES[3]: lambda: mm_probe(a8, b8)}

    def seconds(fn) -> float:
        fn()                                  # build + warm up
        best = float("inf")
        for _ in range(args.repeats):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.steps):
                    fn()
                end.record()
                torch.cuda.synchronize(dev)
                t = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                for _ in range(args.steps):
                    fn()
                t = time.perf_counter() - t0
            best = min(best, t / args.steps)
        return best

    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={kind} n={N} steps={args.steps} repeats={args.repeats}")
    flops = 2.0 * N ** 3
    secs = {name: seconds(fn) for name, fn in calls.items()}
    tops = {name: flops / t / 1e12 for name, t in secs.items()}
    for name in LINES:
        print(f"{name:28s} {tops[name]:9.3f} T(FL)OP/s "
              f"({secs[name] * 1e3:.4f} ms per call)")
    ratio = {"cuBLAS": tops[LINES[1]] / tops[LINES[0]],
             "P2": tops[LINES[3]] / tops[LINES[2]]}
    print(f"int8/bf16 speedup: cuBLAS {ratio['cuBLAS']:.2f}x, "
          f"P2 {ratio['P2']:.2f}x")
    return {"device": kind, "n": N, "steps": args.steps, "tops": tops,
            "ms": {name: t * 1e3 for name, t in secs.items()},
            "ratio": ratio}


if __name__ == "__main__":
    main()
