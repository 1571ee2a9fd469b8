"""Where the matmul probe's kernel (P2, ``csrc/mm_probe.cu``) spends its
time, A/B against variant builds of the same source.

At N = 4096 in bf16 and int8 (int8 with its transpose of B, as
``ops/mm_probe.py::mm_probe`` runs it), through these builds:

    shipped          the library the wrapper loads;
    no epilogue      each tile's accumulators are only summed: no staging
                     and no store of C (the epilogue's share of the time);
    no C store       C is staged in shared memory but not stored (the TMA
                     store's share);
    one stage fewer  a ring of 3 stages in int8, 2 in bf16 (the pipeline
                     depth's share);

then, through the shipped build, bf16 with M = 4224 (33 tile rows: 528
tiles of 128 x 256, exactly 4 on each of 132 SMs) beside M = 4096 (512
tiles: 116 SMs take 4, 16 take 3), whose time per tile says whether the
last wave's imbalance costs; and the SM clock and power draw (nvidia-smi,
sampled in a thread) while the shipped bf16 kernel runs about a second.
The builds run in the order shipped, variants, shipped; each time is the
best of ``--repeats`` runs of ``--steps`` calls between two CUDA events.
Variants are built under ``build/mm_probe_parts/``; every product of a
variant that stores C is held to the shipped build's (equal: the sums run
in one order).

  python -m cgr_mpnn_3d_tpu_torch.tools.mm_probe_parts [--n 4096]
      [--steps 32] [--repeats 3]

Needs the card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import threading
import time

import torch

__all__ = ["main", "VARIANTS"]

# variant -> (text of the shipped source, its replacement)
_EPILOGUE = "      if (t == 0) bulk_wait_read<0>();"
VARIANTS = {
    # the sum keeps every accumulator live: dead wgmma results may be
    # dropped by ptxas, which would time less than the products
    "no epilogue": (_EPILOGUE, "      {\n        Acc x = 0;\n"
                    "#pragma unroll\n"
                    "        for (int i = 0; i < 128; ++i) x += acc[i];\n"
                    "        if (x == Acc(12345)) cs[t] = 1;\n"
                    "        continue;\n      }\n" + _EPILOGUE),
    "no C store": ("          tma_store_2d(&tc,",
                   "          if (false) tma_store_2d(&tc,"),
    "one stage fewer": ("constexpr int kStages = kInt8 ? 4 : 3;",
                        "constexpr int kStages = kInt8 ? 3 : 2;"),
}
# variants whose C is not the product (nothing or not all of it stored)
_NO_C = ("no epilogue", "no C store")


def _build_variant(name: str) -> ctypes.CDLL:
    from ..ops import _build
    old, new = VARIANTS[name]
    src = (_build.CSRC / "mm_probe.cu").read_text()
    if src.count(old) != 1:
        raise RuntimeError(f"mm_probe.cu no longer holds {old!r}, which the "
                           f"variant {name!r} replaces")
    out = _build.BUILD_DIR / "mm_probe_parts" / name.replace(" ", "_")
    out.mkdir(parents=True, exist_ok=True)
    (out / "mm_probe.cu").write_text(src.replace(old, new))
    lib = out / "libmm_probe.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                          str(_build.CSRC), "-o", str(lib),
                          str(out / "mm_probe.cu")],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for the variant {name!r}:\n"
                           f"{res.stdout}{res.stderr}")
    return ctypes.CDLL(str(lib))


def _ms(fn, steps: int, repeats: int) -> float:
    fn()
    best = float("inf")
    for _ in range(repeats):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / steps)
    return best


def _clocks_while(fn, seconds: float) -> list[str]:
    """nvidia-smi's SM clock and power draw, sampled every 0.2 s while
    ``fn`` runs back to back for about ``seconds``."""
    samples: list[str] = []
    done = threading.Event()

    def sample():
        while not done.is_set():
            samples.append(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30).stdout.strip())
            done.wait(0.2)
    t = threading.Thread(target=sample)
    t.start()
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(100):
                fn()
            torch.cuda.synchronize()
    finally:
        done.set()
        t.join()
    return samples


def main(argv=None) -> dict:
    """Run the A/B; returns {"ms": {build: {dtype: [ms, ...]}},
    "waves": {"M=4096": ms per tile, "M=4224": ms per tile}, "clocks":
    [nvidia-smi samples]}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)

    from ..ops import _build
    from ..ops import mm_probe as mp
    from ..utils.device import resolve_device
    dev = resolve_device("cuda")
    N = args.n
    gen = torch.Generator().manual_seed(0)
    ops = {"bf16": (torch.randn((N, N), generator=gen).bfloat16().to(dev),
                    torch.randn((N, N), generator=gen).bfloat16().to(dev)),
           "int8": tuple(torch.randint(-3, 4, (N, N), generator=gen,
                                       dtype=torch.int8).to(dev)
                         for _ in range(2))}
    shipped = _build.load("mm_probe")
    libs = {"shipped": shipped}
    libs.update({name: _build_variant(name) for name in VARIANTS})
    ms: dict = {name: {dt: [] for dt in ops} for name in libs}
    want = {dt: mp.mm_probe(*ab) for dt, ab in ops.items()}
    order = ["shipped", *VARIANTS, "shipped"]
    try:
        for name in order:
            _build._libs["mm_probe"] = libs[name]
            for dt, (a, b) in ops.items():
                got = mp.mm_probe(a, b)
                if name not in _NO_C and not torch.equal(got, want[dt]):
                    raise RuntimeError(f"the {name!r} build's {dt} product "
                                       f"differs from the shipped one's")
                ms[name][dt].append(_ms(lambda: mp.mm_probe(a, b),
                                        args.steps, args.repeats))
    finally:
        _build._libs["mm_probe"] = shipped
    flops = 2.0 * N ** 3
    for name in libs:
        for dt in ops:
            print(f"P2 {dt} N = {N}, {name}: "
                  f"{', '.join(f'{t:.4f}' for t in ms[name][dt])} ms "
                  f"({flops / min(ms[name][dt]) / 1e9:.1f} T(FL)OP/s)")
    a, b = ops["bf16"]
    a_tall = torch.randn((N + 128, N), generator=gen).bfloat16().to(dev)
    waves = {}
    for label, lhs in ((f"M={N}", a), (f"M={N + 128}", a_tall)):
        tiles = (lhs.shape[0] // 128) * (N // 256)
        t = _ms(lambda: mp.mm_probe(lhs, b), args.steps, args.repeats)
        waves[label] = t / tiles
        print(f"P2 bf16 {label} N = K = {N}: {tiles} tiles, {t:.4f} ms, "
              f"{1e3 * t / tiles:.3f} us per tile")
    clocks = _clocks_while(lambda: mp.mm_probe(a, b), 1.0)
    print(f"P2 bf16 running: SM clock, power draw {clocks}")
    return {"ms": ms, "waves": waves, "clocks": clocks}


if __name__ == "__main__":
    main()
