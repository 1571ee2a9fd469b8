"""Where the host time of the ELL gather-sum's wrapper (K7,
``ops/onehot_spmm.py``) goes, step by step.

Each step of one call of the wrapper is run alone ``--calls`` times
between two ``time.perf_counter_ns`` reads, on the inputs of the layered
pooling at p = 4 (20 seeded synthetic graphs packed at te 256 / tn 128 /
tb 16 into 4 packs, H 400), at f32 and bf16; then the whole call
(``onehot_spmm``, no gradient) and ``embedding_bag`` over the same sum,
the library call that computes it.  The steps of the wrapper as it stands:

    check       the one-pass check of the tensors (``_fits``)
    allocation  the output
    pointers    the pointers, the stream and the current device
    kernel      the typed launch function of the current build
    launch      the C call that launches the kernel (no Python around it)

A wrapper from before the one-pass check (its ``_launch`` ran ``_check``,
``check_cuda``, ``library()``, a ``torch.cuda.device`` context and
``stream()`` around the C call) is timed by the same tool with that
wrapper's steps (``check``, ``cuda check``, ``allocation``, ``library``,
``device context``, ``stream``, ``launch``), so the two splits can be set
side by side: ``--parent DIR`` loads that commit's wrapper from
``DIR/../ops/onehot_spmm.py`` (its package unpacked whole by ``git
archive``) and builds ``DIR/onehot_spmm.cu`` under build/k2_phases/.
Times are µs per call, the least mean of five runs; the steps' sum is
below the whole call by the Python calls between them.

  python -m cgr_mpnn_3d_tpu_torch.tools.k7_host [--calls 2000] [--parent DIR]

Needs the card.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
import time
from pathlib import Path

import torch

__all__ = ["main", "split", "parent_module", "library_call"]


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


def _steps(sp, src, idx, sign, p: int, mat_dtype: str) -> dict:
    """{step: a call of that step alone} for the wrapper module ``sp``."""
    from ..ops._launch import check_cuda, library, ptr, stream
    dev = src.device
    (R, D), (C, W) = idx.shape, src.shape
    mat = int(mat_dtype == "bfloat16")
    if not hasattr(sp, "_run"):             # the earlier wrapper
        lib = library("onehot_spmm", sp._SIGNATURES)
        out = torch.empty((R, W), device=dev, dtype=torch.float32)
        args = dict(src=src, idx=idx)
        if sign is not None:
            args["sign"] = sign
        st = stream(dev)

        def device_context():
            with torch.cuda.device(dev):
                pass
        return {
            "check": lambda: sp._check(src, idx, sign, p, mat_dtype),
            "cuda check": lambda: check_cuda(args, dev, {"idx", "sign"},
                                             sp._types(mat_dtype)),
            "allocation": lambda: torch.empty((R, W), device=dev,
                                              dtype=torch.float32),
            "library": lambda: library("onehot_spmm", sp._SIGNATURES),
            "device context": device_context,
            "stream": lambda: stream(dev),
            "launch": lambda: lib.cgr_onehot_spmm(
                src.data_ptr(), idx.data_ptr(), ptr(sign), out.data_ptr(),
                p, R // p, C // p, W, D, mat,
                int(src.dtype == torch.bfloat16), st)}
    fn = sp._kernel()
    out = src.new_empty((R, W), dtype=torch.float32)
    index = dev.index

    def pointers():
        return ((src.data_ptr(), idx.data_ptr(),
                 None if sign is None else sign.data_ptr(), out.data_ptr()),
                torch._C._cuda_getCurrentRawStream(index),
                torch._C._cuda_getDevice())
    (ps, st, _) = pointers()
    return {
        "check": lambda: sp._fits(src, idx, sign, p, mat),
        "allocation": lambda: src.new_empty((R, W), dtype=torch.float32),
        "pointers": pointers,
        "kernel": sp._kernel,
        "launch": lambda: fn(*ps, p, R // p, C // p, W, D, mat,
                             src.dtype == torch.bfloat16, False, st)}


def library_call(src, idx, sign, p: int, mat_dtype: str):
    """embedding_bag's call for the same sum (ids outside the pack sent to
    an appended zero row; the sign row with weight -1; at bf16 on the
    bf16-rounded source), its inputs made once."""
    from ..ops.segment import ext_zero_row, in_pack
    ext = ext_zero_row(src.to(torch.bfloat16) if mat_dtype == "bfloat16"
                       else src)
    ids = in_pack(idx, p, src.shape[0])[0]
    bag = torch.nn.functional.embedding_bag
    if sign is None:
        return lambda: bag(ids, ext, mode="sum")
    ids = torch.cat([ids, in_pack(sign, p, src.shape[0])[0][:, None]], 1)
    w = torch.ones(ids.shape, device=src.device, dtype=ext.dtype)
    w[:, -1] = -1
    return lambda: bag(ids, ext, mode="sum", per_sample_weights=w)


def split(sp, src, idx, sign, p: int, mat_dtype: str, calls: int) -> dict:
    """{step: µs per call} of the wrapper module ``sp``'s steps, "whole
    call" (``onehot_spmm``, no gradient) and "embedding_bag" on these
    inputs."""
    out = {name: _us(fn, calls) for name, fn in
           _steps(sp, src, idx, sign, p, mat_dtype).items()}

    def whole():
        with torch.no_grad():
            sp.onehot_spmm(src, idx, sign, p=p, mat_dtype=mat_dtype)
    out["whole call"] = _us(whole, calls)
    out["embedding_bag"] = _us(library_call(src, idx, sign, p, mat_dtype),
                               calls)
    return out


def parent_module(parent: Path):
    """An earlier commit's ops/onehot_spmm.py (``parent`` its csrc/,
    unpacked beside its ops/), loaded under a name of its own inside the
    shipped ops package (its relative imports reach the shipped helpers)."""
    name = "cgr_mpnn_3d_tpu_torch.ops._k7_host_parent"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, Path(parent).resolve().parent / "ops" / "onehot_spmm.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def _through(lib, fn):
    """fn() with ``lib`` as the wrappers' build of csrc/onehot_spmm.cu."""
    from ..ops import _build
    shipped = _build.load("onehot_spmm")
    _build._libs["onehot_spmm"] = lib
    try:
        return fn()
    finally:
        _build._libs["onehot_spmm"] = shipped


def main(argv=None) -> dict:
    """Print and return {"<wrapper> <dtype>": split} for the layered
    pooling at p = 4, f32 and bf16: the shipped wrapper, and with
    ``--parent`` the earlier commit's through its own build."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", type=Path, default=None,
                    help="csrc/ of an earlier commit's package")
    args = ap.parse_args(argv)
    import numpy as np

    from ..data import pack_graphs, plan_spec, to_device
    from ..data.synthetic import synthetic_graphs
    from ..ops import onehot_spmm as sp
    from ..utils.device import resolve_device
    from .k2_phases import variant
    dev = resolve_device("cuda")
    graphs = synthetic_graphs(20, np.random.default_rng(args.seed),
                              node_feat_dim=270)
    spec = plan_spec(graphs, te=256, tn=128, tb=16).with_packs(4)
    b = to_device(pack_graphs(graphs, [0.0] * len(graphs), spec), dev)
    gen = torch.Generator().manual_seed(args.seed)
    hn = torch.randn((b.node_x.shape[0], 400), generator=gen).to(dev)
    wrappers = {"shipped": (sp, None)}
    if args.parent is not None:
        wrappers["parent"] = (parent_module(args.parent),
                              variant({}, args.parent / "onehot_spmm.cu"))
    res = {}
    for name, (mod, lib) in wrappers.items():
        for md in ("float32", "bfloat16"):
            def run(mod=mod, md=md):
                return split(mod, hn, b.graph_nodes, None, spec.p, md,
                             args.calls)
            key = f"{name} {md}"
            res[key] = run() if lib is None else _through(lib, run)
            print(f"K7 wrapper host split, {key}, pool of p = {spec.p} "
                  f"(µs per call): " + "; ".join(
                      f"{k} {v:.3f}" for k, v in res[key].items()))
    return res


if __name__ == "__main__":
    main()
