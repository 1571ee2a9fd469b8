"""Where the training kernel (K2, ``csrc/fused_model_bwd.cu``) spends its
time, phase by phase; with ``--forward`` the forward kernel (K3f,
``csrc/fused_model_fwd.cu``), which runs the same forward phases.

The tool builds a copy of the kernel's source under
``build/k2_phases/`` with the compile-time define ``CGR_PHASE_CLOCK``.
Under that define thread 0 of block 0 stamps ``%globaltimer`` into a small
device buffer as each phase of the step ends: in the shipped kernel, after
each grid barrier, so a phase's time is the card's, every block included.
The shipped build carries no stamp: the define is only ever passed here.
The phases, in the order the kernel runs them (``PHASES``, the table of
``csrc/fused_model_grid.cuh``; ``[l]`` marks the per-layer ones; K3f runs
the first six, without the mean scales):

    edge_init             the replay's edge_init tiles, and the mean scales
    gather[l]             messages t_l of conv layer l
    conv[l]               t_l·Wc[l] with bias, skip, activation, dropout
    readout gather        the incoming sum s
    readout               s·Ws + x·Wxn
    pool+head             the pooled rows and the predictions
    pool adjoint          dpred, the SSE and head gradients, dpre_n
    readout grads         dWxn, dben and ds = dpre_n·Wsᵀ
    adjoint+act[l]        the cotangent of layer l's output (the incoming
                          or message adjoint), dropout and activation:
                          dpre_l, dh0, column and skip partials; beside
                          them dWc[l+1] (dWs at the last layer)
    dt[l]                 dt = dpre_l·Wc[l]ᵀ, dbc[l], dskips[l]
    edge_init adjoint     dpre0, beside dWc[0]
    edge_init grads       dWx, dWe, dbe
    pack sum              the pack partials summed in pack order

It times K2 (train mode, dropout 0.1) or K3f (eval mode, as it serves)
at ``--small`` graphs (p = 4 packs, as a training or request batch) and
``--graphs`` graphs (436 packs) of the README model (depth 4, hidden 400,
270 node features, ReLU; te=256/tn=128/tb=16), at f32 and bf16, through
the shipped build and the stamped one, whose outputs must be equal bit
for bit: K2's SSE and gradients and K3b's gradients on the same inputs,
or K3f's predictions.  It prints the shipped build's time (CUDA events,
mean of ``--repeats`` calls), the stamped build's, and per phase the
median over ``--repeats`` calls of its ms and share of the stamped span.

``--source`` stamps another copy of the kernel with the same C interface
(a file whose directory holds its headers; its phase names come from its
own table), for example the parent commit's: the line then names the
outputs that equal the shipped build's bit for bit.  :func:`variant`
builds a source with other defines, for example ``CGR_GRID_BLOCKS`` (a
smaller grid; the results must not change).

  python -m cgr_mpnn_3d_tpu_torch.tools.k2_phases [--forward] [--small 20]
      [--graphs 2500] [--repeats 5] [--source FILE]

Needs the card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

__all__ = ["main", "variant", "phase_names", "read_stamps", "DEFINE",
           "PHASES"]

DEFINE = "CGR_PHASE_CLOCK"
# the shipped kernels' phase table (kPhaseNames in fused_model_grid.cuh)
PHASES = ("start", "edge_init", "gather", "conv", "readout gather",
          "readout", "pool+head", "pool adjoint", "readout grads",
          "adjoint+act", "dt", "edge_init adjoint", "edge_init grads",
          "pack sum")
_MAX_STAMPS = 256     # kMaxStamps in the source
_NO_LAYER = 255       # the layer of a stamp outside the conv layers


def variant(defines: dict, source: Path | None = None) -> ctypes.CDLL:
    """``csrc/fused_model_bwd.cu`` (or ``source``, any kernel source)
    built with ``defines`` ({name: value or None}) under
    build/k2_phases/."""
    from ..ops import _build
    src = Path(source) if source else _build.CSRC / "fused_model_bwd.cu"
    flags = [f"-D{k}" if v is None else f"-D{k}={v}"
             for k, v in sorted(defines.items())]
    headers = b"".join(h.read_bytes() for h in
                       sorted(src.parent.glob("*.cuh")))
    tag = hashlib.sha1(src.read_bytes() + headers
                       + " ".join(flags).encode()).hexdigest()[:12]
    out = _build.BUILD_DIR / "k2_phases"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"lib{src.stem}-{tag}.so"
    if not lib.exists():
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags,
                              "-I", str(src.parent), "-o", str(lib),
                              str(src)], capture_output=True, text=True,
                             timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src} with {flags}:\n"
                               f"{res.stdout}{res.stderr}")
    return ctypes.CDLL(str(lib))


def phase_names(lib) -> list[str]:
    """The phase table of a stamped build, in id order."""
    lib.cgr_phase_name.argtypes = [ctypes.c_int]
    lib.cgr_phase_name.restype = ctypes.c_char_p
    names: list[str] = []
    while (n := lib.cgr_phase_name(len(names))) is not None:
        names.append(n.decode())
    return names


def read_stamps(lib) -> list[tuple[str, int, int]]:
    """[(phase, layer, ns)] of the last launch of a stamped build."""
    lib.cgr_phase_clock_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_int]
    lib.cgr_phase_clock_read.restype = ctypes.c_int
    names = phase_names(lib)
    ns = np.zeros(_MAX_STAMPS, np.int64)
    ids = np.zeros(_MAX_STAMPS, np.int32)
    n = lib.cgr_phase_clock_read(ns.ctypes.data, ids.ctypes.data,
                                 _MAX_STAMPS)
    if n < 0:
        raise RuntimeError(f"reading the phase clock failed ({n})")
    return [(names[int(i) // 256], int(i) % 256, int(t))
            for i, t in zip(ids[:n], ns[:n])]


def _case(n_graphs: int, seed: int, dev, mat_dtype: str, forward: bool):
    """(p, the timed call, the compared call) on a seeded synthetic batch
    of the README model: K2 in train mode, compared with K3b beside it, or
    K3f in eval mode.  The compared call returns {name: tensor}."""
    from ..data import (pack_graphs, packs_needed, place_graphs, plan_spec,
                        to_device)
    from ..data.synthetic import synthetic_graphs
    from ..models import (CGRMPNNConfig, adjoint_inputs, init_params,
                          kernel_inputs, kernel_seeds)
    from ..ops import fused_model as fm
    graphs = synthetic_graphs(n_graphs, np.random.default_rng(seed),
                              node_feat_dim=270, edge_feat_dim=14)
    spec = plan_spec(graphs, te=256, tn=128, tb=16)
    p = packs_needed(graphs, spec)
    while not place_graphs(graphs, spec.with_packs(p)):
        p += max(1, p // 20)
    spec = spec.with_packs(p)
    batch = to_device(pack_graphs(graphs, [0.0] * n_graphs, spec), dev)
    cfg = CGRMPNNConfig(num_node_features=270, num_edge_features=14,
                        depth=4, hidden_sizes=(400,) * 4,
                        dropout_ps=(0.1,) * 4, activation="ReLU")
    gen = torch.Generator().manual_seed(seed)
    model = init_params(cfg, gen, dev)
    labels = (torch.randn(batch.graph_mask.shape, generator=gen) * 10).to(dev)
    with torch.no_grad():
        args = kernel_inputs(model, batch)
    if forward:
        def fwd():
            return fm.fused_model_forward(*args, p=p, act="relu",
                                          mat_dtype=mat_dtype)
        return p, fwd, lambda: {"preds": fwd()}
    adj = adjoint_inputs(batch)
    mask = batch.graph_mask
    kw = dict(p=p, act="relu", aggr="add", pooling="add", train=True,
              seeds=kernel_seeds(cfg, gen).tolist(), dropout_ps=(0.1,) * 4,
              mat_dtype=mat_dtype)

    def call():
        return fm.fused_model_train(args, adj, labels, mask, **kw)

    def outputs():
        sse, grads = call()
        vjp = fm.fused_model_vjp(args, adj, labels * mask, **kw)
        return {"sse": sse, **dict(zip(fm.GRAD_NAMES, grads)),
                **{f"K3b {n}": g for n, g in zip(fm.GRAD_NAMES, vjp)}}
    return p, call, outputs


def _ms(fn, n: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _label(name: str, layer: int) -> str:
    return name if layer == _NO_LAYER else f"{name}[{layer}]"


def main(argv=None) -> dict:
    """Time the phases; returns {case: {"p", "ms", "stamped_ms", "equal",
    "equal_outputs", "phases": {phase: ms}, "span_ms"}} with case
    "<dtype> p=<packs>"."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--forward", action="store_true",
                    help="time K3f (fused_model_fwd.cu) instead of K2")
    ap.add_argument("--small", type=int, default=20)
    ap.add_argument("--graphs", type=int, default=2500)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--source", default=None)
    args = ap.parse_args(argv)

    from ..ops import _build
    from ..utils.device import resolve_device
    dev = resolve_device("cuda")
    name = "fused_model_fwd" if args.forward else "fused_model_bwd"
    what = "K3f" if args.forward else "K2"
    shipped = _build.load(name)
    stamped = variant({DEFINE: None},
                      args.source or _build.CSRC / f"{name}.cu")
    names = phase_names(stamped)
    if args.source is None and tuple(names) != PHASES:
        raise RuntimeError(f"the source's phase table {names} is not "
                           f"PHASES {PHASES}")
    out: dict = {}
    try:
        for md in ("float32", "bfloat16"):
            for n_graphs, seed in ((args.small, args.seed + 1),
                                   (args.graphs, args.seed)):
                p, call, outputs = _case(n_graphs, seed, dev, md,
                                         args.forward)
                key = f"{md} p={p}"
                res: dict = {"p": p}
                got = {}
                for build, lib in (("shipped", shipped), ("stamped", stamped)):
                    _build._libs[name] = lib
                    with torch.no_grad():
                        got[build] = outputs()
                        res[f"{build}_ms"] = _ms(call, args.repeats)
                res["equal_outputs"] = [
                    n for n, t in got["shipped"].items()
                    if torch.equal(t, got["stamped"][n])]
                res["equal"] = len(res["equal_outputs"]) == len(
                    got["shipped"])
                res["ms"] = res.pop("shipped_ms")
                runs = []
                for _ in range(args.repeats):
                    with torch.no_grad():
                        call()
                    torch.cuda.synchronize()
                    runs.append(read_stamps(stamped))
                _build._libs[name] = shipped
                per_run = []
                for stamps in runs:
                    ms: dict = {}
                    for (_, _, t0), (phase, layer, t1) in zip(stamps,
                                                              stamps[1:]):
                        key_l = _label(phase, layer)
                        ms[key_l] = ms.get(key_l, 0.0) + (t1 - t0) / 1e6
                    per_run.append(ms)
                res["phases"] = {k: statistics.median(r[k] for r in per_run)
                                 for k in per_run[0]}
                res["span_ms"] = statistics.median(
                    (s[-1][2] - s[0][2]) / 1e6 for s in runs)
                out[key] = res
                print(f"{what} {key}: shipped {res['ms']:.4f} ms, stamped "
                      f"{res['stamped_ms']:.4f} ms (stamped span "
                      f"{res['span_ms']:.4f} ms), outputs equal: "
                      f"{res['equal']}" + (
                          "" if args.source is None else
                          f" (equal bit for bit: "
                          f"{', '.join(res['equal_outputs'])})"))
                print(f"{what} {key} phases (ms, share of the span): "
                      + "; ".join(f"{k} {v:.4f} ({v / res['span_ms']:.3f})"
                                  for k, v in res["phases"].items()))
    finally:
        _build._libs[name] = shipped
    return out


if __name__ == "__main__":
    main()
