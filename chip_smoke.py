#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``cgr_mpnn_3d_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed 0] [--graphs 2500]

Phases (any failure raises, and the script exits non-zero):

1. the card's name and power limit (nvidia-smi);
2. build every CUDA source under ``cgr_mpnn_3d_tpu_torch/csrc`` with nvcc
   (one process per source, all started together);
3. the whole-model forward kernel against its plain PyTorch version (TF32
   off) at full width -- depth 4, hidden 400, F = 78 CGR + 192 descriptor
   features, Fe = 14, ReLU, add/add -- on a seeded synthetic batch of
   ``--graphs`` graphs packed at te=256/tn=128/tb=16, and at small width for
   SiLU and GELU with mean aggregation and mean pooling; times of both and
   the kernel's f32 bound;
4. serving: a seeded full-width checkpoint in the ``.npz`` + JSON format
   serves ``examples/demo.csv`` (with synthetic descriptors) through
   ``activation_energy_prediction(device="cuda")`` once as a batch and as 10
   single-reaction requests; the launch count of the kernel must rise, and
   the predictions must match the same entry point with ``device="cpu"``;
   request latency and served graphs/s;
5. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": {...}}`` as
   the last line.

It exits non-zero, printing no result, without CUDA or without the package
beside it.
"""

from __future__ import annotations

import argparse
import csv
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
REL_TOL = 1e-4          # max |kernel - plain| / max |plain|, f32, TF32 off
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores (data sheet)
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes/s (data sheet)
DEVICE = "cuda"


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def rel_err(got, ref, mask) -> tuple[float, float]:
    got, ref = got[mask], ref[mask]
    abs_err = float((got - ref).abs().max())
    return abs_err, abs_err / max(float(ref.abs().max()), 1e-30)


def time_ms(fn, n: int) -> float:
    """Mean ms of ``fn`` over ``n`` calls, with CUDA events."""
    import torch
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


def forward_cost(args) -> tuple[float, float]:
    """(operations, bytes) the forward needs on these inputs: the dense
    products' FMAs (2 ops each) and the gather-sum adds over real rows --
    padding rows feed no prediction -- and every input read once plus the
    predictions written once.  The x part of edge_init is counted once per
    node, since x[senders]·Wx = (x·Wx)[senders]."""
    (x, e, senders, edge_nbr, _rev, node_inc, graph_nodes, *_w) = args
    NT, F = x.shape
    ET, Fe = e.shape
    BT = graph_nodes.shape[0]
    L, H = args[10].shape[0], args[10].shape[2]
    E = int((senders < NT).sum())
    N = int((graph_nodes < NT).sum())
    B = int((graph_nodes < NT).any(dim=1).sum())
    dense = (2 * N * F * H + 2 * E * Fe * H + L * 2 * E * H * H
             + 2 * N * (F + H) * H + 2 * B * H)
    adds = (L * (int((edge_nbr < ET).sum()) + E) * H
            + int((node_inc < ET).sum()) * H
            + int((graph_nodes < NT).sum()) * H)
    nbytes = sum(t.numel() * t.element_size() for t in args) + BT * 4
    return float(dense + adds), float(nbytes)


def synthetic_batch(n_graphs: int, seed: int, F: int, Fe: int, device):
    """Seeded synthetic graphs packed at te=256/tn=128/tb=16 into the
    fewest packs that hold them."""
    from cgr_mpnn_3d_tpu_torch.data import (pack_graphs, packs_needed,
                                            place_graphs, plan_spec,
                                            to_device)
    from cgr_mpnn_3d_tpu_torch.data.synthetic import synthetic_graphs
    graphs = synthetic_graphs(n_graphs, np.random.default_rng(seed),
                              node_feat_dim=F, edge_feat_dim=Fe)
    spec = plan_spec(graphs, te=256, tn=128, tb=16)
    p = packs_needed(graphs, spec)
    while not place_graphs(graphs, spec.with_packs(p)):
        p += max(1, p // 20)
    spec = spec.with_packs(p)
    batch = pack_graphs(graphs, [0.0] * n_graphs, spec)
    return spec, to_device(batch, device)


def corpus_batch(tmp: Path, seed: int, device):
    """The first request batch (64 rows, p = 4 packs) that predict() makes
    of the 300-reaction corpus with synthetic descriptors."""
    from cgr_mpnn_3d_tpu_torch.data import (ChemDataset, PackedLoader,
                                            plan_spec, to_device)
    from cgr_mpnn_3d_tpu_torch.data.descriptors import \
        synthetic_descriptors_npz
    corpus = ROOT / "tests" / "corpus_reactions.csv"
    synthetic_descriptors_npz(corpus, tmp / "corpus.npz", 64, seed=seed)
    ds = ChemDataset(str(corpus), data_npz_path=str(tmp / "corpus.npz"))
    ds.prefeaturize()
    spec = plan_spec([ds.graph(i) for i in range(len(ds))])
    loader = PackedLoader(ds, spec, batch_size=64)
    return loader.spec, to_device(next(iter(loader)), device)


def kernel_vs_plain(cfg_kw: dict, spec, batch, seed: int,
                    repeats: int) -> dict:
    """Kernel and plain version on one batch with seeded weights: errors,
    and with ``repeats`` their times (plain, kernel, kernel, plain)."""
    import torch
    from cgr_mpnn_3d_tpu_torch.models import (CGRMPNNConfig, init_params,
                                              kernel_inputs)
    from cgr_mpnn_3d_tpu_torch.models.cgr_mpnn import ACTIVATIONS
    from cgr_mpnn_3d_tpu_torch.ops.fused_model import (
        fused_model_forward, fused_model_forward_ref)
    cfg = CGRMPNNConfig(**cfg_kw)
    gen = torch.Generator().manual_seed(seed)
    model = init_params(cfg, gen, batch.node_x.device).eval()
    if cfg.use_learnable_skip:
        with torch.no_grad():
            for w in model.skip_weights:
                w.copy_(torch.rand((), generator=gen) * 2.0 - 0.5)
    kw = dict(p=spec.p, act=ACTIVATIONS[cfg.activation], aggr=cfg.aggr,
              pooling=cfg.pooling)
    with torch.no_grad():
        args = kernel_inputs(model, batch)
        got = fused_model_forward(*args, **kw)
        ref = fused_model_forward_ref(*args, **kw)
        torch.cuda.synchronize()
        mask = batch.graph_mask > 0
        check(bool(torch.isfinite(got[mask]).all()),
              "kernel predictions are not finite")
        abs_err, rel = rel_err(got, ref, mask)
        out = dict(p=spec.p, graphs=int(mask.sum()), abs_err=abs_err,
                   rel_err=rel)
        if repeats:
            plain = [time_ms(lambda: fused_model_forward_ref(*args, **kw),
                             repeats)]
            kern = [time_ms(lambda: fused_model_forward(*args, **kw),
                            repeats) for _ in range(2)]
            plain.append(time_ms(lambda: fused_model_forward_ref(*args, **kw),
                                 repeats))
            ops, nbytes = forward_cost(args)
            t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
            out.update(ms=statistics.mean(kern), plain_ms=statistics.mean(plain),
                       ops=ops, bytes=nbytes,
                       bound_ms=max(t_ops, t_bytes) * 1e3,
                       bound_by="operations" if t_ops >= t_bytes else "bytes")
    check(rel <= REL_TOL, f"kernel vs plain relative error {rel:.3e} > "
                          f"{REL_TOL} for {cfg_kw}")
    return out


def device_busy(fn) -> tuple[float, float, list]:
    """(wall ms, device busy ms, top three (kernel, ms)) of one call of
    ``fn`` under torch.profiler; device busy is the sum of the CUDA kernel
    and copy times it records."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [(e.key, e.self_device_time_total / 1e3)
           for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev.sort(key=lambda kv: -kv[1])
    return (wall * 1e3, sum(ms for _, ms in dev),
            [(k[:40], round(ms, 3)) for k, ms in dev[:3]])


def full_width_meta() -> dict:
    return {"name": "CGR-MPNN-3D",
            "model": {"num_node_features": 270, "num_edge_features": 14,
                      "depth": 4, "hidden_sizes": [400] * 4,
                      "dropout_ps": [0.0] * 4, "activation": "ReLU",
                      "aggr": "add", "pooling": "add",
                      "use_learnable_skip": False}}


def serve(tmp: Path, seed: int, card: str) -> dict:
    """Drive the serving entry point: a batch request and 10 single
    requests of the demo set on the card, checked against the CPU; then
    served graphs/s on the corpus (its npz made by corpus_batch)."""
    import torch
    from cgr_mpnn_3d_tpu_torch.cli.predict import activation_energy_prediction
    from cgr_mpnn_3d_tpu_torch.data.descriptors import \
        synthetic_descriptors_npz
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNNConfig, init_params
    from cgr_mpnn_3d_tpu_torch.ops import fused_model as fm
    from cgr_mpnn_3d_tpu_torch.train import save_checkpoint

    meta = full_width_meta()
    cfg = CGRMPNNConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                           for k, v in meta["model"].items()})
    model = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    ckpt = save_checkpoint(tmp / "CGR-MPNN-3D.npz", model, meta)

    demo = ROOT / "examples" / "demo.csv"
    npz = tmp / "demo.npz"
    synthetic_descriptors_npz(demo, npz, 64, seed=seed)
    with open(demo, newline="") as f:
        header, *rows = list(csv.reader(f))
    singles = []
    with np.load(npz) as z:
        for i, row in enumerate(rows):
            path = tmp / f"request_{i}.csv"
            with open(path, "w", newline="") as f:
                csv.writer(f).writerows([header, row])
            np.savez(tmp / f"request_{i}.npz", z[f"arr_{i}"])
            singles.append((path, tmp / f"request_{i}.npz"))

    def request(csv_path, npz_path, device):
        t0 = time.perf_counter()
        res = activation_energy_prediction(
            str(csv_path), output_results=str(tmp / "results.txt"),
            model_path=str(ckpt), npz_path=str(npz_path), device=device)
        torch.cuda.synchronize()
        return (np.array([r["Activation Energy"] for r in res]),
                time.perf_counter() - t0)

    # the main path: counts are zeroed just before it and read just after
    fm.launches = 0
    batch_pred, batch_s = request(demo, npz, DEVICE)
    single = [request(c, n, DEVICE) for c, n in singles]
    launches = fm.launches
    check(launches > 0, "the serving path launched no forward kernel")

    cpu_pred, _ = request(demo, npz, "cpu")
    single_pred = np.concatenate([s[0] for s in single])
    check(batch_pred.shape == (len(rows),) and np.isfinite(batch_pred).all(),
          "batch predictions are not finite or have the wrong shape")
    scale = max(float(np.abs(cpu_pred).max()), 1e-30)
    err_batch = float(np.abs(batch_pred - cpu_pred).max()) / scale
    err_single = float(np.abs(single_pred - cpu_pred).max()) / scale
    check(err_batch <= REL_TOL and err_single <= REL_TOL,
          f"card vs CPU predictions differ: batch {err_batch:.3e}, "
          f"single {err_single:.3e}")
    latency_ms = statistics.median(s[1] for s in single) * 1e3
    print(f"serve demo: {len(rows)} reactions, batch request "
          f"{batch_s * 1e3:.3f} ms, single-request latency median "
          f"{latency_ms:.3f} ms over {len(single)}, kernel launches "
          f"{launches}, rel err vs CPU batch {err_batch:.3e} single "
          f"{err_single:.3e} [{card}]")

    # served graphs/s on a larger request: the 300-reaction corpus
    corpus = ROOT / "tests" / "corpus_reactions.csv"
    fm.launches = 0
    runs = [request(corpus, tmp / "corpus.npz", DEVICE) for _ in range(3)]
    corpus_launches = fm.launches // len(runs)
    n = len(runs[0][0])
    check(all(np.isfinite(r[0]).all() for r in runs),
          "corpus predictions are not finite")
    wall = statistics.median(r[1] for r in runs)
    print(f"serve corpus: {n} reactions in one request, {corpus_launches} "
          f"kernel launches per request, wall "
          f"{[round(r[1] * 1e3, 3) for r in runs]} ms, median "
          f"{n / wall:.1f} graphs/s [{card}]")

    # where a request's time goes: the entry point's stages on the host ...
    from cgr_mpnn_3d_tpu_torch.data import ChemDataset, plan_spec
    from cgr_mpnn_3d_tpu_torch.train import load_model, predict
    c, z = singles[0]
    t0 = time.perf_counter()
    model, _, _ = load_model(ckpt, DEVICE)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ds = ChemDataset(str(c), data_npz_path=str(z))
    ds.prefeaturize()
    t2 = time.perf_counter()
    predict(model, ds, plan_spec([ds.graph(0)]), 64, DEVICE)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    print(f"single request stages: load_model {(t1 - t0) * 1e3:.3f} ms, "
          f"read + featurize {(t2 - t1) * 1e3:.3f} ms, predict (pack, "
          f"transfer, kernel, copy back) {(t3 - t2) * 1e3:.3f} ms [{card}]")
    # ... and device busy time under torch.profiler
    for name, (c, z) in (("single", singles[0]),
                         ("corpus", (corpus, tmp / "corpus.npz"))):
        wall_ms, dev_ms, top = device_busy(lambda: request(c, z, DEVICE))
        print(f"profile {name} request: wall {wall_ms:.3f} ms, device busy "
              f"{dev_ms:.3f} ms ({100 * dev_ms / wall_ms:.1f}%), top device "
              f"time {top} [{card}]")
    return dict(launches=launches, latency_ms=latency_ms,
                graphs_per_s=n / wall)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--graphs", type=int, default=2500)
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        import cgr_mpnn_3d_tpu_torch
        from cgr_mpnn_3d_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1
    pkg = Path(cgr_mpnn_3d_tpu_torch.__file__).resolve().parent
    check(pkg.parent == ROOT, f"imported the port from {pkg}, not {ROOT}")

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: matmul False, cudnn False")

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {len(libs)} CUDA sources in "
          f"{time.perf_counter() - t0:.3f} s")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {name}: {line.strip()}")

    dev = torch.device(DEVICE)
    full = dict(num_node_features=270, num_edge_features=14, depth=4,
                hidden_sizes=(400,) * 4, dropout_ps=(0.0,) * 4,
                activation="ReLU")
    spec, batch = synthetic_batch(args.graphs, args.seed, 270, 14, dev)
    main_k = kernel_vs_plain(full, spec, batch, args.seed, args.repeats)
    print(f"fused_model_fwd full width: {main_k['graphs']} synthetic graphs "
          f"in {main_k['p']} packs, max abs err {main_k['abs_err']:.3e}, rel "
          f"{main_k['rel_err']:.3e}; kernel {main_k['ms']:.4f} ms, plain "
          f"{main_k['plain_ms']:.4f} ms, f32 bound {main_k['bound_ms']:.4f} "
          f"ms ({main_k['ops'] / 1e9:.3f} GFLOP, "
          f"{main_k['bytes'] / 1e6:.3f} MB) [{card}]")
    for act in ("SiLU", "GELU"):
        small = dict(num_node_features=78, num_edge_features=14, depth=3,
                     hidden_sizes=(40,) * 3, dropout_ps=(0.0,) * 3,
                     activation=act, aggr="mean", pooling="mean",
                     use_learnable_skip=True)
        spec, batch = synthetic_batch(200, args.seed + 1, 78, 14, dev)
        k = kernel_vs_plain(small, spec, batch, args.seed + 1, 0)
        print(f"fused_model_fwd small width {act} mean/mean learnable skip: "
              f"{k['graphs']} graphs, max abs err {k['abs_err']:.3e}, rel "
              f"{k['rel_err']:.3e}")

    with tempfile.TemporaryDirectory() as tmp:
        spec, batch = corpus_batch(Path(tmp), args.seed, dev)
        req_k = kernel_vs_plain(full, spec, batch, args.seed, args.repeats)
        print(f"fused_model_fwd request batch: {req_k['graphs']} corpus "
              f"reactions in {req_k['p']} packs, rel err "
              f"{req_k['rel_err']:.3e}; kernel {req_k['ms']:.4f} ms, plain "
              f"{req_k['plain_ms']:.4f} ms, f32 bound "
              f"{req_k['bound_ms']:.4f} ms [{card}]")
        srv = serve(Path(tmp), args.seed, card)

    print(json.dumps({"kernels": [{
        "name": "fused_model_fwd", "route": "cuda",
        "source": "cgr_mpnn_3d_tpu_torch/csrc/fused_model_fwd.cu",
        "replaces": "cgr_mpnn_3d_tpu/ops/pallas_model.py:376",
        "launches": srv["launches"], "max_abs_err": main_k["abs_err"],
        "ms": main_k["ms"], "plain_ms": main_k["plain_ms"],
        "bound_ms": main_k["bound_ms"], "bound_by": main_k["bound_by"],
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
