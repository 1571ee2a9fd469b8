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
4. the training kernels against their plain versions (TF32 off): the
   forward in train mode, the training step (K2) and the VJP (K3b), at full
   width with dropout 0.1 on the synthetic batch and on the first training
   batch of the corpus, and at small width for SiLU and GELU with mean/mean
   and learnable skips; times and f32 bounds;
5. serving: a seeded full-width checkpoint in the ``.npz`` + JSON format
   serves ``examples/demo.csv`` (with synthetic descriptors) through
   ``activation_energy_prediction(device="cuda")`` once as a batch and as 10
   single-reaction requests; the launch count of the kernel must rise, and
   the predictions must match the same entry point with ``device="cpu"``;
   request latency and served graphs/s;
6. training: ``cli.train.main`` with the README's model and flags, 3 epochs
   on the 300-reaction corpus (synthetic descriptors) on the card, then 2 on
   the CPU; the per-epoch RMSEs must agree, every training step must be one
   launch of the training kernel, and the gradient histograms must go
   through the VJP kernel; then a resumed run (1 epoch, resume, 2nd epoch)
   must equal a straight 2-epoch run bit for bit; steps/s and the card's
   busy share of a training step under torch.profiler;
7. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": {...}}`` as
   the last line.

It exits non-zero, printing no result, without CUDA or without the package
beside it.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import shutil
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
TRAIN_TOL = 1e-3        # card vs CPU per-epoch RMSE, relative
README_FLAGS = ["--name", "CGR-MPNN-3D", "-d", "4", "--hidden_sizes", "400",
                "--dropout_ps", "0.1", "-af", "ReLU", "-lr", "1e-4",
                "--weight_decay", "1e-5", "-bs", "64", "-g", "0.9"]


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


def train_cost(args, adjoint) -> tuple[float, float]:
    """(operations, bytes) one training step's compute needs on these
    inputs: the replayed forward (forward_cost), then over the real rows the
    cotangents through the weights (ds, and dt for every conv layer), each
    weight gradient once -- the x part of dWx once per node, as in the
    forward -- and the transposed gathers (dh: as many adds as the
    forward's gathers).  The graph inputs take no gradient.  Bytes: the
    inputs, the adjoint indices, labels and mask read once, the gradients
    and the SSE written once."""
    ops, nbytes = forward_cost(args)
    (x, e, senders, edge_nbr, _rev, node_inc, graph_nodes, *_w) = args
    NT, F = x.shape
    ET, Fe = e.shape
    BT = graph_nodes.shape[0]
    L, H = args[10].shape[0], args[10].shape[2]
    E = int((senders < NT).sum())
    N = int((graph_nodes < NT).sum())
    B = int((graph_nodes < NT).any(dim=1).sum())
    dense = (4 * B * H + 4 * N * H * H + 4 * N * F * H + 4 * L * E * H * H
             + 2 * E * Fe * H)
    adds = (L * (int((edge_nbr < ET).sum()) + E) * H
            + int((node_inc < ET).sum()) * H
            + int((graph_nodes < NT).sum()) * H)
    nbytes += (sum(t.numel() * t.element_size() for t in adjoint) + BT * 4
               + sum(t.numel() for t in args[7:]) * 4 + 4)
    return float(ops + dense + adds), float(nbytes)


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


def corpus_batch(tmp: Path, seed: int, device, shuffle: bool = False):
    """The first request batch (64 rows, p = 4 packs) that predict() makes
    of the 300-reaction corpus with synthetic descriptors; with ``shuffle``
    the trainer's first batch of epoch 0 instead."""
    from cgr_mpnn_3d_tpu_torch.data import (ChemDataset, PackedLoader,
                                            plan_spec, to_device)
    from cgr_mpnn_3d_tpu_torch.data.descriptors import \
        synthetic_descriptors_npz
    corpus = ROOT / "tests" / "corpus_reactions.csv"
    synthetic_descriptors_npz(corpus, tmp / "corpus.npz", 64, seed=seed)
    ds = ChemDataset(str(corpus), data_npz_path=str(tmp / "corpus.npz"))
    ds.prefeaturize()
    spec = plan_spec([ds.graph(i) for i in range(len(ds))])
    loader = PackedLoader(ds, spec, batch_size=64, shuffle=shuffle,
                          seed=seed)
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


def _timed(entry: dict, kern, plain, repeats: int, cost) -> None:
    """Times of the kernel and its plain version (plain, kernel, kernel,
    plain) and the f32 bound of ``cost`` = (operations, bytes).  A plain
    version that takes longer than 0.1 s a call (autograd through the
    gathers at full width) is timed over fewer calls, at least 2."""
    import torch
    t0 = time.perf_counter()
    plain()
    torch.cuda.synchronize()
    n_plain = max(2, min(repeats, int(0.1 * repeats
                                      / (time.perf_counter() - t0))))
    p1 = time_ms(plain, n_plain)
    kern_ms = [time_ms(kern, repeats) for _ in range(2)]
    p2 = time_ms(plain, n_plain)
    t_ops, t_bytes = cost[0] / PEAK_F32_FLOPS, cost[1] / PEAK_BYTES
    entry.update(ms=statistics.mean(kern_ms), plain_ms=(p1 + p2) / 2,
                 ops=cost[0], bytes=cost[1],
                 bound_ms=max(t_ops, t_bytes) * 1e3,
                 bound_by="operations" if t_ops >= t_bytes else "bytes")


def train_kernels_vs_plain(cfg_kw: dict, spec, batch, seed: int,
                           repeats: int) -> dict:
    """The forward in train mode, the training step (K2) and the VJP (K3b)
    against their plain versions on one batch, with seeded weights, labels,
    cotangents and dropout seeds: errors, and with ``repeats`` times and
    bounds.

    The predictions and the SSE are held at REL_TOL (max |kernel - plain| /
    max |plain|).  So are the gradients, output by output, for SiLU and
    GELU.  With ReLU, two f32 evaluations of the same gradients disagree by
    more than that on large batches: pre-activations within rounding
    distance of 0 fall on different sides of the ReLU, and each such flip
    changes a whole column of a weight gradient and, through the
    cotangents, the layers below.  There the plain version is evaluated in
    float64 as well, and the kernel's gradients, as one vector, may be at
    most max(3 x the f32 plain version's, REL_TOL) away from it in relative
    L1 error (sum |g - g64| / sum |g64|)."""
    import torch
    from cgr_mpnn_3d_tpu_torch.models import (CGRMPNNConfig, adjoint_inputs,
                                              init_params, kernel_inputs,
                                              kernel_seeds)
    from cgr_mpnn_3d_tpu_torch.models.cgr_mpnn import ACTIVATIONS
    from cgr_mpnn_3d_tpu_torch.ops import fused_model as fm
    cfg = CGRMPNNConfig(**cfg_kw)
    gen = torch.Generator().manual_seed(seed)
    dev = batch.node_x.device
    model = init_params(cfg, gen, dev)
    if cfg.use_learnable_skip:
        with torch.no_grad():
            for w in model.skip_weights:
                w.copy_(torch.rand((), generator=gen) * 2.0 - 0.5)
    mask = batch.graph_mask
    labels = (torch.randn(mask.shape, generator=gen) * 10.0).to(dev)
    dpred = torch.randn(mask.shape, generator=gen).to(dev) * mask
    kw = dict(p=spec.p, act=ACTIVATIONS[cfg.activation], aggr=cfg.aggr,
              pooling=cfg.pooling, train=True,
              seeds=kernel_seeds(cfg, gen).tolist(),
              dropout_ps=cfg.dropout_ps)
    with torch.no_grad():
        args = kernel_inputs(model, batch)
    adj = adjoint_inputs(batch)
    real = mask > 0
    calls = {
        "fwd_train": (lambda: fm.fused_model_forward(*args, **kw),
                      lambda: fm.fused_model_forward_ref(*args, **kw)),
        "train": (lambda: fm.fused_model_train(args, adj, labels, mask, **kw),
                  lambda: fm.fused_model_train_ref(args, adj, labels, mask,
                                                   **kw)),
        "vjp": (lambda: fm.fused_model_vjp(args, adj, dpred, **kw),
                lambda: fm.fused_model_vjp_ref(args, adj, dpred, **kw)),
    }
    a64 = [t.double() if t.is_floating_point() else t for t in args]
    exact = {"train": lambda: fm.fused_model_train_ref(
                 a64, adj, labels.double(), mask.double(), **kw)[1],
             "vjp": lambda: fm.fused_model_vjp_ref(a64, adj, dpred.double(),
                                                    **kw)}
    relu = cfg.activation == "ReLU"

    def l1(a, b):
        a = torch.cat([t.double().flatten() for t in a])
        b = torch.cat([t.double().flatten() for t in b])
        return float((a - b).abs().sum() / b.abs().sum())

    out = dict(p=spec.p, graphs=int(real.sum()))
    for name, (kern, plain) in calls.items():
        with torch.no_grad():
            got, want = kern(), plain()
        torch.cuda.synchronize()
        names = ["preds"]
        if name == "fwd_train":
            got, want = [got[real]], [want[real]]
        elif name == "train":
            names = ["sse", *fm.GRAD_NAMES]
            got, want = [got[0], *got[1]], [want[0], *want[1]]
        else:
            names = list(fm.GRAD_NAMES)
        check(all(bool(torch.isfinite(g).all()) for g in got),
              f"{name} outputs are not finite")
        rels = [float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                for g, w in zip(got, want)]
        worst = int(np.argmax(rels))
        entry = dict(abs_err=max(float((g - w).abs().max())
                                 for g, w in zip(got, want)),
                     rel_err=rels[worst], worst=names[worst])
        held = list(zip(names, rels))
        if relu and name != "fwd_train":
            ex = exact[name]()
            entry.update(l1=l1(got[-11:], want[-11:]),
                         l1_64=(l1(got[-11:], ex), l1(want[-11:], ex)))
            held = held[:-11]
            k64, p64 = entry["l1_64"]
            check(k64 <= max(3.0 * p64, REL_TOL),
                  f"{name} gradients: kernel vs float64 L1 {k64:.3e} > "
                  f"max(3 x the f32 plain version's {p64:.3e}, {REL_TOL}) for "
                  f"{cfg_kw}")
        for what, rel in held:
            check(rel <= REL_TOL, f"{name} {what}: kernel vs plain relative "
                                  f"error {rel:.3e} > {REL_TOL} for {cfg_kw}")
        if repeats:
            with torch.no_grad():
                _timed(entry, kern, plain, repeats,
                       forward_cost(args) if name == "fwd_train"
                       else train_cost(args, adj))
        out[name] = entry
    return out


def print_train_kernels(what: str, k: dict, card: str) -> None:
    for name, e in k.items():
        if not isinstance(e, dict):
            continue
        line = (f"{name} {what}: {k['graphs']} graphs in {k['p']} packs, "
                f"max abs err {e['abs_err']:.3e}, rel {e['rel_err']:.3e} "
                f"({e['worst']})")
        if "l1" in e:
            line += (f"; gradient vector L1 vs plain {e['l1']:.3e}, vs "
                     f"float64: kernel {e['l1_64'][0]:.3e}, f32 plain "
                     f"{e['l1_64'][1]:.3e}")
        if "ms" in e:
            line += (f"; kernel {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} "
                     f"ms, f32 bound {e['bound_ms']:.4f} ms "
                     f"({e['ops'] / 1e9:.3f} GFLOP, {e['bytes'] / 1e6:.3f} "
                     f"MB, {e['bound_by']}-bound) [{card}]")
        print(line)


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


def training_data(tmp: Path, seed: int) -> Path:
    """The corpus as train, val and test splits, with synthetic descriptors
    (64 per structure)."""
    from cgr_mpnn_3d_tpu_torch.data.descriptors import \
        synthetic_descriptors_npz
    data = tmp / "datasets"
    data.mkdir(parents=True, exist_ok=True)
    corpus = ROOT / "tests" / "corpus_reactions.csv"
    synthetic_descriptors_npz(corpus, data / "train.npz", 64, seed=seed)
    for split in ("train", "val", "test"):
        shutil.copy(corpus, data / f"{split}.csv")
        if split != "train":
            shutil.copy(data / "train.npz", data / f"{split}.npz")
    return data


def train_cli(tmp: Path, data: Path, seed: int, device: str, epochs: int,
              save: str, *extra: str) -> dict:
    """One ``cli.train.main`` run with the README's flags; its outputs
    (checkpoints, logs, results) go under ``tmp``."""
    from cgr_mpnn_3d_tpu_torch.cli import train as cli_train
    return cli_train.main(README_FLAGS + [
        "-ne", str(epochs), "--val_frequency", "1", "--seed", str(seed),
        "--data_path", str(data), "--save_path", str(tmp / save),
        "--device", device, *extra])


def train_phase(tmp: Path, seed: int, card: str) -> dict:
    """Drive the training entry point on the card and on the CPU, then a
    resumed run against a straight one."""
    import torch
    from cgr_mpnn_3d_tpu_torch.ops import fused_model as fm
    from cgr_mpnn_3d_tpu_torch.train import load_checkpoint
    data = training_data(tmp, seed)

    # the main path: counts are zeroed just before it and read just after
    fm.launches = fm.train_launches = fm.vjp_launches = 0
    t0 = time.perf_counter()
    card_res = train_cli(tmp, data, seed, DEVICE, 3, "card",
                         "--log_histograms")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fwd=fm.launches, train=fm.train_launches,
                    vjp=fm.vjp_launches)
    check(launches["train"] == card_res["steps"] > 0,
          f"{launches['train']} training-kernel launches for "
          f"{card_res['steps']} optimizer steps")
    check(launches["vjp"] == 3, f"{launches['vjp']} VJP-kernel launches for "
                                f"3 epochs of gradient histograms")
    check(launches["fwd"] > 0, "validation launched no forward kernel")
    cpu_res = train_cli(tmp, data, seed, "cpu", 2, "cpu", "--log_histograms")
    losses = [card_res["train_losses"], card_res["val_losses"],
              cpu_res["train_losses"], cpu_res["val_losses"],
              [card_res["test_losses"], cpu_res["test_losses"]]]
    check(all(np.isfinite(v).all() and len(v) for v in losses),
          f"training losses are not finite: {losses}")
    rel = max(abs(a - b) / abs(b) for key in ("train_losses", "val_losses")
              for a, b in zip(card_res[key], cpu_res[key]))
    check(rel <= TRAIN_TOL, f"card vs CPU per-epoch RMSE differ by {rel:.3e}")
    steps_per_s = [json.loads(line).get("steps_per_s")
                   for f in (tmp / "runs").glob("*_e-3_*.jsonl")
                   for line in f.read_text().splitlines()
                   if '"train_loss"' in line]
    print(f"train cli card: 3 epochs, {card_res['steps']} steps in "
          f"{wall:.3f} s wall (featurize, train, validate, test), train RMSE "
          f"{card_res['train_losses']}, val RMSE {card_res['val_losses']}, "
          f"test RMSE {card_res['test_losses']}; launches: training kernel "
          f"{launches['train']}, VJP kernel {launches['vjp']}, forward kernel "
          f"{launches['fwd']}; steps/s per epoch (StepTimer) {steps_per_s} "
          f"[{card}]")
    print(f"train cli cpu: 2 epochs, train RMSE {cpu_res['train_losses']}, "
          f"val RMSE {cpu_res['val_losses']}; card vs CPU max rel diff "
          f"{rel:.3e} (limit {TRAIN_TOL})")

    # resume: 1 epoch, then --resume to 2, against a straight 2-epoch run
    train_cli(tmp, data, seed, DEVICE, 1, "resume", "--skip_test")
    (latest,) = (tmp / "resume").glob("*_e-1_*.latest.npz")
    train_cli(tmp, data, seed, DEVICE, 2, "resume", "--skip_test",
              "--resume", str(latest))
    train_cli(tmp, data, seed, DEVICE, 2, "straight", "--skip_test")
    (a,) = (tmp / "resume").glob("*_e-2_*.latest.npz")
    (b,) = (tmp / "straight").glob("*_e-2_*.latest.npz")
    la, lb = load_checkpoint(a)[0], load_checkpoint(b)[0]
    same = len(la) == len(lb) and all(np.array_equal(x, y)
                                      for x, y in zip(la, lb))
    check(same, "a resumed 2-epoch run differs from a straight one")
    print(f"resume: 1 epoch + --resume to 2 equals a straight 2-epoch run "
          f"bit for bit ({len(la)} leaves: params, Adam moments, step, "
          f"seed stream)")
    return dict(launches=launches, rel=rel, steps=card_res["steps"])


def train_profile(tmp: Path, seed: int, card: str) -> None:
    """Steps/s of the training step alone (batches already on the card) and
    the card's busy share of an epoch of steps under torch.profiler."""
    import torch
    from cgr_mpnn_3d_tpu_torch.data import ChemDataset, plan_spec, to_device
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNNConfig
    from cgr_mpnn_3d_tpu_torch.train import RxnGraphTrainer
    data = tmp / "datasets"
    ds = ChemDataset(str(data / "train.csv"),
                     data_npz_path=str(data / "train.npz"))
    ds.prefeaturize()
    cfg = CGRMPNNConfig(num_node_features=ds.num_node_features,
                        num_edge_features=ds.num_edge_features, depth=4,
                        hidden_sizes=(400,) * 4, dropout_ps=(0.1,) * 4)
    tr = RxnGraphTrainer(name="profile", cfg=cfg, train_data=ds, val_data=ds,
                         spec=plan_spec([ds.graph(i) for i in range(len(ds))]),
                         lr=1e-4, weight_decay=1e-5, gamma=0.9,
                         batch_size=64, seed=seed,
                         model_save_dir=str(tmp / "profile"), device=DEVICE)
    batches = [to_device(b, DEVICE) for b in tr.train_loader]
    for b in batches:
        tr._train_step(b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    for _ in range(4):
        for b in batches:
            tr._train_step(b)
            n += 1
    torch.cuda.synchronize()
    sps = n / (time.perf_counter() - t0)
    print(f"train step: {sps:.2f} steps/s over {n} steps of "
          f"{len(batches)} corpus batches already on the card (p = "
          f"{tr.train_loader.spec.p}) [{card}]")
    for _ in range(2):
        wall_ms, dev_ms, top = device_busy(
            lambda: [tr._train_step(b) for b in batches])
        print(f"profile train epoch ({len(batches)} steps): wall "
              f"{wall_ms:.3f} ms, device busy {dev_ms:.3f} ms "
              f"({100 * dev_ms / wall_ms:.1f}%), top device time {top} "
              f"[{card}]")


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
    full_train = dict(full, dropout_ps=(0.1,) * 4)
    train_k = train_kernels_vs_plain(full_train, spec, batch, args.seed,
                                     args.repeats)
    print_train_kernels("full width, dropout 0.1, synthetic", train_k, card)
    for act in ("SiLU", "GELU"):
        k = train_kernels_vs_plain(dict(full_train, activation=act), spec,
                                   batch, args.seed, 0)
        print_train_kernels(f"full width {act}, dropout 0.1, synthetic", k,
                            card)
    del batch
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
        k = train_kernels_vs_plain(dict(small, dropout_ps=(0.1,) * 3), spec,
                                   batch, args.seed + 1, 0)
        print_train_kernels(f"small width {act} mean/mean learnable skip, "
                            f"dropout 0.1", k, card)

    with tempfile.TemporaryDirectory() as tmp:
        spec, batch = corpus_batch(Path(tmp), args.seed, dev)
        req_k = kernel_vs_plain(full, spec, batch, args.seed, args.repeats)
        print(f"fused_model_fwd request batch: {req_k['graphs']} corpus "
              f"reactions in {req_k['p']} packs, rel err "
              f"{req_k['rel_err']:.3e}; kernel {req_k['ms']:.4f} ms, plain "
              f"{req_k['plain_ms']:.4f} ms, f32 bound "
              f"{req_k['bound_ms']:.4f} ms [{card}]")
        spec, batch = corpus_batch(Path(tmp), args.seed, dev, shuffle=True)
        k = train_kernels_vs_plain(full_train, spec, batch, args.seed,
                                   args.repeats)
        print_train_kernels("corpus training batch, full width, dropout 0.1",
                            k, card)
        srv = serve(Path(tmp), args.seed, card)
        # the training CLI writes runs/, hyperparameter_study/ and a parity
        # plot into its working directory
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            trn = train_phase(Path(tmp), args.seed, card)
            train_profile(Path(tmp), args.seed, card)
        finally:
            os.chdir(cwd)

    def kernel(name, cu, line, launches, k):
        return {"name": name, "route": "cuda",
                "source": f"cgr_mpnn_3d_tpu_torch/csrc/{cu}",
                "replaces": f"cgr_mpnn_3d_tpu/ops/pallas_model.py:{line}",
                "launches": launches, "max_abs_err": k["abs_err"],
                "ms": k["ms"], "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                "library_ms": None}
    print(json.dumps({"kernels": [
        kernel("fused_model_fwd", "fused_model_fwd.cu", 376, srv["launches"],
               main_k),
        kernel("fused_model_train", "fused_model_bwd.cu", 439,
               trn["launches"]["train"], train_k["train"]),
        kernel("fused_model_vjp", "fused_model_bwd.cu", 397,
               trn["launches"]["vjp"], train_k["vjp"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
