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
   and learnable skips; times and f32 bounds; K2's and K3b's cooperative
   grid (blocks, blocks per SM), and the phase timer
   ``tools/k2_phases.py`` at p = 4 and 436 packs, f32 and bf16 (its
   stamped build, started beside the others, equal to the shipped one),
   and with ``--forward`` for K3f; K3f's cooperative grid on the
   synthetic batch (436 packs) and the corpus request batch (p = 4): its
   predictions equal bit for bit through a rerun and a build with a
   7-block grid, at f32 and bf16, eval and train mode, and timed in
   alternating rounds (with ``--parent``, beside the earlier commit's
   K3f);
5. serving: the native C++ featurizer and packer on the host first
   (``native_phase``: featurization of the corpus and the demo set against
   the Python twin at NATIVE_TOL, ``pack_graphs_native`` /
   ``place_graphs_native`` and the reused-packs cache ``pack_epoch_native``
   against the Python packer, per-window iteration and two packing
   workers bit for bit, us a reaction and ms an epoch of each); then a
   seeded full-width checkpoint in the ``.npz`` + JSON format
   serves ``examples/demo.csv`` (with synthetic descriptors) through
   ``activation_energy_prediction(device="cuda")`` once as a batch and as 10
   single-reaction requests; the launch count of the kernel must rise, and
   the predictions must match the same entry point with ``device="cpu"``;
   request latency and served graphs/s; the same requests with native
   featurization and the Python twin in 3 alternating rounds
   (``serve_native``: latency, corpus graphs/s, predictions within REL_TOL,
   busy share of each), the corpus request's stages and ``load_model``'s
   parts (``load_checkpoint``, the model build, ``restore_into``,
   ``.to(device)``);
6. training: ``cli.train.main`` with the README's model and flags, 3 epochs
   on the 300-reaction corpus (synthetic descriptors) on the card, then 2 on
   the CPU; the per-epoch RMSEs must agree, every training step must be one
   launch of the training kernel, and the gradient histograms must go
   through the VJP kernel; then a resumed run (1 epoch, resume, 2nd epoch)
   must equal a straight 2-epoch run bit for bit; the loader's modes
   (``train_modes_phase``: ``--reuse_packs --loader_workers 2
   --num_workers 2`` on the card against the CPU, against
   ``--loader_workers 1`` bit for bit (the port packs serially whatever
   the flag says) and beside the run without
   ``--reuse_packs``, the busy share of trainer epochs with and without
   reused packs, ``--ep 2 --reuse_packs`` card against CPU); the
   trainer's device-resident modes (``device_epoch_phase``: ``--reuse_packs
   --device_epoch`` at f32 and bf16, the layered configuration, ``--ep 2``
   and the wired EP step staged, ``--steps_per_call 4``, each against its
   host loop bit for bit -- ``--ep 2`` from epoch 1 on within rtol 0.05 --
   and against the CPU; every staged epoch's and chunk's step loop under
   sync debug mode "error" in a torch.profiler window with no HtoD or DtoH
   copy, one K2 launch a whole-model step; steps/s and busy share of
   staged epochs and of chunks beside the host loop, the staged MB);
   steps/s and the card's busy share of a
   training step under torch.profiler;
7. the layered-kernel configuration (``fuse_whole_model=False``): the
   gather-linear K5 (edge_init and readout), the conv stack K4 (eval and
   train mode) and the ELL gather-sum K7 (pooling, its transposed
   backward, the sign row), forward and backward, against their plain
   versions on the inputs a layered forward gives them -- at full width on
   the synthetic batch and on the corpus training batch with times, f32
   bounds and K7's ``embedding_bag`` yardstick, at small width for SiLU and
   GELU with mean/mean and learnable skips; the layered path against the
   whole-model kernels (predictions against K3f, gradients against K2
   under the same dropout seeds);
8. layered serving through ``train/evaluate.py::predict`` (demo batch, 10
   singles, corpus), held to the CPU and to the whole-model path, with the
   launch counts (K5 twice, K4 and K7 once per request batch, no K3f);
9. layered training: ``RxnGraphTrainer`` with the README's model and
   flags, 2 epochs on the corpus on the card and on the CPU and with the
   whole-model configuration on the card; per-epoch RMSEs held to each
   other, every step launching the backward kernels of K5, K4 and K7 and no
   K2; steps/s of both configurations and a profiled layered epoch;
10. capture mode (``apply(capture=True)``: the ELL gather-sum K7 for
   x[senders], the incoming sum and the pooling, the per-layer conv kernel
   K6 once per layer): K6 against its plain version forward and backward
   (eval and train mode at full width on the synthetic batch and on the
   corpus training batch, with times and f32 bounds; SiLU and GELU with
   mean and learnable skips at small width; Hin != H), its backward rerun
   bit for bit; capture on the card against capture through the plain
   versions on the card (every batch) and on the CPU (small batches) in
   every activation, and against the layered path and K3f (predictions)
   and K2 (gradients, train mode under the same seeds), with its launch
   counts;
11. the eight cases of ``tests/goldens/reference_gnn.npz`` (the original
   model's activations) through capture mode on the card;
12. the activation-chain probe P1: the probe at its defaults
   (``tools/gelu_roofline.py``), its kernel against its plain version on
   the probe's input, and a layered training step with ReLU and with GELU
   against the probe's prediction;
13. the per-op timing CLI ``cli/bench_ops.py`` at its defaults (every row
   at the JAX module's dtype: bf16 but for the plain gather and Adam), then
   every kernel it times against its plain version on its te = 512 batch;
14. bf16 compute (``compute_dtype="bfloat16"``), interleaved with the
   phases above: the bf16 instantiation of K3f, K2 and K3b against their
   bf16 plain versions (rel-L2 of predictions and SSE, cosine of the
   gradients, K2 and K3b reruns bit for bit, and against the f32 plain
   version at tests/test_bf16.py's bounds; predictions and gradients at
   most half as far from the bf16 plain version as from the f32 one, a
   hold the f32 kernel on the same inputs must fail) at full width on the
   synthetic batch and the corpus request and training batches, with times and bf16
   bounds, and at small width for SiLU and GELU with mean/mean and
   learnable skips; the training step's steps/s and profile in both
   dtypes; ``cli.train.main`` with ``--compute_dtype bfloat16``, 3 epochs
   on the card and 2 on the CPU, where every step is one bf16 K2 launch,
   the histograms go through the bf16 K3b, validation through the bf16
   K3f, the test after training through the f32 K3f (the checkpoint loads
   in f32, as in the JAX CLI), and no f32 K2 or K3b runs;
15. the matmul probe P2: the probe at its defaults
   (``tools/int8_microbench.py``), then its kernel against its plain
   version at N = 4096 in bf16 and in int8 (over [-3, 3] and the full
   [-128, 127]), its int8 transpose alone against ``b.t()``, each one's
   rate and share of its bound and of the library call, and the kernels'
   registers from ptxas;
16. bf16 in the layered and capture paths (the bf16 instantiation of K4,
   K5, K6 and K7), interleaved with the phases above: each kernel against
   its bf16 plain version on the inputs a bf16 layered forward or capture
   gives it (bf16 x, e, h0 and states; K5 edge_init and readout, K4 eval
   and train, K7 pool, its transposed backward and the sign row, K6 eval,
   train and Hin != H), forward and backward, held by hold_bf16 (rel-L2,
   gradient cosine, backward reruns bit for bit, the f32 plain version at
   tests/test_bf16.py's bounds, and the share hold with the f32 kernel as
   control) at full width on the synthetic batch and the corpus training
   batch with times and bf16 bounds, and at small width for SiLU and GELU
   with mean/mean and learnable skips; capture at bf16 on the card against
   capture through the bf16 plain versions on the card and on the CPU
   (every activation, then the gradients), its launch counts and its
   forward and step ms beside f32; layered serving at bf16 through
   ``predict`` (bf16 K5 twice, K4 and K7 once per request batch, no f32
   launch, no K3f) held to the CPU and the bf16 whole-model path within
   1e-2 rel-L2; layered training at bf16, 2 epochs on the card and on the
   CPU, every step launching the bf16 backward kernels, steps/s beside the
   f32 layered step; bench_ops' K6 and K7 rows at bf16 (phase 13);
17. edge partitioning (every shard of a step in this process): K8, K9, K10
   and K11 against their plain versions at full width on the most wired
   shard of a wired batch (a 9,600-atom chain cut across the shards and 200
   synthetic graphs) and on the zero-cut 2,500 graphs with two 480-atom
   chains at n_ep 2 and 4, forward and backward (ReLU gradients by the
   float64 rule, backward reruns bit for bit), with times, plain versions'
   times and bounds; the EP forward and gradients on the card
   against the single-device model (predictions and SSE against the
   layered ``apply``, gradients against K2's plain version in float64) at
   n_ep 2 and 4 (a 2,400-atom chain and 50 synthetic graphs); the EP
   training step against the single-device layered
   step on a zero-cut batch (2,500 synthetic graphs and two 480-atom
   chains) and on the wired batch; ``cli.train.main --ep 2`` with the
   README's model on the corpus, 3 epochs on the card and 2 on the CPU
   (zero cut: one K2 per shard and step, validation through K5, K4 and
   K11); ``RxnGraphTrainer(n_ep=2)`` on a wired dataset with aggr add (K8)
   and mean (K9), 3 epochs on the card and on the CPU, with the launch
   counts of every new kernel;
18. EP at bf16, K6's linear activation, the hop exchange K12, --ep_rdma
   and --ep_overlap: K8, K9, K10 and K11 at bf16 and K6 with act="linear"
   (f32 and bf16) against their plain versions on the wired batch's most
   wired shard at n_ep 2 (hold_bf16, the f32 kernel as control), with
   times, bounds and plain versions' times; K12 against the ring copies
   on the wired batch's wire buffers at n_ep 2 and 4, f32 and bf16, both
   ways and backward, bit for bit, timed beside the copies and one
   ``index_select`` (CUDA events, and the device time of K12 and of
   ``index_select`` under torch.profiler), with the wrapper's host time
   step by step (``tools/k12_host.py``); the wired EP step at n_ep 2
   through the ring copies, K12 (equal bit for bit, one launch per
   exchange, also at n_ep 4), bf16
   (against f32 within tests/test_bf16.py's bounds) and --ep_overlap (f32
   against the K8 path, gradients by the float64 rule; bf16 by the bf16
   rule), each step's ms and launches, the busy share with and without
   K12; ``tools/profile_ep.py`` at its defaults (K10's caller);
   ``cli.train.main --ep 2 --compute_dtype bfloat16`` on the corpus (3
   epochs on the card, 2 on the CPU, BF16_TRAIN_TOL); the wired trainer at
   bf16 (K8, K9), with --ep_rdma and with --ep_overlap, card vs CPU; each
   new phase's wall time on a line of its own;
19. the gather-linear K5 and the EP readout K10/K11
   (``csrc/gather_linear.cu`` on ``csrc/conv_grid.cuh``'s tile, one
   cooperative launch per direction): the inputs of their first launch of
   each kernel, dtype, activation, mean and shape are recorded where the
   kernel phases (436 packs, the corpus training batch at p = 4, the wired
   batch) and the main paths (layered serving and training, ``--ep 2``
   validation, the wired training runs) launch them; each is replayed: a
   rerun and every forced build of GLIN_VARIANTS (a 7-block grid, 32- and
   64-row tiles, one and two blocks an SM) bit for bit, held against its
   plain version (PERF.md section 2's bounds), one kernel launch a call
   (torch.profiler), the wrapper's host ms a call, the bound, its grid,
   and with ``--parent`` the earlier commit's build (through that commit's
   own wrapper) bit for bit, its launches, and both timed in alternating
   rounds and by device time; ``tools/glin_phases.py --probe`` (the
   grid's phases at p = 4, 436 packs and two K11 layouts, block 0's
   product tiles without copies or products); the conv layer (K6, K8/K9,
   K4) and K2/K3b, recorded on the capture step, layered training, the
   corpus training batch and the wired batch and training runs: a rerun
   bit for bit, one launch a call of K6 and K8/K9, and with ``--parent``
   bit for bit and timed beside the earlier commit's builds;
20. the ELL gather-sum K7 (``csrc/onehot_spmm.cu``: a group of lanes a
   row, vector loads): the inputs of its first launch of each shape and
   dtype are recorded where the 436-pack and p = 4 kernel phases and the
   main paths (layered serving and training, the capture step, bench_ops'
   messages, ``tools/profile_ep.py``'s rows) launch it; each is replayed:
   a rerun and every forced build of SPMM_VARIANTS (4-byte loads, one row
   a warp) bit for bit, its plain version at REL_TOL, one kernel launch a
   call, its launch plan (the kernel's, equal to the wrapper's mirror),
   the bound, and with ``--parent`` the earlier commit's build (through
   that commit's own wrapper) bit for bit; device ms a call behind a spin
   (shipped, parent, ``embedding_bag``), the call's ms by CUDA events in
   alternating rounds and its host ms; then the wrapper's host time step
   by step (``tools/k7_host.py``, the parent's beside it);
21. data parallelism with every group in this process (``dp_phase``,
   after the device-resident modes): ``cli.train.main`` with the README's
   model and ``--dp 2`` on the corpus, 3 epochs on the card and 2 on the
   CPU at f32 and bf16 (two K2 launches a step, one K3f a validation
   group's batch); the layered configuration's K5, K4 and K7 launches a
   step twice the single-device step's; one dp step against one step on a
   batch of both groups' graphs; the all-masked filler group's SSE and
   gradients exactly 0 (K2, K3f, the layered kernels; add and mean);
   ``--dp 2 --reuse_packs --device_epoch`` under StrictSteps against its
   host loop; ``n_dp=2, n_ep=2`` on the wired set (K8 and K9, K11) card
   against CPU; a mid-epoch resume bit for bit with a straight run;
22. the MACE descriptor pipeline behind ``--data_path_coordinates``
   (``descriptor_phase``, after serving): the demo set's xyz written by
   ``data.preprocess.write_xyz_frames``, a numpy backend in place of MACE,
   ``activation_energy_prediction(input_coordinates=...)`` on the card
   against serving the npz it wrote and against the CPU, its stage times
   (the xyz -> npz step apart), and the default backend's ImportError;
   then the port's MACE kernels (``mace_phase``): MI and MP, each layer's,
   on the geometry screen's first window against their plain versions at
   MACE_TOL, their times and f32 bounds (``gpubench/cost_mace.py``), and
   one ``predict`` request from geometries with their launch counters
   zeroed before it (``--mace_only`` runs this phase alone after the
   card's line and prints its ``kernels`` line);
23. multi-process training (``multiprocess_phase``, after ``dp_phase``):
   two ranks of a gloo process group share the card, each this script
   started again with ``--rank_job`` (built kernels found on disk): (1)
   ``cli.train --dp 2`` with the README's model on the corpus through
   torchrun's variables, (2) ``--dp 2 --compute_dtype bfloat16
   --reuse_packs --device_epoch`` through the JAX CLI's variables, (3) the
   wired set with ``n_ep=2``, one EP shard a rank (K5, K8, K11; the ring
   exchange and the group sums between the ranks); each against the
   single-process run with the same flags on the card: the per-epoch
   losses and the latest checkpoint's leaves bit for bit (run 3: losses
   at rtol 1e-6 and leaves within 1e-6 of their largest, the gradients
   being summed over the shards in another order), only rank 0 writes,
   each rank one K2 a step in run 1 (and the bf16 K2 in run 2), each
   rank's launches half the single process's in run 3; the ranks' wall
   steps/s beside the single process's and the collectives' host ms a
   step; (3b) run 3 with ``ep_rdma_exchange``: every exchange through the
   cross-rank K12 (``csrc/rank_exchange.cu``, CUDA IPC), against the
   single-process ``--ep_rdma`` run by run 3's rule, no gloo ring move on
   either rank, each rank's cross-rank K12 launches (forward, backward)
   equal to the one-process K12's, the collectives' host ms a step with
   and without it; (3c) the cross-rank K12 alone (``tools/k12_ranks.py``)
   at 2 ranks (caps (8,), H 400) and 4 (caps (8, 0, 16) and (0, 8, 0)),
   f32 and bf16: both ways, the backward and 200 calls back to back bit
   for bit with ``_ring_move`` and gloo's move of the same buffers, one
   launch an exchange, the median host ms of one synchronized exchange
   over 200 calls (the cross-rank K12, gloo's move, the one-process K12;
   a shared card), and a peer that never calls making its destination
   raise within its limit (runs 3, 3b and 4, then the 2-rank 3c, run in
   turn as sub-jobs of one pair of rank processes); (4) the same wired
   set in the flat layout
   (``parallel/edge_partition.py``), one shard a rank: one training step
   and one eval, the all-to-alls through gloo, SSEs bit for bit with the
   lockstep run and gradients within 1e-6 of their largest, K7 launches
   half of lockstep's a rank;
24. sweeps and the run-book (``sweep_phase``, after
   ``multiprocess_phase``): ``cli/sweep.py``'s ``run_sweep`` with 2 bayes
   trials of 1 epoch of the README model on the corpus on the card, every
   trial "ok" and launching K2 (a failed trial fails the phase); then
   ``cli/runbook.py`` with ``--epochs 1 --device cuda`` and gates
   overridden to 1000 (both models trained, tested and gated, the summary
   written), and with a failing gate (exit status 1);
25. the flat edge-partition layout (``flat_ep_phase``, after the EP
   phases): the README model at full width on the wired set (the
   9,600-atom chain and 200 graphs) through ``shard_edges`` at n_ep 2 and
   4, every shard in this process: the forward's predictions against K3f
   on the same graphs and against the same code on the CPU at REL_TOL, a
   training step's SSE and gradients against the CPU's (ReLU: hold's
   float64 rule), a rerun bit for bit, K7 launches equal to the plan
   (``flat_launches``: 5·depth + 4 a shard forward, 5·depth + 3 more in
   a step), no plain gather (NoPlainGathers); bf16 held to the f32 run
   (rel-L2 < 1.5e-2, gradient cosine > 0.995, K7 at f32); the forward's
   and the step's ms beside the pack-local EP step on the same set; mean
   aggregation and pooling at small width (also against K3f); a zero cut
   (every boundary row a sentinel) and shards that own no edge; an
   ``EPLoader`` epoch on the corpus (n_dp 2, n_ep 2, Adam) card against
   CPU;
26. ``train.profiler.trace`` (``trace_phase``, after ``sweep_phase``)
   around three staged epochs in a fresh process (this script with
   ``--trace_job``): the Chrome trace written, naming K2 in one kernel
   record a step and holding the program's spans, ``train.step``,
   ``model.grads`` and ``ops.k2`` once a step;
27. a ``{"kernels": [...]}`` line (the launches of every main path, the
   data-parallel, multi-process, sweep, run-book, trace and flat runs'
   included), then ``{"ok": true, "device": {...}}`` as the last line.

It exits non-zero, printing no result, without CUDA or without the package
beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
REL_TOL = 1e-4          # max |kernel - plain| / max |plain|, f32, TF32 off
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores (data sheet)
PEAK_BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense (data sheet)
PEAK_INT8_OPS = 1979e12   # H100 SXM int8 tensor cores, dense (data sheet)
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes/s (data sheet)
DEVICE = "cuda"
TRAIN_TOL = 1e-3        # card vs CPU per-epoch RMSE, relative
NATIVE_TOL = 1e-6       # native vs Python features (tests/test_native.py)
MACE_TOL = 1e-5         # MACE kernels vs plain, f32 (tests/test_torch_mace_cuda.py)
README_FLAGS = ["--name", "CGR-MPNN-3D", "-d", "4", "--hidden_sizes", "400",
                "--dropout_ps", "0.1", "-af", "ReLU", "-lr", "1e-4",
                "--weight_decay", "1e-5", "-bs", "64", "-g", "0.9"]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def in_background(fn):
    """Start ``fn()`` in a thread; returns a call that waits for it and
    gives its result, or raises what it raised."""
    out: dict = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # handed to the waiting call
            out["error"] = e
    t = threading.Thread(target=run)
    t.start()

    def wait():
        t.join()
        if "error" in out:
            raise out["error"]
        return out["value"]
    return wait


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def l1(a, b) -> float:
    """Relative L1 distance of two lists of tensors taken as one vector."""
    import torch
    a = torch.cat([t.double().flatten() for t in a])
    b = torch.cat([t.double().flatten() for t in b])
    return float((a - b).abs().sum() / b.abs().sum())


def _f64(ts) -> list:
    return [t.double() if t.is_floating_point() else t for t in ts]


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


def alternating_ms(fns: dict, calls: int, rounds: int = 5) -> dict:
    """{name: [ms a call of each round]}: ``rounds`` rounds, each timing
    every function of ``fns`` over ``calls`` calls between two CUDA events
    in turn, so a slow spell of the shared host falls on all of them."""
    out = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            out[name].append(time_ms(fn, calls))
    return out


def bound(cost, bf16: bool) -> tuple[float, str]:
    """(least ms, "operations" or "bytes") of work ``cost`` = (product
    operations, other operations, bytes): the products at the f32 peak, or
    with ``bf16`` at the bf16 tensor-core peak; the other operations
    (gathers, elementwise) at the f32 peak."""
    t_ops = (cost[0] / (PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS)
             + cost[1] / PEAK_F32_FLOPS)
    t_bytes = cost[2] / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def forward_cost(args) -> tuple[float, float, float]:
    """(product operations, gather adds, bytes) the forward needs on these
    inputs: the dense products' FMAs (2 ops each) and the gather-sum adds
    over real rows -- padding rows feed no prediction -- and every input
    read once plus the predictions written once.  The x part of edge_init
    is counted once per node, since x[senders]·Wx = (x·Wx)[senders]."""
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
    return float(dense), float(adds), float(nbytes)


def train_cost(args, adjoint) -> tuple[float, float, float]:
    """(product operations, gather adds, bytes) one training step's compute
    needs on these inputs: the replayed forward (forward_cost), then over the real rows the
    cotangents through the weights (ds, and dt for every conv layer), each
    weight gradient once -- the x part of dWx once per node, as in the
    forward -- and the transposed gathers (dh: as many adds as the
    forward's gathers).  The graph inputs take no gradient.  Bytes: the
    inputs, the adjoint indices, labels and mask read once, the gradients
    and the SSE written once."""
    f_dense, f_adds, nbytes = forward_cost(args)
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
    return float(f_dense + dense), float(f_adds + adds), float(nbytes)


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
            cost = forward_cost(args)
            bound_ms, bound_by = bound(cost, bf16=False)
            out.update(ms=statistics.mean(kern), plain_ms=statistics.mean(plain),
                       ops=cost[0] + cost[1], bytes=cost[2], bound_ms=bound_ms,
                       bound_by=bound_by)
    check(rel <= REL_TOL, f"kernel vs plain relative error {rel:.3e} > "
                          f"{REL_TOL} for {cfg_kw}")
    return out


def _timed(entry: dict, kern, plain, repeats: int, cost,
           bf16: bool = False) -> None:
    """Times of the kernel and its plain version (plain, kernel, kernel,
    plain) and the bound of ``cost`` (see bound), its products at the bf16
    peak with ``bf16``.  A plain
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
    bound_ms, bound_by = bound(cost, bf16)
    entry.update(ms=statistics.mean(kern_ms), plain_ms=(p1 + p2) / 2,
                 ops=cost[0] + cost[1], bytes=cost[2], bound_ms=bound_ms,
                 bound_by=bound_by)


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


def k2_grid_phase(card: str) -> dict:
    """The cooperative grid K2 and K3b launch, at each mat_dtype, for the
    training batch (p = 4) and the full-width synthetic batch (436 packs)
    of the README model: more blocks than the 4 packs of a training
    batch."""
    from cgr_mpnn_3d_tpu_torch.ops import fused_model as fm
    out = {}
    for md in ("float32", "bfloat16"):
        for p in (4, 436):
            grid, per_sm, sms = fm.bwd_grid(p, 256, 400, md)
            out[md, p] = grid
            print(f"K2/K3b {md}, {p} packs: one cooperative grid of {grid} "
                  f"blocks ({per_sm} per SM x {sms} SMs) [{card}]")
        check(out[md, 4] > 4, f"K2 {md} launches {out[md, 4]} blocks at "
                              f"p = 4")
    return out


def k2_phases_phase(card: str, stamped_build) -> dict:
    """tools/k2_phases.py at its defaults (p = 4 and 436 packs, f32 and
    bf16) once its stamped build (``stamped_build``, started beside the
    others) is ready: every phase stamped, the stamped build's outputs
    equal to the shipped build's."""
    from cgr_mpnn_3d_tpu_torch.tools import k2_phases
    stamped_build()
    print(f"k2_phases [{card}]:")
    out = k2_phases.main([])
    for key, r in out.items():
        check(r["equal"], f"k2_phases {key}: the stamped build differs")
        check({k.split("[")[0] for k in r["phases"]}
              == set(k2_phases.PHASES[1:]),
              f"k2_phases {key}: phases {sorted(r['phases'])}")
    return out


# the build of csrc/fused_model_fwd.cu with a 7-block grid: K3f's
# predictions must not move (the forced instantiations are the card
# tests'; tools/bwd_registers.py --forward times them)
K3F_VARIANTS = {"7 blocks": {"CGR_GRID_BLOCKS": 7}}


def start_variant_builds(parent: Path | None = None) -> dict:
    """The builds under build/k2_phases/ that the K3f, phase-clock and
    gather-linear grid phases swap in (GLIN_VARIANTS, and
    tools/glin_phases.py's stamped and probe builds), and with ``parent``
    (an earlier commit's csrc/) its fused_model_fwd.cu ("K3f earlier"),
    fused_conv.cu, conv_stack.cu, gather_linear.cu, onehot_spmm.cu and
    fused_model_bwd.cu ("<library> earlier"), and K7's SPMM_VARIANTS, each
    started now (nvcc in the background): {name: a call that waits for the
    library}."""
    from cgr_mpnn_3d_tpu_torch.ops import _build
    from cgr_mpnn_3d_tpu_torch.tools import glin_phases, k2_phases
    fwd = _build.CSRC / "fused_model_fwd.cu"
    glin = _build.CSRC / "gather_linear.cu"
    todo = {f"K3f {n}": (d, fwd) for n, d in K3F_VARIANTS.items()}
    todo.update({"K2 stamped": ({k2_phases.DEFINE: None}, None),
                 "K3f stamped": ({k2_phases.DEFINE: None}, fwd)})
    todo.update({f"gather_linear {n}": (d, glin)
                 for n, d in GLIN_VARIANTS.items()})
    todo.update({f"glin_phases {n}": (d, glin)
                 for n, d in glin_phases.DEFINES.items()})
    todo.update({f"onehot_spmm {n}": (d, _build.CSRC / "onehot_spmm.cu")
                 for n, d in SPMM_VARIANTS.items()})
    if parent is not None:
        parent = parent.resolve()
        todo["K3f earlier"] = ({}, parent / "fused_model_fwd.cu")
        todo.update({f"{lib} earlier": ({}, parent / f"{lib}.cu")
                     for lib in ("fused_conv", "conv_stack", "onehot_spmm",
                                 "fused_model_bwd", "gather_linear")})
    return {name: in_background(lambda d=d, src=src: k2_phases.variant(d,
                                                                       src))
            for name, (d, src) in todo.items()}


def glin_phases_phase(card: str, builds: dict,
                      parent: Path | None = None) -> dict:
    """tools/glin_phases.py --probe at its defaults (K5 at p = 4 and 436
    packs, K11 on the wired runs' and a zero-cut layout, f32 and bf16) once
    its builds (started beside the others) are ready: the stamped build
    equal to the shipped one (the tool raises otherwise), every phase a
    positive time within its span.  Its f32 K5 backwards (random inputs,
    ReLU, where the kernel's ``out`` and the plain version's recomputed
    pre-activation may disagree on a mask) are then replayed by
    held_beside_parent: the float64 rule, the masks that differ, the
    forced builds and, with ``parent``, the parent's build."""
    from cgr_mpnn_3d_tpu_torch.tools import glin_phases
    for name in glin_phases.DEFINES:
        builds[f"glin_phases {name}"]()
    print(f"glin_phases --probe [{card}]:")
    rec = LaunchRecorder({"K5 bwd": GLIN_LAUNCHES["K5 bwd"]}, 8)
    with rec:
        out = glin_phases.main(["--probe"])
    for key, r in out.items():
        if isinstance(r, dict):
            check(all(0 < v <= r["span"] + 1e-9 for v in r.values()),
                  f"glin_phases {key}: phases {r}")
    rec.calls = {k: v for k, v in rec.calls.items() if k[1] == "float32"}
    held_beside_parent({"tools/glin_phases.py cases": rec}, builds, 0, card,
                       parent, glin=True)
    return out


def parent_wrapper(parent: Path, module: str):
    """The wrapper module ops/<module>.py of an earlier commit's package
    (``parent`` its csrc/, unpacked beside its ops/ by git archive),
    loaded under a name of its own inside the shipped ops package (its
    relative imports reach the shipped helpers), for calls through that
    commit's build (``swapped``) whose C interface differs from the
    shipped one."""
    import importlib.util
    name = f"cgr_mpnn_3d_tpu_torch.ops._parent_{module}"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, Path(parent).resolve().parent / "ops" / f"{module}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def parent_bound(parent: Path, module: str, name: str, lib):
    """parent_wrapper(parent, module) with its ``library`` bound to
    ``lib`` (that commit's build of csrc/<name>.cu, typed by the wrapper's
    own signatures), so that its calls need no swap of the shipped table
    (the bound lookup is cheaper than the wrapper's own, which favours the
    parent in a host-time comparison)."""
    from cgr_mpnn_3d_tpu_torch.ops._launch import library
    mod = parent_wrapper(parent, module)
    typed = swapped(name, lib, lambda: library(name, mod._SIGNATURES))
    mod.library = lambda *_: typed
    return mod


def swapped(name: str, lib, fn):
    """fn() with ``lib`` as the wrapper's library of csrc/<name>.cu."""
    from cgr_mpnn_3d_tpu_torch.ops import _build
    shipped = _build.load(name)
    _build._libs[name] = lib
    try:
        return fn()
    finally:
        _build._libs[name] = shipped


def k3f_grid_phase(cfg_kw: dict, spec, batch, seed: int, repeats: int,
                   builds: dict, card: str, what: str) -> dict:
    """K3f as one cooperative grid: its grid at f32 and bf16, and its
    predictions through the shipped build, a rerun and each grid build of
    K3F_VARIANTS (a 7-block grid), equal bit for bit at f32 and bf16, eval
    and train mode (dropout 0.1, seeded); the earlier commit's K3f
    (``builds["K3f earlier"]``, with ``--parent``), same C interface, is
    reported equal or not.  With ``repeats``: eval-mode ms of the shipped
    build and the earlier commit's, timed over ``repeats`` calls in 5
    alternating rounds (medians and the rounds' spread)."""
    import torch
    from cgr_mpnn_3d_tpu_torch.models import (CGRMPNNConfig, init_params,
                                              kernel_inputs, kernel_seeds)
    from cgr_mpnn_3d_tpu_torch.models.cgr_mpnn import ACTIVATIONS
    from cgr_mpnn_3d_tpu_torch.ops import fused_model as fm
    cfg = CGRMPNNConfig(**dict(cfg_kw, dropout_ps=(0.1,) * cfg_kw["depth"]))
    gen = torch.Generator().manual_seed(seed)
    model = init_params(cfg, gen, batch.node_x.device)
    with torch.no_grad():
        args = kernel_inputs(model, batch)
    ev = dict(p=spec.p, act=ACTIVATIONS[cfg.activation], aggr=cfg.aggr,
              pooling=cfg.pooling)
    tr = dict(ev, train=True, seeds=kernel_seeds(cfg, gen).tolist(),
              dropout_ps=cfg.dropout_ps)
    libs = {n: builds[f"K3f {n}"]() for n in K3F_VARIANTS}
    earlier = builds["K3f earlier"]() if "K3f earlier" in builds else None
    H = cfg.hidden_sizes[0]
    out: dict = dict(p=spec.p, grid={}, earlier_equal={}, ms={})
    for md in ("float32", BF16):
        out["grid"][md] = fm.fwd_grid(spec.p, spec.te, H, md)
        for mode, kw in (("eval", ev), ("train", tr)):
            def call(kw=dict(kw, mat_dtype=md)):
                with torch.no_grad():
                    return fm.fused_model_forward(*args, **kw)
            want = call()
            check(bool(torch.isfinite(want[batch.graph_mask > 0]).all()),
                  f"K3f {md} {mode} predictions are not finite")
            check(torch.equal(want, call()),
                  f"two runs of K3f {md} {mode} differ on {spec.p} packs")
            for name, lib in libs.items():
                check(torch.equal(swapped("fused_model_fwd", lib, call), want),
                      f"K3f {md} {mode} through the {name} build differs "
                      f"from the shipped build on {spec.p} packs")
            if earlier is not None:
                out["earlier_equal"][md, mode] = bool(torch.equal(
                    swapped("fused_model_fwd", earlier, call), want))
        if repeats:
            kw = dict(ev, mat_dtype=md)

            def fwd():
                with torch.no_grad():
                    fm.fused_model_forward(*args, **kw)
            fns = {"shipped": fwd}
            if earlier is not None:
                fns["earlier commit"] = lambda: swapped("fused_model_fwd",
                                                        earlier, fwd)
            out["ms"][md] = alternating_ms(fns, repeats)
    grids = "; ".join(f"{md} {g[0]} blocks ({g[1]} per SM x {g[2]} SMs)"
                      for md, g in out["grid"].items())
    print(f"K3f grid, {what}, {spec.p} packs: {grids}; predictions equal bit "
          f"for bit through a rerun and the {', '.join(K3F_VARIANTS)} "
          f"build, at f32 and bf16, eval and train" + (
              "" if earlier is None else
              f"; the earlier commit's K3f equal: {out['earlier_equal']}")
          + f" [{card}]")
    for md, ms in out["ms"].items():
        print(f"K3f {md} eval, {what}, {spec.p} packs, ms (median of 5 "
              f"alternating rounds, min-max): " + "; ".join(
                  f"{n} {statistics.median(v):.4f} ({min(v):.4f}-"
                  f"{max(v):.4f})" for n, v in ms.items()) + f" [{card}]")
    return out


def k3f_phases_phase(card: str, builds: dict) -> dict:
    """tools/k2_phases.py --forward at its defaults (K3f, eval mode, p = 4
    and 436 packs, f32 and bf16) once its stamped build is ready: the
    forward's phases stamped, the stamped build equal to the shipped one."""
    from cgr_mpnn_3d_tpu_torch.tools import k2_phases
    builds["K3f stamped"]()
    print(f"k2_phases --forward [{card}]:")
    out = k2_phases.main(["--forward"])
    for key, r in out.items():
        check(r["equal"], f"k2_phases --forward {key}: the stamped build "
                          f"differs")
        check({k.split("[")[0] for k in r["phases"]}
              == set(k2_phases.PHASES[1:7]),
              f"k2_phases --forward {key}: phases {sorted(r['phases'])}")
    return out


# forced builds of csrc/gather_linear.cu's grid: each must give the
# shipped build's bits (the result does not depend on the grid, the tile
# rows or the blocks per SM)
GLIN_VARIANTS = {
    "7 blocks": {"CGR_GRID_BLOCKS": 7},
    "tile rows 32": {"CGR_CONV_BM": 32},
    "tile rows 64, 1 block an SM": {"CGR_CONV_BM": 64,
                                    "CGR_BLOCKS_PER_SM": 1},
    "tile rows 64, 2 blocks an SM": {"CGR_CONV_BM": 64,
                                     "CGR_BLOCKS_PER_SM": 2}}
# the wrappers' launch functions whose inputs the main paths record:
# {kernel: (module, function, library)}; K10/K11's is K11's with a pool
GLIN_LAUNCHES = {
    "K5 fwd": ("gl", "_launch_fwd", "gather_linear"),
    "K5 bwd": ("gl", "_launch_bwd", "gather_linear"),
    "K10/K11 fwd": ("gl", "_launch_r_fwd", "gather_linear"),
    "K10/K11 bwd": ("gl", "_launch_r_bwd", "gather_linear"),
}
# forced builds of csrc/onehot_spmm.cu: each must give the shipped build's
# bits (a column's sum does not depend on the load width or the lanes a
# row)
SPMM_VARIANTS = {"4-byte loads": {"CGR_SPMM_VEC_BYTES": 4},
                 "one row a warp": {"CGR_SPMM_LANES": 32}}
# the function through which every K7 call launches (forward, backward)
SPMM_LAUNCHES = {"K7": ("os", "_run", "onehot_spmm")}
# kernels not redesigned here, recorded where the main paths and the
# kernel phases launch them and held beside the parent's build (K3f in its
# own phase): the conv layer, with one launch a call of K6 and K8/K9, and
# K2/K3b.  K8's with a scale is K9's
UNMOVED_LAUNCHES = {
    "K6 fwd": ("fc", "_launch_fwd", "fused_conv"),
    "K6 bwd": ("fc", "_launch_bwd", "fused_conv"),
    "K8 fwd": ("fc", "_launch_r_fwd", "fused_conv"),
    "K8 bwd": ("fc", "_launch_r_bwd", "fused_conv"),
    "K4 fwd": ("cs", "_launch_fwd", "conv_stack"),
    "K4 bwd": ("cs", "_launch_bwd", "conv_stack"),
    "K2/K3b": ("fm", "_backward", "fused_model_bwd"),
}


def _cloned(v):
    import torch
    if torch.is_tensor(v):
        return v.detach().clone()
    if isinstance(v, (tuple, list)):
        return type(v)(_cloned(x) for x in v)
    if isinstance(v, dict):
        return {k: _cloned(x) for k, x in v.items()}
    return v


def _shapes(v):
    import torch
    if torch.is_tensor(v):
        return (tuple(v.shape), str(v.dtype), v.is_cuda)
    if isinstance(v, (tuple, list)):
        return tuple(_shapes(x) for x in v)
    if isinstance(v, dict):
        return tuple((k, _shapes(x)) for k, x in sorted(v.items()))
    return v if isinstance(v, (int, float, str, bool, type(None))) else None


class LaunchRecorder:
    """Records the inputs of the first card launch of each kernel, dtype,
    activation, mode and shape that runs while it is active, through the
    wrappers' launch functions ``targets`` ({kernel: (module, function,
    library)}), at most ``limit`` of them: {key: (launch function, library,
    args, kwargs, module name, function name)}, key[0] the kernel (K9 for
    K8 with a scale, K10 or K11 for K10/K11 by its pool)."""

    def __init__(self, targets: dict, limit: int = 12):
        self.targets, self.limit, self.calls = targets, limit, {}

    def _modules(self) -> dict:
        from cgr_mpnn_3d_tpu_torch.ops import onehot_spmm
        return dict(_ep_modules(), os=onehot_spmm)

    def __enter__(self):
        mods = self._modules()
        self._orig = {}
        for kernel, (mod, fn, lib) in self.targets.items():
            orig = getattr(mods[mod], fn)
            self._orig[kernel] = (mods[mod], fn, orig)

            def rec(*a, _orig=orig, _kernel=kernel, _lib=lib, _fn=fn,
                    _mod=mods[mod].__name__.rsplit(".", 1)[1], **kw):
                # the dropout seeds change from call to call, the work not
                sh = _shapes((a, {k: v for k, v in kw.items()
                                  if k not in ("seed", "seeds")}))
                name = _kernel
                if kw.get("scale") is not None:
                    name = _kernel.replace("K8", "K9")
                if kw.get("act") == "linear":
                    name = _kernel.replace("K6", "K6 linear")
                name = name.replace("K10/K11", "K10" if kw.get("pool_ell")
                                    is None else "K11")
                key = (name, kw.get("mat_dtype"), kw.get("act"),
                       kw.get("mean"), kw.get("train"), sh)
                if ("True" in str(sh) and key not in self.calls
                        and len(self.calls) < self.limit):
                    self.calls[key] = (_orig, _lib, _cloned(a), _cloned(kw),
                                       _mod, _fn)
                return _orig(*a, **kw)
            setattr(mods[mod], fn, rec)
        return self

    def __exit__(self, *exc):
        for mod, fn, orig in self._orig.values():
            setattr(mod, fn, orig)


# the CUDA API calls that launch a kernel (cudaLaunch*, cuLaunch*), as
# torch.profiler names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel",
                "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cuLaunchCooperativeKernel")


def kernel_launches(fn, calls: int = 3) -> float:
    """The kernels a call of ``fn`` launches, as torch.profiler records
    them: its kernel-launch runtime calls over ``calls`` calls, in the
    active step of a profile whose warm-up step (two calls of ``fn``, at
    least 50 ms) starts the tracer."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        t0, n = time.perf_counter(), 0
        while n < 2 or time.perf_counter() - t0 < 0.05:
            fn()
            torch.cuda.synchronize()
            n += 1
        prof.step()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        prof.step()
    return sum(e.count for e in prof.key_averages()
               if e.key in LAUNCH_CALLS) / calls


def device_ms(fn, calls: int = 10) -> float:
    """The device time of one call of ``fn``, median of ``calls``: CUDA
    events around the call, queued behind a ~1 ms spin of the card so that
    the host has launched everything before the first event runs (the
    card's time for the call, without the host's)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out = []
    for _ in range(calls):
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def _outputs(v) -> list:
    """The tensors of a result, nested tuples flattened, Nones left out."""
    if isinstance(v, (tuple, list)):
        return [t for x in v for t in _outputs(x)]
    return [] if v is None else [v]


def _same(a, b) -> bool:
    import torch
    x, y = _outputs(a), _outputs(b)
    return len(x) == len(y) and all(torch.equal(u, w) for u, w in zip(x, y))


def _max_diff(a, b) -> float:
    return max((float((u.double() - w.double()).abs().max())
                for u, w in zip(_outputs(a), _outputs(b))), default=0.0)


def glin_cost_of(kernel: str, a: tuple, kw: dict) -> tuple:
    """The (products, other operations, bytes) of a recorded K5, K10 or
    K11 launch (glin_cost, glin_r_cost): K5 over its output rows with an
    entry in their pack (edge_init: the real edges) and every row of
    xa."""
    from types import SimpleNamespace

    from cgr_mpnn_3d_tpu_torch.ops.segment import in_pack
    bwd, p = kernel.endswith("bwd"), kw["p"]
    if kernel.startswith("K5"):
        xa, xb, idx = a[:3]
        wa = a[4] if bwd else a[3]
        rows = int(in_pack(idx, p, xa.shape[0])[1].any(dim=1).sum())
        return glin_cost(xa, xb, idx, wa, p, rows, xa.shape[0],
                         a[3] if bwd else None,
                         2 if kw.get("out_dtype") == BF16 else 4)
    xa, xr, xb, idx = a[:4]
    adj = a[4] if bwd else None
    ns = SimpleNamespace(node_inc=idx, pool_ell=kw.get("pool_ell"),
                         node_group=kw.get("node_group"),
                         dst=None if adj is None else adj.reshape(-1))
    return glin_r_cost(xa, xr, xb, ns, a[5] if bwd else a[4], p, bwd,
                       kernel.startswith("K11"))


def glin_plain(kernel: str, a: tuple, kw: dict):
    """The plain version of a recorded K5, K10 or K11 launch on its inputs:
    the outputs the launch returns (a backward's wanted cotangents)."""
    from cgr_mpnn_3d_tpu_torch.ops import gather_linear as gl
    k = {n: kw[n] for n in ("p", "act", "mean", "mat_dtype")}
    needs = kw.get("needs")
    if kernel == "K5 fwd":
        return gl.gather_linear_forward_ref(*a, **k,
                                            out_dtype=kw["out_dtype"])
    if kernel == "K5 bwd":
        grads = gl.gather_linear_backward_ref(*a, **k,
                                              out_dtype=kw["out_dtype"])
    elif kernel == "K10 fwd":
        return gl.gather_linear_r_forward_ref(*a, **k)
    elif kernel == "K11 fwd":
        xa, xr, xb, idx, wa, wb, b = a
        return gl.gather_linear_pool_forward_ref(
            xa, xr, xb, idx, kw["node_group"], kw["pool_ell"], wa, wb, b, **k)
    elif kernel == "K10 bwd":
        grads = gl.gather_linear_r_backward_ref(*a, **k)
    else:
        xa, xr, xb, idx, adj, wa, wb, b, out, g = a
        grads = gl.gather_linear_pool_backward_ref(
            xa, xr, xb, idx, adj, kw["node_group"], kw["pool_ell"], wa, wb, b,
            out, g, kw["gpool"], **k)
    return [d for d, need in zip(grads, needs) if need]


def glin_held(e: dict, name: str, kernel: str, got, a: tuple, kw: dict,
              launch):
    """A recorded K5, K10 or K11 launch's outputs against its plain
    version, by PERF.md section 2's bounds: f32 at REL_TOL (ReLU gradients
    by hold's float64 rule, with the count of ReLU masks that differ
    between the kernel's ``out`` input and the plain version's recomputed
    pre-activation); bf16 by hold_bf16 against the bf16 and f32 plain
    versions, with ``launch`` (the launch function) at f32 on f32 copies as
    its control (a backward's ``out`` from the f32 plain forward, so that
    the control's ReLU masks are the f32 plain version's), and each
    gradient on its own at cosine >= BF16_COS.
    Returns the float64 evaluation where the rule took one, else None."""
    import torch
    got, want = _outputs(got), _outputs(glin_plain(kernel, a, kw))
    check(len(got) == len(want) and all(bool(torch.isfinite(t).all())
                                        for t in got),
          f"{name}: {len(got)} outputs against the plain version's "
          f"{len(want)}, or not finite")
    bwd = kernel.endswith("bwd")

    def cast(v, dtype):
        return v.to(dtype) if torch.is_tensor(v) and \
            v.is_floating_point() else v
    res: dict = {}
    if kw["mat_dtype"] != BF16:
        relu = bwd and kw["act"] == "relu"
        k64 = {n: cast(v, torch.float64) for n, v in kw.items()}
        ex: list = []

        def exact():
            ex.append(_outputs(glin_plain(
                kernel, tuple(cast(v, torch.float64) for v in a), k64)))
            return ex[0]
        hold(res, name, got, want, relu, exact)
        e.update(res[name])
        if relu:    # the ReLU masks: the kernel reads out > 0
            k5 = kernel.startswith("K5")
            fa = a[:3] + a[4:7] if k5 else a[:4] + a[5:8]
            pre = _outputs(glin_plain(kernel.replace("bwd", "fwd"), fa,
                                      kw))[0]
            out = a[7 if k5 else 8]
            e["relu_flips"] = (int(((pre > 0) != (out > 0)).sum()),
                               out.numel())
        return ex[0] if ex else None
    a32 = tuple(cast(v, torch.float32) for v in a)
    kw32 = {n: cast(v, torch.float32) for n, v in kw.items()}
    kw32.update(mat_dtype="float32", **({"out_dtype": "float32"}
                                        if "out_dtype" in kw else {}))
    if bwd:     # the control's out from the f32 forward, as its masks
        k5 = kernel.startswith("K5")
        fa = a32[:3] + a32[4:7] if k5 else a32[:4] + a32[5:8]
        at = 7 if k5 else 8
        a32 = a32[:at] + (_outputs(glin_plain(
            kernel.replace("bwd", "fwd"), fa, kw32))[0],) + a32[at + 1:]
    with torch.no_grad():
        ctrl = _outputs(launch(*a32, **kw32))
    hold_bf16(res, name, got, want, _outputs(glin_plain(kernel, a32, kw32)),
              ctrl, grads=bwd)
    e.update(res[name])
    if bwd:
        e["cos_each"] = [1.0 if not (g.any() or w.any()) else cosine([g], [w])
                         for g, w in zip(got, want)]
        check(min(e["cos_each"]) >= BF16_COS,
              f"bf16 {name}: gradient cosines {e['cos_each']} to the bf16 "
              f"plain version, each on its own")
    return None


def host_ms(fn, calls: int = 50) -> float:
    """The host's ms a call of ``fn``: the wall time of ``calls`` calls
    queued without waiting for the card (the launches are asynchronous),
    then the card drained."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def held_beside_parent(recorded: dict, builds: dict, repeats: int,
                       card: str, parent: Path | None = None,
                       glin: bool = False) -> dict:
    """Every recorded launch (LaunchRecorder) replayed: a rerun bit for
    bit; with ``glin`` (K5, K10, K11) each forced build of GLIN_VARIANTS
    bit for bit, the plain version by glin_held, one kernel launch a call
    (torch.profiler), the wrapper's host ms a call and the bound of the
    call's work; with ``parent`` (an earlier commit's csrc/) that commit's
    build of its library (``builds["<library> earlier"]``) through that
    commit's own wrapper (parent_wrapper) bit for bit, and the ms of both
    over ``repeats`` calls in 5 alternating rounds and by device time."""
    import torch
    from cgr_mpnn_3d_tpu_torch.ops import gather_linear as gl
    out = {}
    for label, rec in recorded.items():
        for key, (fn, lib, a, kw, mod, fname) in rec.calls.items():
            kernel, md = key[0], key[1] or "float32"

            def call(fn=fn, a=a, kw=kw):
                with torch.no_grad():
                    return fn(*a, **kw)
            rows = a[0].shape[0] if torch.is_tensor(a[0]) else None
            widths = ""
            if glin:    # the output rows, and the widths of xa and xb
                xa, xb = a[0], a[1 if kernel.startswith("K5") else 2]
                rows = xb.shape[0]
                widths = f" FA {xa.shape[1]} + FB {xb.shape[1]}"
            name = (f"{kernel} {md} {kw.get('act', '')}"
                    + (" mean" if kw.get("mean") else "") + widths
                    + (f" {'train' if kw.get('train') else 'eval'}"
                       if "train" in kw else "")
                    + f", {label}, {kw.get('p')} packs"
                    + (f", {rows} rows" if rows else ""))
            got = call()
            check(_same(got, call()), f"{name}: two runs differ")
            e: dict = dict(kernel=kernel, label=label, dtype=md, rows=rows)
            if kernel.split()[0] in ("K6", "K8", "K9"):
                e["launches"] = kernel_launches(call)
                check(e["launches"] == 1,
                      f"{name}: {e['launches']} kernel launches a call")
            if glin:
                for vname in GLIN_VARIANTS:
                    vlib = builds[f"gather_linear {vname}"]()
                    check(_same(got, swapped(lib, vlib, call)),
                          f"{name}: the {vname} build differs")
                ex = glin_held(e, name, kernel, got, a, kw, fn)
                e["launches"] = kernel_launches(call)
                check(e["launches"] == 1,
                      f"{name}: {e['launches']} kernel launches a call")
                e["host_ms"] = host_ms(call)
                e["bound_ms"], e["bound_by"] = bound(
                    glin_cost_of(kernel, a, kw), md == BF16)
                k5, bwd = kernel.startswith("K5"), kernel.endswith("bwd")
                wa = a[(3 if k5 else 4) + bwd]
                e["grid"] = gl.glin_grid(kw["p"], xb.shape[0] // kw["p"],
                                         a[0].shape[1], xb.shape[1],
                                         wa.shape[1], md, bwd)
            fns = {"shipped": call}
            par = builds.get(f"{lib} earlier")
            if parent is not None and par is not None:
                plib, pfn = par(), getattr(parent_wrapper(parent, mod), fname)

                def pcall(pfn=pfn, plib=plib, lib=lib, a=a, kw=kw):
                    with torch.no_grad():
                        return swapped(lib, plib, lambda: pfn(*a, **kw))
                theirs = pcall()
                e["parent_equal"] = _same(got, theirs)
                e["parent_diff"] = _max_diff(got, theirs)
                check(e["parent_equal"], f"{name}: differs from the parent's "
                                         f"build by {e['parent_diff']:.3e}")
                if glin:
                    e["parent_launches"] = kernel_launches(pcall)
                    if ex is not None:
                        e["parent_l1_64"] = l1(_outputs(theirs), ex)
                fns["parent"] = pcall
            if repeats:
                ms = alternating_ms(fns, repeats)
                e["rounds"] = ms
                e["ms"] = statistics.median(ms["shipped"])
                if "parent" in ms:
                    e["parent_ms"] = statistics.median(ms["parent"])
                e["device_ms"] = {n: device_ms(f) for n, f in fns.items()}
            out[name] = e
            line = f"{name}: reruns"
            if not glin and "launches" in e:
                line += f", {e['launches']:g} kernel launches a call"
            if glin:
                line += (f" and {len(GLIN_VARIANTS)} forced builds equal, "
                         f"grid {e['grid'][0]} blocks of {e['grid'][1]}-row "
                         f"tiles ({e['grid'][2]} an SM), "
                         f"{e['launches']:g} kernel launches a call; plain "
                         f"max abs err {e['abs_err']:.3e}")
                if "rel_err" in e:
                    line += f" rel {e['rel_err']:.3e}"
                if "l1_64" in e:
                    line += (f", L1 vs float64 kernel {e['l1_64'][0]:.3e} "
                             f"plain {e['l1_64'][1]:.3e}"
                             + (f" parent {e['parent_l1_64']:.3e}"
                                if "parent_l1_64" in e else "")
                             + f", ReLU masks of out unlike the plain "
                             f"version's pre {e['relu_flips'][0]} of "
                             f"{e['relu_flips'][1]}")
                if "share" in e:
                    line += (f" rel-L2 {e['rel_l2']:.3e} (to f32 plain "
                             f"{e['f32_rel_l2']:.3e}, share {e['share']:.4g}"
                             f", f32 control's {e['control_share']:.4g})")
                if "cos_each" in e:
                    line += " cos each " + ", ".join(
                        f"{c:.6f}" for c in e["cos_each"])
            if "parent_equal" in e:
                line += (f"; the parent's build equal: {e['parent_equal']}"
                         + (f" ({e['parent_launches']:g} launches)"
                            if glin else ""))
            if "ms" in e:
                line += (f"; ms (median of 5 alternating rounds, min-max) "
                         + "; ".join(f"{n} {statistics.median(v):.4f} "
                                     f"({min(v):.4f}-{max(v):.4f})"
                                     for n, v in e["rounds"].items()))
            if "device_ms" in e:
                line += "; device ms a call (behind a spin) " + ", ".join(
                    f"{n} {v:.4f}" for n, v in e["device_ms"].items())
            if "host_ms" in e:
                line += f"; host ms a call {e['host_ms']:.4f}"
            if "bound_ms" in e:
                line += f"; bound {e['bound_ms']:.4f} by {e['bound_by']}"
            print(line + f" [{card}]")
    return out


def spmm_held(recorded: dict, builds: dict, repeats: int, card: str,
              parent: Path | None = None) -> dict:
    """Every recorded K7 launch (LaunchRecorder on the wrapper's ``_run``:
    src, idx, sign, p, mat and a bf16 d_src's flag) replayed: a rerun and
    each forced build of SPMM_VARIANTS bit for bit; the plain version at
    REL_TOL (the kernel and the plain version round the same operands and
    sum them in another order; a bf16 d_src within one bf16 rounding, 2^-8
    of its largest value); one kernel launch a call (torch.profiler); the
    kernel's launch plan equal to the wrapper's mirror; the bound of the
    call's work (spmm_cost); with ``parent`` (an earlier commit's csrc/)
    that commit's build through its own wrapper bit for bit (a bf16 d_src:
    its f32 result cast, as its backward did).  With ``repeats``: device ms
    a call behind a spin (shipped, parent with its cast, embedding_bag over
    the same sum), the public call (``onehot_spmm``) by CUDA events over
    ``repeats`` calls in 5 alternating rounds beside the parent's and
    embedding_bag's, and the host ms a call of both wrappers."""
    import torch
    from cgr_mpnn_3d_tpu_torch.ops import onehot_spmm as sp
    from cgr_mpnn_3d_tpu_torch.tools.k7_host import library_call
    out = {}
    for label, rec in recorded.items():
        for key, (fn, lib, a, kw, mod, fname) in rec.calls.items():
            src, idx, sign, p, mat = a[:5]
            out_bf16 = bool(a[5] if len(a) > 5 else kw.get("out_bf16"))
            md = BF16 if mat else "float32"

            def call(fn=fn, a=a, kw=kw):
                with torch.no_grad():
                    return fn(*a, **kw)
            rows, D = idx.shape
            name = (f"K7 {md} {str(src.dtype)[6:]} src [{src.shape[0]}, "
                    f"{src.shape[1]}] ({src.shape[1] * src.element_size()} "
                    f"B rows), {rows} rows of D {D}"
                    + (" - sign" if sign is not None else "")
                    + (", bf16 d_src" if out_bf16 else "")
                    + f", {label}, {p} packs")
            got = call()
            check(_same(got, call()), f"{name}: two runs differ")
            for vname in SPMM_VARIANTS:
                vlib = builds[f"onehot_spmm {vname}"]()
                check(_same(got, swapped(lib, vlib, call)),
                      f"{name}: the {vname} build differs")
            want = sp.onehot_spmm_ref(src, idx, sign, p=p, mat_dtype=md)
            e: dict = dict(kernel="K7", label=label, dtype=md, rows=rows,
                           D=D, width=src.shape[1],
                           row_bytes=src.shape[1] * src.element_size())
            e["abs_err"] = float((got.double() - want.double()).abs().max())
            e["rel_err"] = e["abs_err"] / max(float(want.abs().max()), 1e-30)
            check(bool(torch.isfinite(got).all())
                  and e["rel_err"] <= (2.0 ** -8 if out_bf16 else REL_TOL),
                  f"{name}: kernel vs plain relative error "
                  f"{e['rel_err']:.3e}")
            e["launches"] = kernel_launches(call)
            check(e["launches"] == 1,
                  f"{name}: {e['launches']} kernel launches a call")
            sizes = (src.element_size(), got.element_size())
            e["plan"] = sp.kernel_plan(rows, src.shape[1], *sizes,
                                       src.data_ptr(), got.data_ptr())
            check(e["plan"] == sp.launch_plan(rows, src.shape[1], *sizes,
                                              src.data_ptr(),
                                              got.data_ptr()),
                  f"{name}: the kernel's plan {e['plan']} is not the "
                  f"wrapper's mirror")
            e["bound_ms"], e["bound_by"] = bound(
                spmm_cost(src, idx, sign, p, got.element_size()), False)
            bag = library_call(src, idx, sign, p, md)

            def public(src=src, idx=idx, sign=sign, p=p, md=md):
                with torch.no_grad():
                    return sp.onehot_spmm(src, idx, sign, p=p, mat_dtype=md)
            dev_fns, call_fns = {"shipped": call}, {"shipped": public}
            host_fns = {"shipped": public}
            par = builds.get(f"{lib} earlier")
            if parent is not None and par is not None:
                pmod = parent_bound(parent, mod, lib, par())

                def pcall(pmod=pmod, a=a, md=md, ob=out_bf16):
                    with torch.no_grad():
                        y = pmod._launch(*a[:4], md)
                        return y.to(torch.bfloat16) if ob else y

                def ppublic(pmod=pmod, src=src, idx=idx, sign=sign, p=p,
                            md=md):
                    with torch.no_grad():
                        return pmod.onehot_spmm(src, idx, sign, p=p,
                                                mat_dtype=md)
                theirs = pcall()
                e["parent_equal"] = _same(got, theirs)
                e["parent_diff"] = _max_diff(got, theirs)
                check(e["parent_equal"], f"{name}: differs from the parent's "
                                         f"build by {e['parent_diff']:.3e}")
                dev_fns["parent"], call_fns["parent"] = pcall, ppublic
                host_fns["parent"] = ppublic
            dev_fns["embedding_bag"] = call_fns["embedding_bag"] = bag
            if repeats:
                e["device_ms"] = {n: device_ms(f) for n, f in dev_fns.items()}
                e["rounds"] = alternating_ms(call_fns, repeats)
                e["call_ms"] = {n: statistics.median(v)
                                for n, v in e["rounds"].items()}
                e["host_ms"] = {n: host_ms(f) for n, f in host_fns.items()}
            out[name] = e
            line = (f"{name}: reruns and {len(SPMM_VARIANTS)} forced builds "
                    f"equal, plan {e['plan'][0]} elements a chunk, "
                    f"{e['plan'][1]} lanes a row, {e['plan'][3]} blocks, "
                    f"{e['launches']:g} kernel launches a call; plain max "
                    f"abs err {e['abs_err']:.3e} rel {e['rel_err']:.3e}")
            if "parent_equal" in e:
                line += f"; the parent's build equal: {e['parent_equal']}"
            if "device_ms" in e:
                line += "; device ms a call (behind a spin) " + ", ".join(
                    f"{n} {v:.4f}" for n, v in e["device_ms"].items())
                line += ("; call ms by events (median of 5 alternating "
                         "rounds, min-max) " + "; ".join(
                             f"{n} {statistics.median(v):.4f} "
                             f"({min(v):.4f}-{max(v):.4f})"
                             for n, v in e["rounds"].items()))
                line += "; host ms a call " + ", ".join(
                    f"{n} {v:.4f}" for n, v in e["host_ms"].items())
            line += f"; bound {e['bound_ms']:.4f} by {e['bound_by']}"
            print(line + f" [{card}]")
    return out


def k7_host_phase(card: str, parent: Path | None = None) -> dict:
    """tools/k7_host.py: the wrapper's host time step by step on the
    layered pooling at p = 4, f32 and bf16, and with ``parent`` the earlier
    commit's wrapper's beside it; every step a positive time."""
    from cgr_mpnn_3d_tpu_torch.tools import k7_host
    argv = ["--calls", "1000"]
    if parent is not None:
        argv += ["--parent", str(parent)]
    print(f"tools/k7_host.py [{card}]:")
    res = k7_host.main(argv)
    check(all(v > 0 for r in res.values() for v in r.values()),
          f"tools/k7_host.py: {res}")
    return res


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


def device_busy(fn, top: int = 3) -> tuple[float, float, list]:
    """(wall ms, device busy ms, the ``top`` (kernel, ms) by device time)
    of one call of ``fn`` under torch.profiler; device busy is the sum of
    the CUDA kernel and copy times it records."""
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
            [(k[:40], round(ms, 3)) for k, ms in dev[:top]])


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
                graphs_per_s=n / wall, ckpt=ckpt, singles=singles)


def _smiles_of(path: Path) -> list[str]:
    with open(path, newline="") as f:
        return [row[0] for row in list(csv.reader(f))[1:] if row]


def _same_batches(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x._fields == y._fields and all(
            np.asarray(u).dtype == np.asarray(v).dtype
            and np.array_equal(np.asarray(u), np.asarray(v))
            for u, v in zip(x, y)) for x, y in zip(a, b))


def native_phase(tmp: Path, seed: int, card: str) -> dict:
    """The native C++ featurizer and packer on the card's host against
    their Python twins: featurization of the corpus and the demo set (index
    arrays equal, features within NATIVE_TOL), ``pack_graphs_native`` and
    ``place_graphs_native`` against ``pack_graphs`` / ``place_graphs`` on
    the corpus with descriptors and row ids, ``pack_epoch_native`` (the
    reused-packs cache) against per-window iteration, native and Python,
    and parallel packing against serial, all bit for bit; featurize us a
    reaction and epoch pack ms of each, alternating over 3 rounds."""
    from cgr_mpnn_3d_tpu_torch import native
    from cgr_mpnn_3d_tpu_torch.chem import RxnGraph
    from cgr_mpnn_3d_tpu_torch.data import (ChemDataset, PackedLoader,
                                            pack_graphs, packs_needed,
                                            place_graphs, plan_spec)
    from cgr_mpnn_3d_tpu_torch.data.descriptors import \
        synthetic_descriptors_npz
    lib = native.build()
    # the g++ build a fresh checkout pays once (the package's own library
    # is built by the phases before this one)
    t0 = time.perf_counter()
    native.build(build_dir=tmp / "native_build")
    build_s = time.perf_counter() - t0
    corpus = ROOT / "tests" / "corpus_reactions.csv"
    demo = ROOT / "examples" / "demo.csv"
    out: dict = {"phase": "native", "card": card, "library": lib.name,
                 "build_s": build_s}
    for name, path in (("corpus", corpus), ("demo", demo)):
        smiles = _smiles_of(path)
        worst, bits = 0.0, True
        for smi in smiles:
            a, b = native.featurize(smi), RxnGraph(smi).arrays
            for f in ("senders", "receivers", "rev_edge_index"):
                check(np.array_equal(getattr(a, f), getattr(b, f)),
                      f"native {f} differs from Python on {smi}")
            for f in ("node_feats", "edge_feats"):
                x, y = getattr(a, f), getattr(b, f)
                check(x.shape == y.shape, f"native {f} shape on {smi}")
                if x.size:
                    worst = max(worst, float(np.abs(x - y).max()))
                bits = bits and np.array_equal(x, y)
        check(worst <= NATIVE_TOL, f"native features differ from Python "
                                   f"by {worst:.3e} on {name}")
        us = {"native": [], "python": []}
        for _ in range(3):
            for kind, fn in (("native", native.featurize),
                             ("python", lambda smi: RxnGraph(smi).arrays)):
                t0 = time.perf_counter()
                for smi in smiles:
                    fn(smi)
                us[kind].append((time.perf_counter() - t0) * 1e6
                                / len(smiles))
        out[name] = {"reactions": len(smiles), "max_abs_err": worst,
                     "bit_for_bit": bits, "featurize_us": us,
                     "speedup": statistics.median(us["python"])
                     / statistics.median(us["native"])}

    # one window: all 300 corpus graphs with descriptor blocks and row ids
    graphs = [native.featurize(smi) for smi in _smiles_of(corpus)]
    rng = np.random.default_rng(seed)
    extra = [rng.random((g.num_nodes, 64)).astype(np.float32)
             for g in graphs]
    labels = rng.normal(size=len(graphs)).astype(np.float32)
    rows = rng.permutation(10 * len(graphs))[:len(graphs)]
    spec = plan_spec(graphs)
    p = packs_needed(graphs, spec)
    while not place_graphs(graphs, spec.with_packs(p)):
        check(not native.place_graphs_native(graphs, spec.with_packs(p)),
              f"native placement accepts {p} packs, Python refuses")
        p += 1
    check(native.place_graphs_native(graphs, spec.with_packs(p)),
          f"native placement refuses {p} packs, Python accepts")
    spec = spec.with_packs(p)
    pack_ms = {"native": [], "python": []}
    for _ in range(3):
        for kind, fn in (("native", native.pack_graphs_native),
                         ("python", pack_graphs)):
            t0 = time.perf_counter()
            b = fn(graphs, labels, spec, extra, row_ids=rows)
            pack_ms[kind].append((time.perf_counter() - t0) * 1e3)
            out.setdefault("window", {})[kind] = b
    check(_same_batches([out["window"]["native"]],
                        [out["window"]["python"]]),
          "pack_graphs_native differs from pack_graphs")
    out["window"] = {"graphs": len(graphs), "packs": p, "ms": pack_ms}

    # the epoch: the reused-packs cache in one native call against
    # per-window iteration (native and Python)
    synthetic_descriptors_npz(corpus, tmp / "native.npz", 64, seed=seed)
    ds = {kind: ChemDataset(str(corpus), data_npz_path=str(tmp / "native.npz"),
                            use_native=kind == "native")
          for kind in ("native", "python")}
    for d in ds.values():
        d.prefeaturize()
    espec = plan_spec([ds["native"].graph(i) for i in range(300)])
    kw = dict(batch_size=64, shuffle=True, seed=seed)
    epoch_ms = {"pack_epoch_native": [], "native": [], "python": []}
    got = {}
    for _ in range(3):
        t0 = time.perf_counter()
        ld = PackedLoader(ds["native"], espec, reuse_packs=True, **kw)
        next(iter(ld))
        epoch_ms["pack_epoch_native"].append(
            (time.perf_counter() - t0) * 1e3)
        got["pack_epoch_native"] = ld._pack_cache
        for kind, make in (
                ("native", lambda: PackedLoader(ds["native"], espec, **kw)),
                ("python", lambda: PackedLoader(ds["python"], espec,
                                                use_native=False, **kw))):
            t0 = time.perf_counter()
            got[kind] = list(make().prefetch())
            epoch_ms[kind].append((time.perf_counter() - t0) * 1e3)
    for kind in ("native", "python"):
        check(_same_batches(got["pack_epoch_native"], got[kind]),
              f"pack_epoch_native differs from {kind} per-window packing")
    out["epoch"] = {"windows": len(got["native"]), "p": ld.spec.p,
                    "ms": epoch_ms}
    print(f"native: {lib.name}, a fresh build {build_s:.3f} s; featurize vs "
          f"Python: corpus max abs err {out['corpus']['max_abs_err']:.3e} "
          f"(bit for bit {out['corpus']['bit_for_bit']}), demo "
          f"{out['demo']['max_abs_err']:.3e}; us a reaction (3 rounds) "
          f"native {out['corpus']['featurize_us']['native']}, Python "
          f"{out['corpus']['featurize_us']['python']} "
          f"({out['corpus']['speedup']:.1f}x); pack_graphs_native = "
          f"pack_graphs on {len(graphs)} graphs in {p} packs, ms {pack_ms}; "
          f"pack_epoch_native = per-window native and Python "
          f"over {len(got['native'])} windows, epoch ms {epoch_ms} [{card}]")
    print(json.dumps(out, default=float))
    return out


def load_model_split(ckpt: Path, repeats: int = 5) -> dict:
    """Median ms of ``load_model``'s parts (``train/evaluate.py``): reading
    the checkpoint, building the model, ``restore_into`` and ``.to()``,
    and of the whole call, over ``repeats`` rounds."""
    import torch
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNN
    from cgr_mpnn_3d_tpu_torch.train import (load_checkpoint, load_model,
                                             restore_into)
    from cgr_mpnn_3d_tpu_torch.train.evaluate import model_config
    parts: dict = {k: [] for k in ("load_checkpoint", "model build",
                                   "restore_into", ".to(device)",
                                   "load_model")}
    for _ in range(repeats):
        t0 = time.perf_counter()
        leaves, meta = load_checkpoint(ckpt)
        t1 = time.perf_counter()
        model = CGRMPNN(model_config(meta))
        t2 = time.perf_counter()
        restore_into(model, leaves[:len(model.state_dict())])
        t3 = time.perf_counter()
        model.to(DEVICE).eval()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        load_model(ckpt, DEVICE)
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        for k, a, b in (("load_checkpoint", t0, t1), ("model build", t1, t2),
                        ("restore_into", t2, t3), (".to(device)", t3, t4),
                        ("load_model", t4, t5)):
            parts[k].append((b - a) * 1e3)
    return {k: statistics.median(v) for k, v in parts.items()}


def serve_native(tmp: Path, srv: dict, card: str) -> dict:
    """The serving entry point with native featurization against the
    Python twin (``use_native=True`` / ``False``), alternating over 3
    rounds: 10 single requests and the corpus request each, predictions
    within REL_TOL of each other; the device busy share of a corpus
    request of each; the corpus request's stages and ``load_model``'s
    parts."""
    import torch
    from cgr_mpnn_3d_tpu_torch.cli.predict import activation_energy_prediction
    from cgr_mpnn_3d_tpu_torch.data import ChemDataset, PackedLoader, plan_spec
    from cgr_mpnn_3d_tpu_torch.ops import fused_model as fm
    from cgr_mpnn_3d_tpu_torch.train import load_model, predict
    corpus = ROOT / "tests" / "corpus_reactions.csv"
    corpus_npz = tmp / "corpus.npz"

    def request(csv_path, npz_path, use_native):
        t0 = time.perf_counter()
        res = activation_energy_prediction(
            str(csv_path), output_results=str(tmp / "results.txt"),
            model_path=str(srv["ckpt"]), npz_path=str(npz_path),
            device=DEVICE, use_native=use_native)
        torch.cuda.synchronize()
        return (np.array([r["Activation Energy"] for r in res]),
                time.perf_counter() - t0)

    kinds = {"native": True, "python": False}
    latency = {k: [] for k in kinds}
    gps = {k: [] for k in kinds}
    preds = {}
    counts = {k: 0 for k in kinds}
    # the main path: counts are zeroed just before it and read just after
    fm.launches = 0
    for _ in range(3):
        for kind, use_native in kinds.items():
            before = fm.launches
            single = [request(c, z, use_native) for c, z in srv["singles"]]
            whole, wall = request(corpus, corpus_npz, use_native)
            counts[kind] += fm.launches - before
            latency[kind].append(
                statistics.median(t for _, t in single) * 1e3)
            gps[kind].append(len(whole) / wall)
            preds[kind] = np.concatenate([whole, *(v for v, _ in single)])
    launches = fm.launches
    check(launches == sum(counts.values()) and
          counts["native"] == counts["python"] >= 3 * 11,
          f"forward-kernel launches {counts} (total {launches}) for 3 "
          f"rounds of 10 single requests and the corpus request each")
    check(all(np.isfinite(v).all() and v.shape == (310,)
              for v in preds.values()), "predictions are not finite")
    scale = max(float(np.abs(preds["python"]).max()), 1e-30)
    rel = float(np.abs(preds["native"] - preds["python"]).max()) / scale
    check(rel <= REL_TOL, f"native vs Python predictions differ by "
                          f"{rel:.3e}")
    busy = {}
    for kind, use_native in kinds.items():
        wall_ms, dev_ms, top = device_busy(
            lambda: request(corpus, corpus_npz, use_native))
        busy[kind] = {"wall_ms": wall_ms, "device_ms": dev_ms,
                      "busy_pct": 100 * dev_ms / wall_ms}
    # the corpus request's stages, native featurization
    stages: dict = {k: [] for k in ("load_model", "read + featurize",
                                    "pack (loader)", "predict")}
    for _ in range(3):
        t0 = time.perf_counter()
        model, _, _ = load_model(srv["ckpt"], DEVICE)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ds = ChemDataset(str(corpus), data_npz_path=str(corpus_npz))
        ds.prefeaturize()
        t2 = time.perf_counter()
        spec = plan_spec([ds.graph(i) for i in range(len(ds))])
        list(PackedLoader(ds, spec, batch_size=64))
        t3 = time.perf_counter()
        predict(model, ds, spec, 64, DEVICE)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for k, a, b in (("load_model", t0, t1), ("read + featurize", t1, t2),
                        ("pack (loader)", t2, t3), ("predict", t3, t4)):
            stages[k].append((b - a) * 1e3)
    stages = {k: statistics.median(v) for k, v in stages.items()}
    split = load_model_split(srv["ckpt"])
    out = {"phase": "serve native vs python", "card": card,
           "latency_ms": latency, "graphs_per_s": gps,
           "rel_err": rel, "launches": launches, "busy": busy,
           "corpus_stages_ms": stages, "load_model_ms": split}
    print(f"serve native vs Python (3 alternating rounds): single-request "
          f"latency median ms native {latency['native']}, Python "
          f"{latency['python']}; corpus graphs/s native {gps['native']}, "
          f"Python {gps['python']}; predictions rel err {rel:.3e}; busy "
          f"native {busy['native']['busy_pct']:.2f}%, Python "
          f"{busy['python']['busy_pct']:.2f}%; corpus request stages ms "
          f"{stages}; load_model split ms {split} [{card}]")
    print(json.dumps(out, default=float))
    return out


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
    trn = dict(launches=launches, rel=rel, steps=card_res["steps"],
               steps_per_s=steps_per_s)

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
    return trn


def _cli_run(run_dir: Path, data: Path, seed: int, device: str,
             epochs: int, *extra: str) -> dict:
    """One ``cli.train.main`` run with the README's flags and ``--skip_test``
    in its own working directory ``run_dir`` (checkpoints, runs/ log);
    adds the StepTimer's steps/s of each epoch and the wall seconds."""
    import torch
    run_dir.mkdir(parents=True, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(run_dir)
    try:
        t0 = time.perf_counter()
        res = train_cli(run_dir, data, seed, device, epochs, "saved",
                        "--skip_test", *extra)
        if device != "cpu":
            torch.cuda.synchronize()
        res["wall_s"] = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    res["steps_per_s"] = [json.loads(line).get("steps_per_s")
                          for f in (run_dir / "runs").glob("*.jsonl")
                          for line in f.read_text().splitlines()
                          if '"train_loss"' in line]
    return res


def train_modes_phase(tmp: Path, seed: int, card: str) -> dict:
    """The training entry point with the loader's modes: ``--reuse_packs
    --loader_workers 2 --num_workers 2`` on fresh splits (featurized on two
    threads, then from the feature cache) on the card against the same
    flags on the CPU (TRAIN_TOL), against ``--loader_workers 1`` (losses
    bit for bit) and beside the run without ``--reuse_packs``; the card's
    busy share of three epochs of the trainer with and without reused
    packs; then ``--ep 2 --reuse_packs`` on the card against the CPU."""
    import torch
    from cgr_mpnn_3d_tpu_torch.data import ChemDataset, plan_spec
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNNConfig
    from cgr_mpnn_3d_tpu_torch.ops import fused_model as fm
    from cgr_mpnn_3d_tpu_torch.train import RxnGraphTrainer
    data = training_data(tmp / "modes", seed)
    modes = ("--reuse_packs", "--num_workers", "2")
    # the main path: counts are zeroed just before it and read just after
    fm.launches = fm.train_launches = fm.vjp_launches = 0
    reuse2 = _cli_run(tmp / "modes" / "reuse_w2", data, seed, DEVICE, 3,
                      *modes, "--loader_workers", "2")
    launches = dict(fwd=fm.launches, train=fm.train_launches)
    check(launches["train"] == reuse2["steps"] > 0,
          f"{launches['train']} training-kernel launches for "
          f"{reuse2['steps']} steps with --reuse_packs")
    check(launches["fwd"] > 0, "validation launched no forward kernel")
    check(all((data / f"{s}.csv.featcache.npz").exists()
              for s in ("train", "val")), "no feature cache was written")
    cpu = _cli_run(tmp / "modes" / "cpu", data, seed, "cpu", 2, *modes,
                   "--loader_workers", "2")
    rel = max(abs(a - b) / abs(b) for key in ("train_losses", "val_losses")
              for a, b in zip(reuse2[key], cpu[key]))
    check(rel <= TRAIN_TOL, f"--reuse_packs card vs CPU RMSE differ by "
                            f"{rel:.3e}")
    reuse1 = _cli_run(tmp / "modes" / "reuse_w1", data, seed, DEVICE, 3,
                      *modes, "--loader_workers", "1")
    same = all(reuse1[k] == reuse2[k]
               for k in ("train_losses", "val_losses", "steps"))
    check(same, f"--loader_workers 2 and 1 differ: {reuse2['train_losses']}"
                f" against {reuse1['train_losses']}")
    packed = _cli_run(tmp / "modes" / "packed", data, seed, DEVICE, 3,
                      "--num_workers", "2")

    # busy share of three epochs of training, packs reused or not
    ds = ChemDataset(str(data / "train.csv"),
                     data_npz_path=str(data / "train.npz"))
    ds.prefeaturize(num_workers=2, cache=True)
    spec = plan_spec([ds.graph(i) for i in range(len(ds))])
    cfg = CGRMPNNConfig(num_node_features=ds.num_node_features,
                        num_edge_features=ds.num_edge_features, depth=4,
                        hidden_sizes=(400,) * 4, dropout_ps=(0.1,) * 4)
    epochs = {}
    for _ in range(2):
        for reuse in (False, True):
            tr = RxnGraphTrainer(name="modes", cfg=cfg, train_data=ds,
                                 val_data=ds, spec=spec, lr=1e-4,
                                 batch_size=64, seed=seed,
                                 model_save_dir=str(tmp / "modes" / "tr"),
                                 device=DEVICE, reuse_packs=reuse)
            tr._train_epoch(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for e in (1, 2, 3):
                tr._train_epoch(e)
            torch.cuda.synchronize()
            rate = 3 * len(tr.train_loader) / (time.perf_counter() - t0)
            wall_ms, dev_ms, _ = device_busy(
                lambda: [tr._train_epoch(e) for e in (4, 5, 6)])
            epochs.setdefault(reuse, []).append(
                {"steps_per_s": rate, "busy_pct": 100 * dev_ms / wall_ms})

    ep_zero()
    ep_card = _cli_run(tmp / "modes" / "ep_card", data, seed, DEVICE, 2,
                       "--ep", "2", "--reuse_packs")
    ep_launches = nonzero(ep_counts())
    # zero cut: K2 once a shard and step; validation through K5, K4, K11
    check(ep_launches.get("K2") == 2 * ep_card["steps"] > 0
          and all(ep_launches.get(k, (0,))[0] > 0
                  for k in ("K5", "K4", "K11")),
          f"--ep 2 --reuse_packs launches {ep_launches} for "
          f"{ep_card['steps']} steps")
    ep_cpu = _cli_run(tmp / "modes" / "ep_cpu", data, seed, "cpu", 2,
                      "--ep", "2", "--reuse_packs")
    ep_rel = max(abs(a - b) / abs(b)
                 for key in ("train_losses", "val_losses")
                 for a, b in zip(ep_card[key], ep_cpu[key]))
    check(ep_rel <= TRAIN_TOL, f"--ep 2 --reuse_packs card vs CPU RMSE "
                               f"differ by {ep_rel:.3e}")
    out = {"phase": "train loader modes", "card": card,
           "launches": launches, "ep_launches": ep_launches,
           "rel_vs_cpu": rel,
           "workers_2_equals_1": same, "ep_rel_vs_cpu": ep_rel,
           "train_losses": reuse2["train_losses"],
           "steps_per_s": {"reuse_packs, 2 workers": reuse2["steps_per_s"],
                           "reuse_packs, 1 worker": reuse1["steps_per_s"],
                           "packed every epoch": packed["steps_per_s"],
                           "--ep 2 --reuse_packs": ep_card["steps_per_s"]},
           "wall_s": {"reuse_packs, 2 workers": reuse2["wall_s"],
                      "reuse_packs, 1 worker": reuse1["wall_s"],
                      "packed every epoch": packed["wall_s"]},
           "trainer_epochs": {"reuse_packs": epochs[True],
                              "packed every epoch": epochs[False]}}
    print(f"train cli --reuse_packs --loader_workers 2 --num_workers 2: 3 "
          f"epochs, {reuse2['steps']} steps, train RMSE "
          f"{reuse2['train_losses']}, card vs CPU (2 epochs) max rel diff "
          f"{rel:.3e} (limit {TRAIN_TOL}); --loader_workers 1 bit for bit "
          f"{same}; steps/s per epoch (StepTimer) {out['steps_per_s']}; "
          f"trainer epochs (steps/s, busy %) {out['trainer_epochs']}; --ep "
          f"2 --reuse_packs card vs CPU {ep_rel:.3e} [{card}]")
    print(json.dumps(out, default=float))
    return out


COPY_CALLS = ("cudaMemcpyAsync", "cudaMemcpy", "cudaMemcpy2DAsync",
              "cuMemcpyHtoDAsync_v2", "cuMemcpyAsync")
T1X_REACTIONS = 10073   # Transition1x's reactions (SURVEY.md, dataset scale)


def launch_counters() -> dict:
    """Every kernel wrapper's launch counter, as "module.counter"."""
    from cgr_mpnn_3d_tpu_torch.ops import (conv_stack, fused_conv,
                                           fused_model, gather_linear,
                                           onehot_spmm)
    from cgr_mpnn_3d_tpu_torch.parallel import rdma_exchange
    return {f"{m.__name__.rsplit('.', 1)[1]}.{k}": v
            for m in (conv_stack, fused_conv, fused_model, gather_linear,
                      onehot_spmm, rdma_exchange)
            for k, v in vars(m).items()
            if k.endswith("launches") and isinstance(v, int)}


class StrictSteps:
    """While active, every ``RxnGraphTrainer._run_steps`` call on the card
    (the steps of a staged epoch, or of a ``--steps_per_call`` chunk, once
    their batches and seeds are on the card) runs under
    ``torch.cuda.set_sync_debug_mode("error")``, so that a call that waits
    for the card raises, inside a torch.profiler window that ends with one
    control host-to-device copy.  ``windows`` gets a record a call: its
    steps, the copy runtime calls (every direction) and the ``Memcpy
    HtoD``, ``DtoH`` and ``DtoD`` device records of the window (the
    control's HtoD included: it shows that the window records copies), its
    cooperative launches and the launch counters that moved."""

    def __init__(self):
        self.windows: list[dict] = []

    def __enter__(self):
        from cgr_mpnn_3d_tpu_torch.train.trainer import RxnGraphTrainer
        self._cls, self._orig = RxnGraphTrainer, RxnGraphTrainer._run_steps
        orig, windows = self._orig, self.windows

        def run_steps(tr, batches, seeds):
            import torch
            from torch.profiler import ProfilerActivity, profile
            if tr.device.type != "cuda":
                return orig(tr, batches, seeds)
            torch.cuda.synchronize()
            before = launch_counters()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    losses = orig(tr, batches, seeds)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.ones(4).to(tr.device, non_blocking=True)
                torch.cuda.synchronize()
            after = launch_counters()
            ev = prof.key_averages()
            windows.append(dict(
                steps=len(losses),
                copy_calls=sum(e.count for e in ev if e.key in COPY_CALLS),
                htod=sum(e.count for e in ev if "Memcpy HtoD" in e.key),
                dtoh=sum(e.count for e in ev if "Memcpy DtoH" in e.key),
                dtod=sum(e.count for e in ev if "Memcpy DtoD" in e.key),
                coop=sum(e.count for e in ev
                         if e.key == "cudaLaunchCooperativeKernel"),
                moved={k: after[k] - v for k, v in before.items()
                       if after[k] != v}))
            return losses
        RxnGraphTrainer._run_steps = run_steps
        return self

    def __exit__(self, *exc):
        self._cls._run_steps = self._orig


def _latest_leaves(run_dir: Path) -> list:
    from cgr_mpnn_3d_tpu_torch.train import load_checkpoint
    (f,) = (run_dir / "saved").glob("*.latest.npz")
    return load_checkpoint(f)[0]


def _same_leaves(a: list, b: list) -> bool:
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


def _max_rel(a: dict, b: dict) -> float:
    return max(abs(x - y) / abs(y) for key in ("train_losses", "val_losses")
               for x, y in zip(a[key], b[key]))


def _staged_mb(run_dir: Path) -> float:
    (mb,) = [json.loads(line)["device_epoch_staged_mb"]
             for f in (run_dir / "runs").glob("*.jsonl")
             for line in f.read_text().splitlines()
             if "device_epoch_staged_mb" in line]
    return mb


def hold_windows(label: str, wins: list, per_step: dict, sizes: set) -> None:
    """Every StrictSteps step loop of ``wins`` has a size in ``sizes``,
    makes no copy to the card or from it and launches ``per_step`` a
    step."""
    check(len(wins) >= 3 and {w["steps"] for w in wins} <= sizes,
          f"{label}: strict step loops of {[w['steps'] for w in wins]} "
          f"steps, expected 3 or more of {sizes}")
    for w in wins:
        moved = {k: w["moved"].get(k, 0) / w["steps"] for k in per_step}
        check(w["htod"] == 1 and w["dtoh"] == 0 and moved == per_step,
              f"{label}: a step loop's window recorded {w['htod']} "
              f"Memcpy HtoD (1 is the control) and {w['dtoh']} DtoH, "
              f"and launched {moved} a step, expected {per_step}")


def device_epoch_phase(tmp: Path, seed: int, card: str) -> dict:
    """The trainer's device-resident modes with the README's model and
    flags on the corpus, 3 epochs on the card: ``--reuse_packs
    --device_epoch`` against ``--reuse_packs`` at f32 and bf16 (per-epoch
    RMSE and the final state -- parameters, Adam, step, seed stream -- bit
    for bit), the layered configuration through ``RxnGraphTrainer``
    (the same), ``--ep 2 --reuse_packs --device_epoch`` (epoch 0 bit for
    bit, then within rtol 0.05 of the host loop), ``--steps_per_call 4``
    against 1 (bit for bit); each mode's card run against its run on the
    CPU (2 epochs) within TRAIN_TOL.  Every step loop of a staged epoch or
    a chunk runs under StrictSteps: no synchronizing call, no copy to the
    card and none from it (the window's Memcpy records: one HtoD, its
    control), one K2 launch a
    whole-model step (n_ep a step under --ep 2), the backward of K4 once a
    layered step.  The wired EP step (K5, K8 per layer and shard, K11) in
    staged epochs of ep_train_wired's set, bit for bit with its host loop.
    Then steps/s (wall and StepTimer) and the card's busy share of staged
    epochs and of chunks of 4 beside the host loop's (smoke readings), and
    the staged MB."""
    import dataclasses
    import torch
    from cgr_mpnn_3d_tpu_torch.data import ChemDataset, plan_spec
    from cgr_mpnn_3d_tpu_torch.data.batch import PackSpec
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNNConfig
    from cgr_mpnn_3d_tpu_torch.train import RxnGraphTrainer, load_checkpoint
    from cgr_mpnn_3d_tpu_torch.train.profiler import StepTimer
    from cgr_mpnn_3d_tpu_torch.train.trainer import set_epoch_lr
    t_phase = time.perf_counter()
    de = tmp / "device_epoch"
    data = training_data(de, seed)
    out = {"phase": "device-resident modes", "card": card}

    # (label, the mode's flags, its host loop's flags, launches a step)
    pairs = (
        ("f32", ("--reuse_packs", "--device_epoch"), ("--reuse_packs",),
         {"fused_model.train_launches": 1}),
        ("bf16", ("--reuse_packs", "--device_epoch", "--compute_dtype", BF16),
         ("--reuse_packs", "--compute_dtype", BF16),
         {"fused_model.bf16_train_launches": 1,
          "fused_model.train_launches": 0}),
        ("--ep 2", ("--ep", "2", "--reuse_packs", "--device_epoch"),
         ("--ep", "2", "--reuse_packs"), {"fused_model.train_launches": 2}),
        ("--steps_per_call 4", ("--steps_per_call", "4"), (),
         {"fused_model.train_launches": 1}))
    runs = {}
    with StrictSteps() as strict:
        for label, mode, plain, per_step in pairs:
            tag = label.replace("-", "").replace(" ", "_")
            host = _cli_run(de / f"{tag}_host", data, seed, DEVICE, 3, *plain)
            n0 = len(strict.windows)
            dev = _cli_run(de / f"{tag}_dev", data, seed, DEVICE, 3, *mode)
            wins = strict.windows[n0:]
            # a staged epoch is one step loop of the cache's S batches;
            # --steps_per_call 4 one a chunk of 4 (the remainder runs as
            # single host-loop steps)
            hold_windows(label, wins, per_step,
                         {dev["steps"] // 3} if "--device_epoch" in mode
                         else {4})
            coop = [w["coop"] / w["steps"] for w in wins]
            cpu = _cli_run(de / f"{tag}_cpu", data, seed, "cpu", 2, *mode)
            rel_cpu = _max_rel(dev, cpu)
            check(rel_cpu <= TRAIN_TOL, f"{label} card vs CPU RMSE differ by "
                                        f"{rel_cpu:.3e}")
            if label == "--ep 2":
                first = (dev["train_losses"][0] == host["train_losses"][0]
                         and dev["val_losses"][0] == host["val_losses"][0])
                rel_host = _max_rel(dev, host)
                check(first and rel_host <= 0.05
                      and dev["train_losses"][-1] < dev["train_losses"][0],
                      f"--ep 2 staged epochs {dev['train_losses']} against "
                      f"the host loop's {host['train_losses']}")
                same = f"epoch 0 bit for bit, then max rel {rel_host:.3e}"
            else:
                check(dev["train_losses"] == host["train_losses"]
                      and dev["val_losses"] == host["val_losses"]
                      and _same_leaves(_latest_leaves(de / f"{tag}_dev"),
                                       _latest_leaves(de / f"{tag}_host")),
                      f"{label}: {dev['train_losses']} against the host "
                      f"loop's {host['train_losses']}, or the final states "
                      f"differ")
                same = "RMSE and final state bit for bit"
            runs[label] = dict(steps=dev["steps"], rel_cpu=rel_cpu,
                               windows=len(wins),
                               cooperative_a_step=coop,
                               train_losses=dev["train_losses"],
                               host_train_losses=host["train_losses"])
            print(f"device modes {label}: 3 epochs, {dev['steps']} steps, "
                  f"train RMSE {dev['train_losses']} against the host loop's "
                  f"{host['train_losses']} ({same}); card vs CPU (2 epochs) "
                  f"{rel_cpu:.3e} (limit {TRAIN_TOL}); "
                  f"{len(wins)} strict step loops: no sync, "
                  f"no copy to or from the card, launches a step {per_step}, "
                  f"cooperative launches a step {coop} [{card}]")

        # the layered configuration through the trainer
        ds = ChemDataset(str(data / "train.csv"),
                         data_npz_path=str(data / "train.npz"))
        ds.prefeaturize(num_workers=2, cache=True)
        spec = plan_spec([ds.graph(i) for i in range(len(ds))])
        cfg = CGRMPNNConfig(num_node_features=ds.num_node_features,
                            num_edge_features=ds.num_edge_features, depth=4,
                            hidden_sizes=(400,) * 4, dropout_ps=(0.1,) * 4)

        def trainer(device, name, epochs=3, fuse=False, **kw):
            return RxnGraphTrainer(
                name=name, cfg=dataclasses.replace(cfg, fuse_whole_model=fuse),
                train_data=ds, val_data=ds, spec=spec, lr=1e-4,
                weight_decay=1e-5, gamma=0.9, num_epochs=epochs,
                batch_size=64, val_frequency=1, seed=seed,
                model_save_dir=str(de / name), device=device,
                reuse_packs=True, **kw)

        def state(tr):
            return load_checkpoint(tr.save(de / tr.name / "state.npz"))[0]
        host_tr = trainer(DEVICE, "layered_host")
        host = host_tr.train()
        n0 = len(strict.windows)
        dev_tr = trainer(DEVICE, "layered_dev", device_epoch=True)
        dev = dev_tr.train()
        wins = strict.windows[n0:]
        hold_windows("layered", wins,
                     {"conv_stack.bwd_launches": 1,
                      "gather_linear.bwd_launches": 2,
                      "onehot_spmm.bwd_launches": 1,
                      "fused_model.train_launches": 0}, {dev["steps"] // 3})
        cpu = trainer("cpu", "layered_cpu", 2, device_epoch=True).train()
        rel_cpu = _max_rel(dev, cpu)
        check(dev["train_losses"] == host["train_losses"]
              and dev["val_losses"] == host["val_losses"]
              and _same_leaves(state(dev_tr), state(host_tr))
              and rel_cpu <= TRAIN_TOL,
              f"layered staged epochs {dev['train_losses']} against the host "
              f"loop's {host['train_losses']} (or the states differ), card vs "
              f"CPU {rel_cpu:.3e}")
        runs["layered"] = dict(steps=dev["steps"], rel_cpu=rel_cpu,
                               train_losses=dev["train_losses"])
        print(f"device modes layered: 3 epochs, {dev['steps']} steps, train "
              f"RMSE {dev['train_losses']} (RMSE and final state bit for bit "
              f"with the host loop); card vs CPU (2 epochs) {rel_cpu:.3e} "
              f"(limit {TRAIN_TOL}); {len(wins)} strict step loops [{card}]")

        # the wired EP step (K5, K8 per layer and shard, K11) in a staged
        # epoch: ep_train_wired's set, one batch an epoch
        graphs, labels = ep_graphs(seed + 3, 7, (480,))
        wired = GraphSet(graphs, labels, 270)

        def ep_trainer(device, name, epochs=3, **kw):
            return RxnGraphTrainer(
                name=name, cfg=dataclasses.replace(
                    cfg, num_node_features=270, num_edge_features=14),
                train_data=wired, val_data=wired, spec=PackSpec(), lr=1e-4,
                weight_decay=1e-5, gamma=0.9, num_epochs=epochs,
                batch_size=len(wired), val_frequency=1, seed=seed,
                model_save_dir=str(de / name), device=device, n_ep=2,
                reuse_packs=True, **kw)
        host_tr = ep_trainer(DEVICE, "wired_host")
        host = host_tr.train()
        n0 = len(strict.windows)
        dev_tr = ep_trainer(DEVICE, "wired_dev", device_epoch=True)
        dev = dev_tr.train()
        wins = strict.windows[n0:]
        hold_windows("wired --ep 2", wins,
                     {"fused_conv.r_bwd_launches": 8,
                      "gather_linear.pool_bwd_launches": 2,
                      "gather_linear.bwd_launches": 2,
                      "fused_model.train_launches": 0}, {1})
        cpu = ep_trainer("cpu", "wired_cpu", 2, device_epoch=True).train()
        rel_cpu = _max_rel(dev, cpu)
        check(any(dev_tr._staged[0][0].caps)
              and dev["train_losses"] == host["train_losses"]
              and dev["val_losses"] == host["val_losses"]
              and _same_leaves(state(dev_tr), state(host_tr))
              and rel_cpu <= TRAIN_TOL,
              f"wired --ep 2 staged epochs {dev['train_losses']} against the "
              f"host loop's {host['train_losses']} (or the states differ), "
              f"card vs CPU {rel_cpu:.3e}")
        runs["wired --ep 2"] = dict(steps=dev["steps"], rel_cpu=rel_cpu,
                                    train_losses=dev["train_losses"])
        print(f"device modes wired --ep 2: 3 epochs of one staged batch (a "
              f"480-atom chain cut across 2 shards and 7 graphs), train RMSE "
              f"{dev['train_losses']} (RMSE and final state bit for bit with "
              f"the host loop); card vs CPU (2 epochs) {rel_cpu:.3e} (limit "
              f"{TRAIN_TOL}); {len(wins)} strict step loops, K8 backward 8 a "
              f"step [{card}]")
    windows = strict.windows
    steps = sum(w["steps"] for w in windows)
    print(f"device modes: {len(windows)} strict step loops, {steps} steps, "
          f"under sync debug mode \"error\"; Memcpy HtoD 0 and DtoH 0 in "
          f"each (its control HtoD recorded in every window); DtoD "
          f"{sum(w['dtod'] for w in windows)} and copy runtime calls "
          f"{sum(w['copy_calls'] - 1 for w in windows)} in all, on the card "
          f"[{card}]")

    # smoke readings: staged epochs and chunks of 4 beside the host loop,
    # f32 whole-model: the wall rate of epochs 1-3, the StepTimer's steps/s
    # over them (the trainer's own reading: a host-looped epoch leaves its
    # first step or chunk untimed), and the busy share of epochs 4-6
    readings = {}
    for _ in range(2):
        for name, kw in (("host loop", {}),
                         ("device epoch", dict(device_epoch=True)),
                         ("steps_per_call 4", dict(steps_per_call=4))):
            tr = trainer(DEVICE, "rate", fuse=True, **kw)
            set_epoch_lr(tr.optimizer, tr.lr, tr.gamma, 0)
            tr._train_epoch(0)
            torch.cuda.synchronize()
            tr._timer = StepTimer(warmup=0)
            t0, step0 = time.perf_counter(), tr.step
            for e in (1, 2, 3):
                tr._train_epoch(e)
            torch.cuda.synchronize()
            rate = (tr.step - step0) / (time.perf_counter() - t0)
            timer = tr._timer.stats()["steps_per_s"]
            wall_ms, dev_ms, _ = device_busy(
                lambda: [tr._train_epoch(e) for e in (4, 5, 6)])
            readings.setdefault(name, []).append(
                {"steps_per_s": rate, "timer_steps_per_s": timer,
                 "busy_pct": 100 * dev_ms / wall_ms})
    mb = _staged_mb(de / "f32_dev")
    out.update(runs=runs, readings=readings, staged_mb=mb,
               staged_mb_t1x=mb / len(ds) * T1X_REACTIONS,
               wall_s=time.perf_counter() - t_phase)
    print(f"device modes: staged {mb:.3f} MB for {len(ds)} reactions "
          f"({mb / len(ds) * 1e3:.3f} KB a reaction: "
          f"{out['staged_mb_t1x']:.1f} MB at Transition1x's "
          f"{T1X_REACTIONS} reactions); trainer epochs, README model f32, 3 "
          f"epochs of {len(tr.train_loader.cached_batches())} steps (chunks "
          f"of 4, the remainder single steps), 2 rounds (wall steps/s, "
          f"StepTimer steps/s, busy %; smoke readings): {readings} [{card}]")
    print(json.dumps(out, default=float))
    return out


def _counts(fn) -> tuple:
    """(fn's result, the launch counters it moved)."""
    import torch
    before = launch_counters()
    out = fn()
    torch.cuda.synchronize()
    after = launch_counters()
    return out, {k: v - before[k] for k, v in after.items() if v != before[k]}


DP_WIRED = (("add", "K8"), ("mean", "K9"))


def dp_phase(tmp: Path, seed: int, card: str) -> dict:
    """Data parallelism with every group in this process (``--dp 2``), the
    README's model on the corpus: ``cli.train.main`` 3 epochs on the card
    and 2 on the CPU at f32 (TRAIN_TOL) and bf16 (BF16_TRAIN_TOL), two K2
    launches a step and one K3f a validation group's batch; the layered
    configuration's K5, K4 and K7 launches a step twice the single-device
    step's; one dp step against one single-device step on a batch of both
    groups' graphs (SSE and the summed gradients within 1e-4, the updated
    parameters too); the all-masked filler group's SSE and gradients
    exactly 0 through K2, K3f and the layered kernels (add and mean); ``--dp
    2 --reuse_packs --device_epoch`` under StrictSteps against its host
    loop (epoch 0 bit for bit, later epochs within rtol 0.05); ``n_dp=2,
    n_ep=2`` on the wired set (K5, K8 or K9 per layer, K11 per group and
    shard) card against CPU; a mid-epoch resume bit for bit with a
    straight run.  Each part's wall time on its line."""
    import dataclasses
    import torch
    from cgr_mpnn_3d_tpu_torch.data import (ChemDataset, PackedLoader,
                                            empty_batch, plan_spec,
                                            to_device)
    from cgr_mpnn_3d_tpu_torch.data.batch import PackSpec
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNNConfig, init_params
    from cgr_mpnn_3d_tpu_torch.parallel import (make_dp_eval_step,
                                                make_dp_train_step,
                                                stack_batches)
    from cgr_mpnn_3d_tpu_torch.train import RxnGraphTrainer, load_checkpoint
    from cgr_mpnn_3d_tpu_torch.train.trainer import set_epoch_lr
    t_phase = time.perf_counter()
    base = tmp / "dp"
    data = training_data(base, seed)
    out = {"phase": "data parallel", "card": card, "wall_s": {}}
    ds = ChemDataset(str(data / "train.csv"),
                     data_npz_path=str(data / "train.npz"))
    ds.prefeaturize(num_workers=2, cache=True)
    spec = plan_spec([ds.graph(i) for i in range(len(ds))])
    # validation batches of 32 graphs (the README's 64 over 2 groups)
    val_groups = -(-len(list(PackedLoader(ds, spec, batch_size=32))) // 2)

    # the CLI at f32 and bf16: the main path, counts zeroed before each run
    for label, extra, tol, k2, k3f in (
            ("f32", (), TRAIN_TOL, "fused_model.train_launches",
             "fused_model.launches"),
            ("bf16", ("--compute_dtype", BF16), BF16_TRAIN_TOL,
             "fused_model.bf16_train_launches",
             "fused_model.bf16_launches")):
        t0 = time.perf_counter()
        tag = f"cli_{label}"
        card_res, moved = _counts(lambda: _cli_run(
            base / f"{tag}_card", data, seed, DEVICE, 3, "--dp", "2",
            *extra))
        cpu_res = _cli_run(base / f"{tag}_cpu", data, seed, "cpu", 2,
                           "--dp", "2", *extra)
        rel = _max_rel(card_res, cpu_res)
        want = {k2: 2 * card_res["steps"], k3f: 3 * 2 * val_groups}
        check(card_res["steps"] > 0 and moved == want and rel <= tol,
              f"--dp 2 {label}: launches {moved}, expected {want}; card vs "
              f"CPU RMSE {rel:.3e} (limit {tol})")
        out[tag] = dict(steps=card_res["steps"], launches=moved, rel=rel,
                        train_losses=card_res["train_losses"],
                        steps_per_s=card_res["steps_per_s"])
        out["wall_s"][tag] = time.perf_counter() - t0
        print(f"dp cli --dp 2 {label}: 3 epochs, {card_res['steps']} steps, "
              f"train RMSE {card_res['train_losses']}, val RMSE "
              f"{card_res['val_losses']}; launches {moved} (K2 two a step, "
              f"K3f one a validation group's batch: {val_groups} groups); "
              f"card vs CPU (2 epochs) {rel:.3e} (limit {tol}); steps/s "
              f"(StepTimer) {card_res['steps_per_s']}; wall "
              f"{out['wall_s'][tag]:.1f} s [{card}]")

    cfg = CGRMPNNConfig(num_node_features=ds.num_node_features,
                        num_edge_features=ds.num_edge_features, depth=4,
                        hidden_sizes=(400,) * 4, dropout_ps=(0.1,) * 4)

    def trainer(name, device=DEVICE, **kw):
        kw = {"cfg": cfg, "train_data": ds, "val_data": ds, **kw}
        return RxnGraphTrainer(
            name=name, spec=spec, lr=1e-4, weight_decay=1e-5, gamma=0.9,
            num_epochs=2, batch_size=64, val_frequency=1, seed=seed,
            model_save_dir=str(base / name), device=device, **kw)

    # the layered configuration: K5, K4 and K7 twice the single device's
    t0 = time.perf_counter()
    layered = dataclasses.replace(cfg, fuse_whole_model=False)
    per_step = {}
    for n_dp in (1, 2):
        tr = trainer(f"layered_{n_dp}", cfg=layered, n_dp=n_dp)
        set_epoch_lr(tr.optimizer, tr.lr, tr.gamma, 0)
        _, moved = _counts(lambda: tr._train_epoch(0))
        per_step[n_dp] = {k: v / tr.step for k, v in moved.items()}
    out["layered_launches"] = moved
    keys = [f"{m}.{c}" for m in ("gather_linear", "conv_stack",
                                 "onehot_spmm")
            for c in ("launches", "bwd_launches")]
    check(all(per_step[1].get(k, 0) > 0
              and per_step[2].get(k) == 2 * per_step[1][k] for k in keys)
          and "fused_model.train_launches" not in per_step[2],
          f"layered --dp 2 launches a step {per_step[2]}, expected twice "
          f"the single device's {per_step[1]}")
    out["layered_per_step"] = per_step
    out["wall_s"]["layered"] = time.perf_counter() - t0
    print(f"dp layered: launches a step at n_dp 2 {per_step[2]}, twice the "
          f"single device's {per_step[1]}; wall "
          f"{out['wall_s']['layered']:.1f} s [{card}]")

    # one dp step against one step on a batch of both groups' graphs
    t0 = time.perf_counter()
    half = [ds.graph(i) for i in range(64)]
    labels = [float(ds.labels[i]) for i in range(64)]
    extra = [ds.extra_feats(i) for i in range(64)]
    from cgr_mpnn_3d_tpu_torch.data import (pack_graphs, packs_needed,
                                            place_graphs)

    def fit(*parts):
        """The spec whose pack count holds each of ``parts``."""
        p = max(packs_needed(part, spec) for part in parts)
        while not all(place_graphs(part, spec.with_packs(p))
                      for part in parts):
            p += 1
        return spec.with_packs(p)
    spec32, spec64 = fit(half[:32], half[32:]), fit(half)
    groups = to_device(stack_batches([
        pack_graphs(half[g * 32:(g + 1) * 32], labels[g * 32:(g + 1) * 32],
                    spec32, extra[g * 32:(g + 1) * 32]) for g in (0, 1)]),
        DEVICE)
    whole = to_device(stack_batches([pack_graphs(half, labels, spec64,
                                                 extra)]), DEVICE)
    cfg0 = dataclasses.replace(cfg, dropout_ps=(0.0,) * 4)
    res = []
    for grp, sp in ((groups, spec32), (whole, spec64)):
        model = init_params(cfg0, torch.Generator().manual_seed(seed),
                            DEVICE)
        adam = torch.optim.Adam(model.parameters(), lr=1e-4,
                                weight_decay=1e-5, amsgrad=True)
        sse = make_dp_train_step(model, sp)(grp, None)
        grads = [p.grad.clone() for p in model.parameters()]
        adam.step()
        res.append((float(sse), grads,
                    [p.detach().clone() for p in model.parameters()]))
    sse_rel = abs(res[0][0] - res[1][0]) / abs(res[1][0])
    grad_l1, param_l1 = l1(res[0][1], res[1][1]), l1(res[0][2], res[1][2])
    check(sse_rel <= REL_TOL and grad_l1 <= REL_TOL and param_l1 <= REL_TOL,
          f"a dp step against one step on the concatenated graphs: SSE "
          f"{sse_rel:.3e}, gradients L1 {grad_l1:.3e}, updated parameters "
          f"L1 {param_l1:.3e} (limit {REL_TOL})")
    out["vs_single"] = dict(sse_rel=sse_rel, grad_l1=grad_l1,
                            param_l1=param_l1)
    print(f"dp step vs single device: 2 groups of 32 corpus reactions "
          f"({spec32.p} packs each) against one batch of 64 ({spec64.p} "
          f"packs): SSE rel "
          f"{sse_rel:.3e}, summed gradients rel L1 {grad_l1:.3e}, updated "
          f"parameters rel L1 {param_l1:.3e} (limit {REL_TOL}) [{card}]")

    # the filler group: exactly 0 through K2, K3f and the layered kernels
    zeros = {}
    for pooling in ("add", "mean"):
        for fuse in (True, False):
            c = dataclasses.replace(cfg, aggr=pooling, pooling=pooling,
                                    fuse_whole_model=fuse)
            model = init_params(c, torch.Generator().manual_seed(seed),
                                DEVICE)
            filler = to_device(stack_batches([empty_batch(
                spec32, ds.num_node_features, ds.num_edge_features)]),
                DEVICE)
            seeds = torch.randint(0, 2**31 - 1, (1, 4), dtype=torch.int32)
            (sse, ev), moved = _counts(lambda: (
                make_dp_train_step(model, spec32)(filler, seeds),
                make_dp_eval_step(model, spec32)(filler)))
            gmax = max(float(p.grad.abs().max()) for p in model.parameters())
            key = f"{'whole-model' if fuse else 'layered'} {pooling}"
            zeros[key] = moved
            check(float(sse) == 0.0 and float(ev) == 0.0 and gmax == 0.0
                  and (moved.get("fused_model.train_launches") == 1
                       if fuse else moved.get("conv_stack.bwd_launches", 0)
                       > 0),
                  f"the filler group ({key}): SSE {float(sse)}, eval SSE "
                  f"{float(ev)}, largest gradient {gmax}, launches {moved}")
    out["filler"] = zeros
    out["wall_s"]["step checks"] = time.perf_counter() - t0
    print(f"dp filler group: SSE, eval SSE and every gradient exactly 0 on "
          f"the card, whole-model (K2, K3f) and layered (K5, K4, K7), add "
          f"and mean; launches {zeros}; wall "
          f"{out['wall_s']['step checks']:.1f} s [{card}]")

    # staged epochs: --dp 2 --reuse_packs --device_epoch
    t0 = time.perf_counter()
    with StrictSteps() as strict:
        host = _cli_run(base / "de_host", data, seed, DEVICE, 3, "--dp", "2",
                        "--reuse_packs")
        dev = _cli_run(base / "de_dev", data, seed, DEVICE, 3, "--dp", "2",
                       "--reuse_packs", "--device_epoch")
    hold_windows("--dp 2 --device_epoch", strict.windows,
                 {"fused_model.train_launches": 2}, {dev["steps"] // 3})
    rel_host = _max_rel(dev, host)
    check(dev["train_losses"][0] == host["train_losses"][0]
          and dev["val_losses"][0] == host["val_losses"][0]
          and rel_host <= 0.05
          and dev["train_losses"][-1] < dev["train_losses"][0],
          f"--dp 2 staged epochs {dev['train_losses']} against the host "
          f"loop's {host['train_losses']}")
    out["device_epoch"] = dict(steps=dev["steps"], rel_host=rel_host,
                               windows=len(strict.windows),
                               staged_mb=_staged_mb(base / "de_dev"))
    out["wall_s"]["device_epoch"] = time.perf_counter() - t0
    print(f"dp --dp 2 --reuse_packs --device_epoch: 3 epochs, "
          f"{dev['steps']} steps, train RMSE {dev['train_losses']} against "
          f"the host loop's {host['train_losses']} (epoch 0 bit for bit, "
          f"then max rel {rel_host:.3e}); {len(strict.windows)} strict step "
          f"loops: no sync, no copy to or from the card, K2 two a step; "
          f"staged {out['device_epoch']['staged_mb']:.3f} MB; wall "
          f"{out['wall_s']['device_epoch']:.1f} s [{card}]")

    # dp x ep on the wired set: a 480-atom chain cut across 2 shards
    t0 = time.perf_counter()
    graphs, wl = ep_graphs(seed + 3, 7, (480,))
    wired = GraphSet(graphs, wl, 270)
    out["dp_ep"] = {}
    for aggr, conv in DP_WIRED:
        c = CGRMPNNConfig(num_node_features=270, num_edge_features=14,
                          depth=4, hidden_sizes=(400,) * 4,
                          dropout_ps=(0.1,) * 4, aggr=aggr)

        def ep_trainer(device):
            return RxnGraphTrainer(
                name=f"dp_ep_{aggr}_{device}", cfg=c, train_data=wired,
                val_data=wired, spec=PackSpec(), lr=1e-4, weight_decay=1e-5,
                gamma=0.9, num_epochs=3, batch_size=len(wired),
                val_frequency=1, seed=seed,
                model_save_dir=str(base / "dp_ep"), device=device, n_dp=2,
                n_ep=2)
        ep_zero()
        card_res = ep_trainer(DEVICE).train()
        torch.cuda.synchronize()
        launches = {k: v for k, v in nonzero(ep_counts()).items()
                    if k != "ring"}
        cpu_res = ep_trainer("cpu").train()
        rel = _max_rel(card_res, cpu_res)
        # 3 steps and 3 validations, each forward per group and shard
        want = {"K5": (24, 12), conv: (96, 48), "K11": (24, 12)}
        check(card_res["steps"] == 3 and launches == want
              and rel <= TRAIN_TOL,
              f"--dp 2 --ep 2 wired {aggr}: launches {launches}, expected "
              f"{want}; card vs CPU {rel:.3e}")
        out["dp_ep"][aggr] = dict(launches=launches, rel=rel)
        print(f"dp x ep wired {aggr}: n_dp 2, n_ep 2, 3 steps, train RMSE "
              f"{card_res['train_losses']}; launches {launches}; card vs CPU "
              f"{rel:.3e} (limit {TRAIN_TOL}) [{card}]")
    out["wall_s"]["dp_ep"] = time.perf_counter() - t0

    # a mid-epoch resume under --dp 2, bit for bit with a straight run
    t0 = time.perf_counter()
    straight = trainer("straight", n_dp=2)
    straight.train()
    cut = trainer("cut", n_dp=2, ckpt_every_steps=2)
    cut.train_loader.set_epoch(0)
    steps0 = -(-len(list(cut.train_loader)) // 2)
    calls = {"n": 0}
    step = cut._train_step

    def preempt(batch):
        calls["n"] += 1
        if calls["n"] == steps0 + 3:
            raise KeyboardInterrupt
        return step(batch)
    cut._train_step = preempt
    try:
        cut.train()
    except KeyboardInterrupt:
        pass
    latest = base / "cut" / "cut.latest.npz"
    meta = json.loads(latest.with_suffix(".json").read_text())
    resumed = trainer("cut", n_dp=2, resume_from=str(latest))
    resumed.train()
    a = load_checkpoint(straight.save(base / "straight" / "end.npz"))[0]
    b = load_checkpoint(resumed.save(base / "cut" / "end.npz"))[0]
    check(meta.get("mid_epoch") == {"epoch": 1, "steps_done": 2}
          and _same_leaves(a, b) and resumed.step == straight.step,
          f"--dp 2 mid-epoch resume ({meta.get('mid_epoch')}) differs from "
          f"a straight run")
    out["wall_s"]["resume"] = time.perf_counter() - t0
    out["wall_s"]["phase"] = time.perf_counter() - t_phase
    print(f"dp resume: interrupted at epoch 1 step 3 of {steps0}, resumed "
          f"from {meta['mid_epoch']}: {len(a)} leaves bit for bit with a "
          f"straight 2-epoch run ({straight.step} steps); wall "
          f"{out['wall_s']['resume']:.1f} s [{card}]")
    print(json.dumps(out, default=float))
    return out


RANK_TIMEOUT_S = 600


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def wired_trainer(seed: int, name: str, save: Path, device,
                  ep_rdma: bool = False):
    """The README's model (aggr add, dropout 0.1) on a wired set: 15
    synthetic graphs and a 480-atom chain, batches of 8 graphs sharded over
    2 EP shards (the chain's batch cut across them), 3 epochs; ``ep_rdma``
    sends the exchanges through K12."""
    from cgr_mpnn_3d_tpu_torch.data.batch import PackSpec
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNNConfig
    from cgr_mpnn_3d_tpu_torch.train import RxnGraphTrainer
    graphs, labels = ep_graphs(seed + 3, 15, (480,))
    data = GraphSet(graphs, labels, 270)
    cfg = CGRMPNNConfig(num_node_features=270, num_edge_features=14,
                        depth=4, hidden_sizes=(400,) * 4,
                        dropout_ps=(0.1,) * 4, ep_rdma_exchange=ep_rdma)
    return RxnGraphTrainer(
        name=name, cfg=cfg, train_data=data, val_data=data, spec=PackSpec(),
        lr=1e-4, weight_decay=1e-5, gamma=0.9, num_epochs=3, batch_size=8,
        val_frequency=1, seed=seed, model_save_dir=str(save), device=device,
        n_ep=2)


def rank_job(job: dict) -> int:
    """One rank of ``multiprocess_phase`` (``--rank_job``), under the launch
    variables the parent set: ``job`` or, in turn in this one process,
    each of ``job["jobs"]`` (see :func:`_rank_sub_job`); prints
    ``RANK_RESULT`` with the result, or the list of them."""
    results = [_rank_sub_job(sub) for sub in job.get("jobs", [job])]
    print("RANK_RESULT " + json.dumps(
        results if "jobs" in job else results[0], default=float), flush=True)
    return 0


def _rank_sub_job(job: dict) -> dict:
    """The CLI with ``job["argv"]``, the wired trainer (``rdma``: through
    the cross-rank K12), the flat step, or the cross-rank K12 alone
    (``tools/k12_ranks.py``): its results, the launch counters it moved,
    the checkpoint files it wrote, its wall seconds and the host seconds of
    its collectives (the card synchronized before each; not for the K12
    alone, which times its own), with their calls by name."""
    import torch
    from cgr_mpnn_3d_tpu_torch.parallel import ep_pack, multihost
    from cgr_mpnn_3d_tpu_torch.train import trainer as trainer_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_job = time.perf_counter()
    writes, coll = [], {"s": 0.0, "calls": 0, "by": {}}
    save = trainer_mod.save_checkpoint

    def counted(path, *a, **kw):
        writes.append(str(path))
        return save(path, *a, **kw)

    def timed(fn, name):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                coll["s"] += time.perf_counter() - t0
                coll["calls"] += 1
                coll["by"][name] = coll["by"].get(name, 0) + 1
        return run
    names = ([] if job["kind"] == "exchange" else
             [(multihost, "all_reduce_sum_"), (ep_pack, "_rank_ring_move"),
              (ep_pack, "_rank_all_to_all")])
    kept = [getattr(m, n) for m, n in names]
    group_sum = ep_pack._GroupSum.forward
    trainer_mod.save_checkpoint = counted
    for (m, n), fn in zip(names, kept):
        setattr(m, n, timed(fn, n))
    if names:
        ep_pack._GroupSum.forward = staticmethod(timed(group_sum,
                                                       "_GroupSum"))
    try:
        Path(job["cwd"]).mkdir(parents=True, exist_ok=True)
        os.chdir(job["cwd"])
        before = launch_counters()
        if job["kind"] == "exchange":
            from cgr_mpnn_3d_tpu_torch.tools import k12_ranks
            multihost.initialize()
            res = k12_ranks.run(job["k12"])
        elif job["kind"] == "cli":
            from cgr_mpnn_3d_tpu_torch.cli import train as cli_train
            res = cli_train.main(job["argv"])
        elif job["kind"] == "flat":
            multihost.initialize()
            res = flat_wired_step(job["seed"], DEVICE, Path(job["cwd"])
                                  / "grads.npz")
        else:
            multihost.initialize()
            res = wired_trainer(job["seed"], "wired", Path(job["save"]),
                                DEVICE, ep_rdma=job.get("rdma", False)
                                ).train()
        torch.cuda.synchronize()
        after = launch_counters()
    finally:
        trainer_mod.save_checkpoint = save
        for (m, n), fn in zip(names, kept):
            setattr(m, n, fn)
        ep_pack._GroupSum.forward = staticmethod(group_sum)
    return dict(
        res=res, rank=multihost.rank(), world=multihost.world_size(),
        device=str(torch.cuda.current_device()), writes=writes,
        moved={k: v - before[k] for k, v in after.items() if v != before[k]},
        coll_s=coll["s"], coll_calls=coll["calls"], coll_by=coll["by"],
        wall_s=time.perf_counter() - t_job)


def run_ranks(jobs: list[dict], envs: list[dict]) -> list[dict]:
    """Start one ``--rank_job`` process a job (with its launch variables),
    all at once; their RANK_RESULTs.  A rank that fails or outlives
    RANK_TIMEOUT_S fails the check, and every rank is gone on return."""
    base = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                         "MASTER_PORT", "JAX_COORDINATOR_ADDRESS",
                         "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")}
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--rank_job",
         json.dumps(job)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=str(ROOT), env={**base, **env})
        for job, env in zip(jobs, envs)]
    outs = []
    try:
        for r, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                check(False, f"rank {r} outlived {RANK_TIMEOUT_S} s")
            lines = [ln for ln in out.splitlines()
                     if ln.startswith("RANK_RESULT ")]
            check(p.returncode == 0 and len(lines) == 1,
                  f"rank {r} exited {p.returncode}:\n{out[-3000:]}\n"
                  f"{err[-3000:]}")
            outs.append(json.loads(lines[0][len("RANK_RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _leaves_rel(a: list, b: list) -> float:
    """max |a - b| / max |b| over every leaf pair (0 when bit for bit)."""
    return max(float(np.abs(x.astype(np.float64) - y).max()
                     / max(np.abs(y).max(), 1e-30))
               if x.size else 0.0 for x, y in zip(a, b))


def multiprocess_phase(tmp: Path, seed: int, card: str) -> dict:
    """Two gloo ranks on the card (each this script with ``--rank_job``)
    against the single-process run with the same flags, and the cross-rank
    K12 alone at 2 and 4 ranks: see item 23 of the module doc.  Each run's
    line has both wall steps/s and the ranks' collective host ms a
    step."""
    from cgr_mpnn_3d_tpu_torch.train import load_checkpoint
    t_phase = time.perf_counter()
    base = tmp / "mp"
    data = training_data(base, seed)
    out = {"phase": "multi-process", "card": card, "wall_s": {}, "runs": {}}
    common = ["-ne", "3", "--val_frequency", "1", "--seed", str(seed),
              "--data_path", str(data), "--skip_test", "--dp", "2"]
    runs = (
        ("dp2_f32", (), "torchrun", "fused_model.train_launches"),
        ("dp2_bf16_device_epoch", ("--compute_dtype", BF16, "--reuse_packs",
                                   "--device_epoch"), "jax",
         "fused_model.bf16_train_launches"))
    for label, extra, names, k2 in runs:
        t0 = time.perf_counter()
        port = _free_port()
        run_dir = base / label
        argv = README_FLAGS + common + ["--save_path", str(run_dir / "saved"),
                                        "--device", DEVICE, *extra]
        jobs = [dict(kind="cli", argv=argv, cwd=str(run_dir / f"rank{r}"))
                for r in range(2)]
        envs = [dict(WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                     MASTER_ADDR="localhost", MASTER_PORT=str(port))
                if names == "torchrun" else
                dict(JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                     JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(r))
                for r in range(2)]
        ranks = run_ranks(jobs, envs)
        t_ranks = time.perf_counter() - t0
        one = _cli_run(base / f"{label}_one", data, seed, DEVICE, 3,
                       "--dp", "2", *extra)
        res = [r["res"] for r in ranks]
        same_ranks = res[0]["train_losses"] == res[1]["train_losses"] and \
            res[0]["val_losses"] == res[1]["val_losses"]
        bits = (res[0]["train_losses"] == one["train_losses"]
                and res[0]["val_losses"] == one["val_losses"])
        leaves = load_checkpoint(next((run_dir / "saved").glob(
            "*.latest.npz")))[0]
        leaves_one = _latest_leaves(base / f"{label}_one")
        same_leaves = _same_leaves(leaves, leaves_one)
        steps = res[0]["steps"]
        k2_ok = all(r["moved"].get(k2) == steps for r in ranks)
        writes_ok = ranks[0]["writes"] and ranks[1]["writes"] == [] and \
            not (run_dir / "rank1" / "runs").exists() and \
            (run_dir / "rank0" / "runs").exists()
        check(same_ranks and bits and same_leaves and k2_ok and writes_ok
              and [r["rank"] for r in ranks] == [0, 1],
              f"2 ranks {label}: ranks agree {same_ranks}, losses bit for "
              f"bit with one process {bits} ({res[0]['train_losses']} vs "
              f"{one['train_losses']}), checkpoint leaves {same_leaves}, "
              f"K2 one a step on each rank {k2_ok} "
              f"({[r['moved'] for r in ranks]}, {steps} steps), only rank 0 "
              f"wrote {writes_ok} ({[r['writes'] for r in ranks]})")
        sps = [r["res"]["steps"] / r["res"]["train_time_s"] for r in ranks]
        sps_one = one["steps"] / one["train_time_s"]
        # the StepTimer's per-epoch rates (rank 0 logs them)
        timer = [json.loads(line).get("steps_per_s")
                 for f in (run_dir / "rank0" / "runs").glob("*.jsonl")
                 for line in f.read_text().splitlines()
                 if '"train_loss"' in line]
        coll_ms = [1e3 * r["coll_s"] / steps for r in ranks]
        out["runs"][label] = dict(
            steps=steps, launches=[r["moved"] for r in ranks],
            steps_per_s=sps, steps_per_s_one=sps_one, coll_ms=coll_ms,
            timer_steps_per_s=timer, timer_steps_per_s_one=one["steps_per_s"],
            coll_calls=[r["coll_calls"] for r in ranks],
            train_losses=res[0]["train_losses"])
        out["wall_s"][label] = time.perf_counter() - t0
        print(f"multi-process {label} ({names} variables, 2 ranks on "
              f"{ranks[0]['device']}): 3 epochs, {steps} steps, train RMSE "
              f"{res[0]['train_losses']}, val RMSE {res[0]['val_losses']}: "
              f"both ranks and one process bit for bit, checkpoint leaves "
              f"bit for bit ({len(leaves)}), only rank 0 wrote "
              f"({len(ranks[0]['writes'])} files); launches rank 0 "
              f"{ranks[0]['moved']}, rank 1 {ranks[1]['moved']}; wall "
              f"steps/s (steps / train time, validation and checkpoints "
              f"included) ranks {sps} against one process's {sps_one:.3f}; "
              f"StepTimer steps/s per epoch rank 0 {timer} against one "
              f"process's {one['steps_per_s']}; collectives' host ms a step "
              f"(the card synchronized before each; one all-reduce of [SSE, "
              f"gradients] a step and one a validation batch; waiting for "
              f"the other rank included) {coll_ms}; ranks' wall "
              f"{t_ranks:.1f} s [{card}]")

    # one pair of rank processes (torchrun's variables) runs in turn: the
    # wired set one EP shard a rank with the exchanges through gloo, then
    # through the cross-rank K12, the flat layout's step, the cross-rank
    # K12 alone (last: it ends with a peer that never calls)
    port = _free_port()
    envs = [dict(WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                 MASTER_ADDR="localhost", MASTER_PORT=str(port))
            for r in range(2)]
    subs = [[dict(kind="wired", seed=seed, rdma=rdma,
                  save=str(base / label / "saved"),
                  cwd=str(base / label / f"rank{r}"))
             for label, rdma in (("wired_ep2", False),
                                 ("wired_ep2_rdma", True))]
            + [dict(kind="flat", seed=seed,
                    cwd=str(base / "flat_ep2" / f"rank{r}")),
               dict(kind="exchange",
                    k12=dict(K12_RANK_JOBS[0][1], seed=seed),
                    cwd=str(base / "k12_2" / f"rank{r}"))]
            for r in range(2)]
    t0 = time.perf_counter()
    pair = run_ranks([dict(jobs=sub) for sub in subs], envs)
    out["wall_s"]["rank_pair"] = time.perf_counter() - t0
    for i, (label, rdma) in enumerate((("wired_ep2", False),
                                       ("wired_ep2_rdma", True))):
        out["runs"][label] = wired_ranks(base, seed, card, rdma,
                                         [p[i] for p in pair])
        out["wall_s"][label] = out["runs"][label]["wall_s"]
    print(f"multi-process wired --ep 2, one shard a rank, shared card: the "
          f"collectives' host ms a step without --ep_rdma "
          f"{out['runs']['wired_ep2']['coll_ms']} over "
          f"{out['runs']['wired_ep2']['coll_calls']} calls, with it "
          f"{out['runs']['wired_ep2_rdma']['coll_ms']} over "
          f"{out['runs']['wired_ep2_rdma']['coll_calls']} calls (the "
          f"exchanges no longer among them); wall steps/s "
          f"{out['runs']['wired_ep2']['steps_per_s']} against "
          f"{out['runs']['wired_ep2_rdma']['steps_per_s']} [{card}]")
    out["runs"]["flat_ep2"] = flat_ranks(base, seed, card,
                                         [p[2] for p in pair])
    out["wall_s"]["flat_ep2"] = out["runs"]["flat_ep2"]["wall_s"]
    out["runs"]["k12_ranks"] = k12_ranks_phase(base, seed, card,
                                               [p[3] for p in pair])
    out["wall_s"]["k12_ranks"] = out["runs"]["k12_ranks"]["wall_s"]
    out["wall_s"]["phase"] = time.perf_counter() - t_phase
    print(json.dumps(out, default=float))
    return out


def wired_ranks(base: Path, seed: int, card: str, rdma: bool,
                ranks: list[dict]) -> dict:
    """``wired_trainer`` on two ranks, one EP shard each (``ranks``: their
    results; with ``rdma`` every exchange through the cross-rank K12),
    against the single-process run with the same flags on the card: losses
    at rtol 1e-6, leaves within 1e-6 of their largest, each rank half the
    single process's launches of K5/K8/K11; with ``rdma`` no gloo ring
    move on either rank and each rank's cross-rank K12 launches (forward,
    backward) equal to the one-process K12's."""
    import torch
    from cgr_mpnn_3d_tpu_torch.train import load_checkpoint
    label = "wired_ep2_rdma" if rdma else "wired_ep2"
    t0 = time.perf_counter()
    run_dir = base / label
    before = launch_counters()
    tr = wired_trainer(seed, "wired", base / f"{label}_one" / "saved",
                       DEVICE, ep_rdma=rdma)
    one = tr.train()
    torch.cuda.synchronize()
    after = launch_counters()
    moved_one = {k: v - before[k] for k, v in after.items()
                 if v != before[k]}
    res = [r["res"] for r in ranks]
    same_ranks = res[0]["train_losses"] == res[1]["train_losses"] and \
        res[0]["val_losses"] == res[1]["val_losses"]
    loss_rel = _max_rel(res[0], one)
    leaves = load_checkpoint(run_dir / "saved" / "wired.latest.npz")[0]
    leaves_one = load_checkpoint(base / f"{label}_one" / "saved"
                                 / "wired.latest.npz")[0]
    leaf_rel = _leaves_rel(leaves, leaves_one)
    halves = all(2 * r["moved"].get(k, 0) == v for r in ranks
                 for k, v in moved_one.items()
                 if not k.startswith("rdma_exchange."))
    used = all(r["moved"].get(k, 0) > 0 for r in ranks
               for k in ("gather_linear.launches", "fused_conv.r_launches",
                         "gather_linear.pool_launches"))
    writes_ok = ranks[0]["writes"] and ranks[1]["writes"] == []
    moves = [r["coll_by"].get("_rank_ring_move", 0) for r in ranks]
    k12 = [(r["moved"].get("rdma_exchange.rank_launches", 0),
            r["moved"].get("rdma_exchange.rank_bwd_launches", 0))
           for r in ranks]
    k12_one = (moved_one.get("rdma_exchange.launches", 0),
               moved_one.get("rdma_exchange.bwd_launches", 0))
    routed = (all(m == 0 for m in moves) and k12_one[0] > 0
              and all(k == k12_one for k in k12)) if rdma else \
        all(m > 0 for m in moves) and k12 == [(0, 0)] * 2
    check(same_ranks and loss_rel <= 1e-6 and leaf_rel <= 1e-6 and halves
          and used and writes_ok and routed,
          f"2 ranks, one EP shard each, wired set{' --ep_rdma' * rdma}: "
          f"ranks agree {same_ranks}, losses {res[0]['train_losses']} "
          f"against one process's {one['train_losses']} (max rel "
          f"{loss_rel:.3e}, limit 1e-6), leaves {leaf_rel:.3e} of their "
          f"largest (limit 1e-6), launches {[r['moved'] for r in ranks]} "
          f"half of one process's {moved_one} {halves}, K5/K8/K11 on each "
          f"rank {used}, only rank 0 wrote {writes_ok}, gloo ring moves "
          f"{moves}, cross-rank K12 launches {k12} against the one-process "
          f"K12's {k12_one} ({routed})")
    steps = res[0]["steps"]
    sps = [r["steps"] / r["train_time_s"] for r in res]
    sps_one = one["steps"] / one["train_time_s"]
    coll_ms = [1e3 * r["coll_s"] / steps for r in ranks]
    what = ("group sums and the all-reduce" if rdma else
            "ring exchanges, group sums, the all-reduce")
    out = dict(steps=steps, launches=[r["moved"] for r in ranks],
               launches_one=moved_one, loss_rel=loss_rel, leaf_rel=leaf_rel,
               steps_per_s=sps, steps_per_s_one=sps_one, coll_ms=coll_ms,
               coll_calls=[r["coll_calls"] for r in ranks],
               coll_by=[r["coll_by"] for r in ranks], ring_moves=moves,
               k12=k12, k12_one=k12_one, wall_s=time.perf_counter() - t0
               + max(r["wall_s"] for r in ranks))
    print(f"multi-process wired --ep 2{' --ep_rdma' * rdma}, one shard a "
          f"rank (torchrun variables, shared card): 3 epochs, {steps} "
          f"steps, train RMSE {res[0]['train_losses']} against one "
          f"process's {one['train_losses']}: losses max rel {loss_rel:.3e}, "
          f"checkpoint leaves within {leaf_rel:.3e} of their largest "
          f"(limit 1e-6, not bit for bit: the ranks sum the shards' "
          f"gradients after their backward, one process accumulates them "
          f"inside its backward), ranks bit for bit with each other; "
          f"launches rank 0 {ranks[0]['moved']}, each half of one "
          f"process's {moved_one} (the exchanges: gloo ring moves {moves}, "
          f"cross-rank K12 {k12} against the one-process K12's {k12_one}); "
          f"wall steps/s ranks {sps} against one process's {sps_one:.3f}; "
          f"collectives' host ms a step ({what}; "
          f"waiting for the other rank included) {coll_ms} over "
          f"{ranks[0]['coll_calls']} calls {ranks[0]['coll_by']}; wall "
          f"{out['wall_s']:.1f} s [{card}]")
    return out


K12_RANK_JOBS = (
    # 2 ranks at the main path's wire (TW 8, H 400), timed, then a missing
    # peer; 4 ranks on asymmetric and one-hop caps
    (2, dict(caps=[[8]], dtypes=["float32", "bfloat16"], calls=200,
             time=True, missing=1, timeout_s=2.0)),
    (4, dict(caps=[[8, 0, 16], [0, 8, 0]], dtypes=["float32", "bfloat16"],
             calls=200)))


def k12_ranks_phase(base: Path, seed: int, card: str,
                    pair: list[dict]) -> dict:
    """The cross-rank K12 alone (``tools/k12_ranks.py``) with 2 ranks
    (``pair``: their results, K12_RANK_JOBS[0]) and 4 (each rank this
    script with ``--rank_job``) sharing the card: both
    ways, the backward and 200 calls back to back, bit for bit with
    ``_ring_move`` and with gloo's move of the same buffers; the median host
    ms of one synchronized exchange over 200 calls for the cross-rank K12,
    gloo's move and the one-process K12; a peer that never calls makes
    its destination raise within its limit (2 s) plus 10 s."""
    t0 = time.perf_counter()
    out = {}
    for world, k12 in K12_RANK_JOBS:
        k12 = dict(k12, seed=seed)
        t_w = time.perf_counter()
        if world == 2:
            ranks = [r["res"] for r in pair]
            t_w -= max(r["wall_s"] for r in pair)
        else:
            port = _free_port()
            jobs = [dict(kind="exchange", k12=k12,
                         cwd=str(base / f"k12_{world}" / f"rank{r}"))
                    for r in range(world)]
            envs = [dict(WORLD_SIZE=str(world), RANK=str(r),
                         LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                         MASTER_PORT=str(port)) for r in range(world)]
            ranks = [r["res"] for r in run_ranks(jobs, envs)]
        cases = len(k12["caps"]) * len(k12["dtypes"])
        for r, got in enumerate(ranks):
            bad = {name: case for name, case in got["cases"].items()
                   if not all(v for k, v in case.items()
                              if k.endswith("_equal"))}
            check(got["shard"] == r and not bad,
                  f"cross-rank K12, {world} ranks, rank {r}: cases not bit "
                  f"for bit with the plain versions {bad}")
            # each case: 2 exchanges, the backward's forward, the chain of
            # 200, and 201 timed calls; the missing peer's plan and call
            want = 203 * cases + 201 * cases * bool(k12.get("time"))
            if "missing" in got:
                want += 1 + got["missing"]["called"]
            check(got["launches"] == [want, cases],
                  f"cross-rank K12, {world} ranks, rank {r}: launches "
                  f"{got['launches']}, expected one an exchange "
                  f"({[want, cases]})")
        if "missing" in k12:
            m = [got["missing"] for got in ranks]
            check(m[1] == {"called": False, "raised": False}
                  and m[0]["raised"] and "rank 1 (EP shard 1)"
                  in m[0]["message"] and m[0]["seconds"]
                  <= k12["timeout_s"] + 10.0,
                  f"cross-rank K12, a peer that never calls: {m}")
            print(f"cross-rank K12, 2 ranks, rank 1 never calls: rank 0 "
                  f"raised after {m[0]['seconds']:.3f} s (limit "
                  f"{k12['timeout_s']} s): {m[0]['message']} [{card}]")
        out[world] = dict(ranks=ranks, wall_s=time.perf_counter() - t_w)
        print(f"cross-rank K12, {world} ranks sharing the card, caps "
              f"{k12['caps']} at {k12['dtypes']} (H 400): both ways, the "
              f"backward and {k12['calls']} calls back to back bit for bit "
              f"with _ring_move and gloo's move on every rank; launches "
              f"{[got['launches'] for got in ranks]}; wall "
              f"{out[world]['wall_s']:.1f} s [{card}]")
    for name, case in out[2]["ranks"][0]["cases"].items():
        print(f"cross-rank K12 {name}, median host ms of one synchronized "
              f"exchange over 200 calls, shared card: cross-rank K12 "
              f"{case['rank_k12_ms']:.4f} (rank 1: "
              f"{out[2]['ranks'][1]['cases'][name]['rank_k12_ms']:.4f}), "
              f"gloo's _rank_ring_move {case['gloo_ms']:.4f}, the "
              f"one-process K12 on both shards "
              f"{case['one_process_k12_ms']:.4f} [{card}]")
    out["wall_s"] = time.perf_counter() - t0
    return out


def flat_ranks(base: Path, seed: int, card: str, ranks: list[dict]) -> dict:
    """The wired set of ``wired_trainer`` in the flat layout, one shard a
    rank (``ranks``: their results; the all-to-alls through gloo) against
    the lockstep run in this process: one training step and one eval, SSEs
    bit for bit, gradients within 1e-6 of their largest, K7 launches half
    of lockstep's a rank."""
    t0 = time.perf_counter() - max(r["wall_s"] for r in ranks)
    run_dir = base / "flat_ep2"
    one = flat_wired_step(seed, DEVICE, run_dir / "one.npz")
    grads_one = list(np.load(run_dir / "one.npz").values())
    grads = [list(np.load(run_dir / f"rank{r}" / "grads.npz").values())
             for r in range(2)]
    top = max(float(np.abs(g).max()) for g in grads_one)
    grad_rel = max(float(np.abs(a - b).max()) / top for gs in grads
                   for a, b in zip(gs, grads_one))
    same = all(r["res"][k] == one[k] for r in ranks
               for k in ("sse", "sse_eval"))
    k7 = [sum(r["res"]["launches"][:2]) for r in ranks]
    check(same and grad_rel <= 1e-6 and k7[0] == k7[1]
          and sum(k7) == sum(one["launches"][:2]),
          f"2 ranks, one flat shard each, wired set: SSEs "
          f"{[(r['res']['sse'], r['res']['sse_eval']) for r in ranks]} "
          f"against lockstep's {(one['sse'], one['sse_eval'])} (bit for "
          f"bit: {same}), gradients within {grad_rel:.3e} of their largest "
          f"(limit 1e-6), K7 launches {k7} against lockstep's "
          f"{one['launches']}")
    coll_ms = [1e3 * r["coll_s"] for r in ranks]
    res = dict(launches=[r["moved"] for r in ranks], k7=k7,
               grad_rel=grad_rel, coll_ms=coll_ms,
               coll_calls=[r["coll_calls"] for r in ranks], sse=one["sse"],
               wall_s=time.perf_counter() - t0)
    print(f"multi-process flat layout, one shard a rank (torchrun "
          f"variables, 2 ranks): one training step (dropout 0.1) and one "
          f"eval of the wired set, SSEs ({one['sse']}, {one['sse_eval']}) "
          f"bit for bit with the lockstep run on both ranks, gradients "
          f"within {grad_rel:.3e} of their largest; K7 launches a rank "
          f"{k7} against lockstep's {one['launches'][:2]}; collectives' "
          f"host ms (all-to-alls, sums, the all-reduce; waiting included) "
          f"{coll_ms} over {ranks[0]['coll_calls']} calls; wall "
          f"{res['wall_s']:.1f} s [{card}]")
    return res


def descriptor_phase(tmp: Path, seed: int, ckpt: Path, card: str) -> dict:
    """The MACE descriptor pipeline behind ``--data_path_coordinates``:
    ``examples/demo.csv`` copied into a temporary directory beside an xyz
    written by ``data.preprocess.write_xyz_frames`` (three frames a
    reaction, its atoms in atom-map order, positions from ``seed``);
    ``data.descriptors._mace_descriptor_fn`` replaced by a numpy backend of
    64 dims a structure that depends on each row (F = 78 + 3 x 64, the
    README model's); ``activation_energy_prediction(input_coordinates=...)``
    on the card with the full-width checkpoint ``ckpt``: its predictions
    equal serving the npz it wrote (``npz_path=``) bit for bit and the CPU
    within REL_TOL, K3f launched, the stage times with the xyz -> npz step
    apart; then the unpatched call raises ImportError naming mace-torch
    and writes no npz."""
    import torch
    from cgr_mpnn_3d_tpu_torch.chem.mol import mol_from_smiles
    from cgr_mpnn_3d_tpu_torch.cli import predict as cli_predict
    from cgr_mpnn_3d_tpu_torch.data import descriptors
    from cgr_mpnn_3d_tpu_torch.data.preprocess import write_xyz_frames
    from cgr_mpnn_3d_tpu_torch.ops import fused_model as fm
    t_phase = time.perf_counter()
    d = tmp / "descriptors"
    d.mkdir(parents=True, exist_ok=True)
    csv_path = d / "demo.csv"
    shutil.copy(ROOT / "examples" / "demo.csv", csv_path)
    rng = np.random.default_rng(seed)
    frames = []
    for smi in _smiles_of(csv_path):
        atoms = mol_from_smiles(smi.split(">")[0]).atoms
        syms = [a.symbol for a in sorted(atoms, key=lambda a: a.map_num)]
        for state in ("r", "ts", "p"):
            frames.append((syms, rng.standard_normal((len(syms), 3)),
                           f"state={state}"))
    xyz = d / "demo.xyz"
    write_xyz_frames(xyz, frames)
    proj = np.random.default_rng(seed + 1).standard_normal((4, 64))

    def backend(symbols, positions):
        z = np.asarray([[ord(s[0]) / 100.0] for s in symbols])
        return np.tanh(np.concatenate([np.asarray(positions), z], 1) @ proj)

    timed = {}
    step = cli_predict.process_xyz_to_npz

    def timed_step(*a, **kw):
        t0 = time.perf_counter()
        step(*a, **kw)
        timed["xyz_to_npz_ms"] = (time.perf_counter() - t0) * 1e3

    def request(device, **kw):
        t0 = time.perf_counter()
        res = cli_predict.activation_energy_prediction(
            str(csv_path), output_results=str(d / "results.txt"),
            model_path=str(ckpt), device=device, **kw)
        if device != "cpu":
            torch.cuda.synchronize()
        return (np.array([r["Activation Energy"] for r in res]),
                (time.perf_counter() - t0) * 1e3)

    orig = descriptors._mace_descriptor_fn
    descriptors._mace_descriptor_fn = lambda model, device: backend
    cli_predict.process_xyz_to_npz = timed_step
    try:
        fm.launches = 0
        got, wall_ms = request(DEVICE, input_coordinates=str(xyz))
        launches = fm.launches
        xyz_ms = timed["xyz_to_npz_ms"]
        npz = d / "demo.npz"
        with np.load(npz) as z:
            shapes = {z[k].shape for k in z.files}
        served, serve_ms = request(DEVICE, npz_path=str(npz))
        cpu, _ = request("cpu", input_coordinates=str(xyz))
    finally:
        descriptors._mace_descriptor_fn = orig
        cli_predict.process_xyz_to_npz = step
    rel = float(np.abs(got - cpu).max()) / max(float(np.abs(cpu).max()),
                                                1e-30)
    check(got.shape == (len(frames) // 3,) and np.isfinite(got).all()
          and all(s[1] == 192 for s in shapes) and launches > 0
          and np.array_equal(got, served) and rel <= REL_TOL,
          f"predict from xyz: {got} against the npz's {served} and the "
          f"CPU's {cpu} (rel {rel:.3e}), descriptor shapes {shapes}, K3f "
          f"launches {launches}")
    npz.unlink()
    # the default backend: where mace-torch is installed it would fetch
    # its model, so the refusal is checked only where it is absent
    raised = None
    if importlib.util.find_spec("mace") is None:
        try:
            request(DEVICE, input_coordinates=str(xyz))
        except ImportError as e:
            raised = str(e)
        check(raised is not None and "mace-torch" in raised
              and not npz.exists(),
              f"predict from xyz without a backend: {raised!r}, npz "
              f"written {npz.exists()}")
    out = dict(reactions=len(got), launches=launches, rel_cpu=rel,
               wall_ms=wall_ms, xyz_to_npz_ms=xyz_ms, serve_npz_ms=serve_ms,
               wall_s=time.perf_counter() - t_phase)
    print(f"descriptor pipeline: {len(got)} demo reactions from xyz "
          f"({len(frames)} frames, 64 dims a structure, numpy backend) on "
          f"the card: {wall_ms:.3f} ms a request, of which xyz -> npz "
          f"{xyz_ms:.3f} ms; serving the written npz {serve_ms:.3f} ms, "
          f"predictions equal bit for bit; card vs CPU {rel:.3e} (limit "
          f"{REL_TOL}); K3f launches {launches}; the default backend: "
          + ("ImportError, no npz written" if raised
             else "mace-torch is installed, not called")
          + f"; phase wall {out['wall_s']:.1f} s [{card}]")
    return out


def mace_phase(tmp: Path, seed: int, repeats: int, card: str) -> dict:
    """The MACE kernels MI and MP (``csrc/mace.cu``) on the geometry
    screen's first window: that cell's library (``gpubench``'s traffic
    ``screen_geometry``: 2,048 corpus reactions drawn from ``seed``, their
    seeded reactant, TS and product geometries, batch 1024) as a
    ``GeometryDataset``, its first packed window laid out by
    ``GeometryTables.window``; MACE-MP-0 small and the README head at
    F = 846 (``gpubench/configs/mace_mp_small_cgr_3d.json``) on weights
    drawn from ``seed``.  Each layer's ``ops.mace_interaction`` and
    ``ops.mace_product`` on the card against their plain versions on the
    same inputs (on the card, TF32 off) within MACE_TOL of the largest
    plain value; the kernels' and the plain versions' ms over both layers
    (CUDA events, ``repeats`` and 3 calls); each kernel's f32 bound over
    the window's real atoms and edges (``gpubench/cost_mace.py``).  Then
    one request of ``predict`` over the library on the card after a warm
    one, the launch counters zeroed just before it and read after (each MACE kernel once a
    layer a window), its first window's descriptors equal bit for bit to
    the held calls' output, its predictions finite."""
    import torch
    from cgr_mpnn_3d_tpu_torch.data import GeometryDataset, plan_spec
    from cgr_mpnn_3d_tpu_torch.data.batch import device_tensor
    from cgr_mpnn_3d_tpu_torch.data.loader import PackedLoader
    from cgr_mpnn_3d_tpu_torch.models import (CGRMPNN, CGRMPNNConfig, MACE,
                                              MACEConfig)
    from cgr_mpnn_3d_tpu_torch.ops import fused_model as fm
    from cgr_mpnn_3d_tpu_torch.ops import mace as ops
    from cgr_mpnn_3d_tpu_torch.train.evaluate import predict
    from gpubench import data as gdata
    from gpubench import geometry as ggeo
    from gpubench.cost_mace import mace_cost
    from gpubench.reference import mace as ref_mace
    from gpubench.reference.model import Dims, make_weights
    t_phase = time.perf_counter()
    cfg = json.loads((ROOT / "gpubench" / "configs"
                      / "mace_mp_small_cgr_3d.json").read_text())
    trf = json.loads((ROOT / "gpubench" / "traffic"
                      / "screen_geometry.json").read_text())
    m = cfg["mace"]
    smiles, labels = gdata.corpus()
    rows = gdata.draw_rows(trf["library_rows"], seed, "library")
    s = [smiles[i] for i in rows]
    d = tmp / "mace"
    d.mkdir(parents=True, exist_ok=True)
    csv_path, _ = gdata.write_split(d, "library", s, labels[rows], None)
    xyz = ggeo.write_xyz(d / "library.xyz",
                         ggeo.geometries(s, gdata.rng(seed, "geometry")))
    ds = GeometryDataset(str(csv_path), str(xyz))
    ds.prefeaturize()
    spec = plan_spec([ds.graph(i) for i in range(len(ds))])
    dev = torch.device(DEVICE)
    mace = MACE(MACEConfig(
        num_channels=m["channels"], num_interactions=m["interactions"],
        max_ell=m["max_ell"], num_bessel=m["bessel"],
        num_polynomial_cutoff=m["polynomial_cutoff"],
        radial_mlp=tuple(m["radial_mlp"]), correlation=m["correlation"],
        num_elements=m["elements"], r_max=m["r_max"],
        avg_num_neighbors=m["avg_num_neighbors"]))
    mace.load_state_dict(ref_mace.make_weights(m, seed, "cpu"))
    mace = mace.to(dev).eval()
    L, H = cfg["depth"], cfg["hidden"]
    head = CGRMPNN(CGRMPNNConfig(
        num_node_features=cfg["node_features"],
        num_edge_features=cfg["edge_features"], depth=L,
        hidden_sizes=(H,) * L, dropout_ps=(cfg["dropout"],) * L))
    head.load_state_dict(make_weights(
        Dims(cfg["node_features"], cfg["edge_features"], H, L), seed, "cpu"))
    head = head.to(dev).eval()

    b = next(iter(PackedLoader(ds, spec, batch_size=trf["batch_size"])))
    lay = ds.geometry.window(b.row_ids, b.graph_mask, b.graph_nodes,
                             b.node_x.shape[0], mace.cfg.r_max)
    pos, z, sptr, tiles = (device_tensor(a, dev) for a in (
        lay.pos, lay.z, lay.struct_ptr, lay.tiles.numpy()))
    A, C = len(lay.z), mace.cfg.num_channels
    errs = {"MI": [], "MP": []}

    def held(name, got, want):
        diff = float((got - want).abs().max())
        errs[name].append((diff, diff / max(float(want.abs().max()),
                                            1e-30)))

    calls = []
    with torch.no_grad():
        prep = mace.prepared()
        out = torch.empty(A, mace.cfg.descriptor_dim, device=dev)
        out_plain = torch.empty_like(out)
        hup, sc = prep["hup0"][z.long()], None
        for t, lw in enumerate(prep["layers"]):
            inter = (pos, sptr, hup, lw["radial"], mace.cfg.r_max,
                     mace.cfg.num_polynomial_cutoff)
            msg = ops.mace_interaction(*inter)
            held("MI", msg, ops.mace_interaction_ref(*inter))
            tail = (lw["m"], lw["m_shared"], lw["weff"], prep["mono"],
                    prep["coef"], prep["ptr"], lw["wout"], sc)
            nxt = (t * C, lw["wup_next"], lw["wskip_next"])
            prod = (msg, z, tiles, *tail, out, *nxt)
            plain = (msg, z, *tail, out_plain, *nxt)
            got, want = ops.mace_product(*prod), ops.mace_product_ref(*plain)
            cols = slice(t * C, (t + 1) * C)
            held("MP", out[:, cols], out_plain[:, cols])
            for g, w in zip(got, want):
                if w is not None:
                    held("MP", g, w)
            calls.append((inter, prod, plain))
            hup, sc = got
        ms = {"MI": time_ms(lambda: [ops.mace_interaction(*c[0])
                                     for c in calls], repeats),
              "MP": time_ms(lambda: [ops.mace_product(*c[1])
                                     for c in calls], repeats)}
        plain_ms = {"MI": time_ms(lambda: [ops.mace_interaction_ref(*c[0])
                                           for c in calls], 3),
                    "MP": time_ms(lambda: [ops.mace_product_ref(*c[2])
                                           for c in calls], 3)}
    window_out = out.clone()
    cost = mace_cost(m, A, lay.n_edges, len(lay.struct_ptr) - 1,
                     len(np.unique(lay.z)), len(lay.tiles))
    for name in errs:
        rel = max(r for _, r in errs[name])
        check(rel <= MACE_TOL, f"{name} on the geometry screen's first "
              f"window: rel err {rel:.3e} against its plain version "
              f"(limit {MACE_TOL})")

    class FirstWindows:
        """The model as ``predict`` is given it, keeping each window's
        descriptors."""

        def __init__(self):
            self.cfg, self.kept = mace.cfg, []

        def descriptors(self, *a):
            got = mace.descriptors(*a)
            self.kept.append(got)
            return got

    seen = FirstWindows()
    # one request first, so that the timed one builds nothing
    predict(head, ds, spec, batch_size=trf["batch_size"], device=dev,
            mace=mace)
    torch.cuda.synchronize()
    ops.interaction_launches = ops.product_launches = fm.launches = 0
    t0 = time.perf_counter()
    preds = predict(head, ds, spec, batch_size=trf["batch_size"],
                    device=dev, mace=seen)
    torch.cuda.synchronize()
    request_ms = (time.perf_counter() - t0) * 1e3
    launches = {"MI": ops.interaction_launches,
                "MP": ops.product_launches, "K3f": fm.launches}
    windows = len(seen.kept)
    plan = mace.cfg.num_interactions * windows
    check(windows > 0 and launches["MI"] == plan == launches["MP"]
          and launches["K3f"] > 0 and preds.shape == (len(ds),)
          and np.isfinite(preds).all()
          and torch.equal(seen.kept[0], window_out),
          f"predict from geometries: {windows} windows, launches "
          f"{launches} (MI, MP {plan} each), predictions "
          f"{preds.shape} finite {np.isfinite(preds).all()}, first window "
          f"as held {torch.equal(seen.kept[0], window_out)}")
    res = {"launches": launches, "windows": windows,
           "request_ms": request_ms, "wall_s": time.perf_counter() - t_phase}
    for name, kind in (("MI", "interaction"), ("MP", "product")):
        bound_ms, bound_by = bound(cost[kind], False)
        res[name] = dict(abs_err=max(a for a, _ in errs[name]),
                         rel_err=max(r for _, r in errs[name]),
                         ms=ms[name], plain_ms=plain_ms[name],
                         bound_ms=bound_ms, bound_by=bound_by,
                         ops=cost[kind][0] + cost[kind][1],
                         bytes=cost[kind][2], library_ms=None)
        e = res[name]
        print(f"mace {name} ({kind}), both layers on the geometry screen's "
              f"first window ({A} atoms, {len(lay.struct_ptr) - 1} "
              f"structures, {lay.n_edges} edges): max abs err "
              f"{e['abs_err']:.3e}, rel {e['rel_err']:.3e} (limit "
              f"{MACE_TOL}); kernel {e['ms']:.4f} ms, plain "
              f"{e['plain_ms']:.4f} ms, f32 bound {e['bound_ms']:.4f} ms by "
              f"{bound_by} ({e['ops'] / 1e9:.3f} GFLOP, "
              f"{e['bytes'] / 1e6:.3f} MB), "
              f"{100 * e['bound_ms'] / e['ms']:.1f}% of it [{card}]")
    print(f"mace request: predict over {len(ds)} reactions from geometries, "
          f"{windows} windows, {request_ms:.3f} ms; launches MI "
          f"{launches['MI']}, MP {launches['MP']}, K3f {launches['K3f']}; "
          f"phase wall {res['wall_s']:.1f} s [{card}]")
    return res


def mace_entries(mc: dict) -> list:
    """The ``kernels`` line's entries of MI and MP from :func:`mace_phase`
    (no JAX kernel: the JAX package took descriptors from ``mace-torch``
    on the host)."""
    return [{"name": name, "route": "cuda",
             "source": "cgr_mpnn_3d_tpu_torch/csrc/mace.cu",
             "replaces": "cgr_mpnn_3d_tpu/data/descriptors.py:64",
             "launches": mc["launches"][key],
             "max_abs_err": mc[key]["abs_err"], "ms": mc[key]["ms"],
             "plain_ms": mc[key]["plain_ms"],
             "bound_ms": mc[key]["bound_ms"],
             "bound_by": mc[key]["bound_by"], "library_ms": None}
            for name, key in (("mace_interaction", "MI"),
                              ("mace_product", "MP"))]


def train_profile(tmp: Path, seed: int, card: str) -> dict:
    """Steps/s of the training step alone (batches already on the card) and
    the card's busy share of an epoch of steps under torch.profiler, with
    f32 and with bf16 compute (the same model and batches); returns the
    steps/s of each."""
    import torch
    from cgr_mpnn_3d_tpu_torch.data import ChemDataset, plan_spec, to_device
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNNConfig
    from cgr_mpnn_3d_tpu_torch.train import RxnGraphTrainer
    data = tmp / "datasets"
    ds = ChemDataset(str(data / "train.csv"),
                     data_npz_path=str(data / "train.npz"))
    ds.prefeaturize()
    spec = plan_spec([ds.graph(i) for i in range(len(ds))])
    rates = {}
    for dtype in ("float32", "bfloat16"):
        cfg = CGRMPNNConfig(num_node_features=ds.num_node_features,
                            num_edge_features=ds.num_edge_features, depth=4,
                            hidden_sizes=(400,) * 4, dropout_ps=(0.1,) * 4,
                            compute_dtype=dtype)
        tr = RxnGraphTrainer(name="profile", cfg=cfg, train_data=ds,
                             val_data=ds, spec=spec, lr=1e-4,
                             weight_decay=1e-5, gamma=0.9, batch_size=64,
                             seed=seed, model_save_dir=str(tmp / "profile"),
                             device=DEVICE)
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
        rates[dtype] = n / (time.perf_counter() - t0)
        print(f"train step {dtype}: {rates[dtype]:.2f} steps/s over {n} "
              f"steps of {len(batches)} corpus batches already on the card "
              f"(p = {tr.train_loader.spec.p}) [{card}]")
        for _ in range(2):
            wall_ms, dev_ms, top = device_busy(
                lambda: [tr._train_step(b) for b in batches], top=6)
            print(f"profile train epoch {dtype} ({len(batches)} steps): "
                  f"wall {wall_ms:.3f} ms, device busy {dev_ms:.3f} ms "
                  f"({100 * dev_ms / wall_ms:.1f}%), top device time {top} "
                  f"[{card}]")
    return rates


BF16_TOL = 5e-3     # bf16 kernel vs its bf16 plain version: rel-L2 of values
BF16_COS = 0.999    # ... and the cosine of the gradients
BF16_SHARE = 0.5    # ... and its rel-L2 at most this share of its rel-L2 to
                    # the f32 plain version (predictions, gradients)
BF16_TRAIN_TOL = 1e-2  # bf16 card vs CPU per-epoch RMSE, relative
BF16 = "bfloat16"


def rel_l2(got, want) -> float:
    """Relative L2 distance of two lists of tensors taken as one vector."""
    import torch
    a = torch.cat([t.double().flatten() for t in got])
    b = torch.cat([t.double().flatten() for t in want])
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def cosine(got, want) -> float:
    import torch
    a = torch.cat([t.double().flatten() for t in got])
    b = torch.cat([t.double().flatten() for t in want])
    return float(a @ b / max(float(a.norm() * b.norm()), 1e-30))


def bf16_kernels_vs_plain(cfg_kw: dict, spec, batch, seed: int,
                          repeats: int) -> dict:
    """The bf16 instantiation of K3f (eval mode), K2 and K3b (train mode,
    the config's dropout) against their bf16 plain versions on one batch,
    with seeded weights, labels, cotangents and dropout seeds: predictions
    and SSE within rel-L2 BF16_TOL, gradients at cosine >= BF16_COS (the
    f32 sums run in other orders, which can flip a bf16 rounding, so
    nothing is held per output); a second run of K2 and K3b bit for bit;
    against the f32 plain version within tests/test_bf16.py's bounds
    (predictions rel-L2 < 1.5e-2, SSE rtol 2e-2, gradient cosine > 0.995
    and rel-L2 < 0.1).

    Those limits alone would pass a kernel that ran its f32 products at
    mat_dtype bf16: bf16 and f32 differ by less.  So the predictions (K3f)
    and the gradients (K2, K3b) are held by their two distances as well:
    to the bf16 plain version at most BF16_SHARE of that to the f32 plain
    version.  The f32 kernel on the same inputs is the control: it must
    fail that hold.  With ``repeats``: times and bounds (products at the
    bf16 tensor-core peak, gathers at the f32 peak)."""
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
    ev = dict(p=spec.p, act=ACTIVATIONS[cfg.activation], aggr=cfg.aggr,
              pooling=cfg.pooling)
    kw = dict(ev, train=True, seeds=kernel_seeds(cfg, gen).tolist(),
              dropout_ps=cfg.dropout_ps)
    with torch.no_grad():
        args = kernel_inputs(model, batch)
    adj = adjoint_inputs(batch)
    real = mask > 0
    bf16 = "bfloat16"
    # (kernel, plain version), each called at mat_dtype ``md``
    calls = {
        "fwd": (lambda md=bf16: fm.fused_model_forward(*args, **ev,
                                                       mat_dtype=md),
                lambda md=bf16: fm.fused_model_forward_ref(*args, **ev,
                                                           mat_dtype=md)),
        "train": (lambda md=bf16: fm.fused_model_train(
                      args, adj, labels, mask, **kw, mat_dtype=md),
                  lambda md=bf16: fm.fused_model_train_ref(
                      args, adj, labels, mask, **kw, mat_dtype=md)),
        "vjp": (lambda md=bf16: fm.fused_model_vjp(args, adj, dpred, **kw,
                                                   mat_dtype=md),
                lambda md=bf16: fm.fused_model_vjp_ref(args, adj, dpred, **kw,
                                                       mat_dtype=md)),
    }

    def parts(name, res):
        """(values, gradients) of one call's result."""
        if name == "fwd":
            return [res[real]], []
        if name == "train":
            return [res[0]], list(res[1])
        return [], list(res)

    def shares(name, res, want, want32):
        """(rel-L2 to the bf16 plain version, to the f32 plain version, the
        first over the second) of the held part: predictions or gradients."""
        held = [parts(name, r)[name != "fwd"] for r in (res, want, want32)]
        near, far = rel_l2(held[0], held[1]), rel_l2(held[0], held[2])
        return near, far, near / max(far, 1e-30)

    out = dict(p=spec.p, graphs=int(real.sum()))
    for name, (kern, plain) in calls.items():
        with torch.no_grad():
            got, want, want32 = kern(), plain(), plain("float32")
            again = kern() if name != "fwd" else got
            control = kern("float32")
        torch.cuda.synchronize()
        (gv, gg), (wv, wg), (v32, g32) = (parts(name, r)
                                          for r in (got, want, want32))
        check(all(bool(torch.isfinite(t).all()) for t in gv + gg),
              f"bf16 {name} outputs are not finite")
        entry = dict(abs_err=max(float((g - w).abs().max())
                                 for g, w in zip(gv + gg, wv + wg)))
        near, far, share = shares(name, got, want, want32)
        ctrl = shares(name, control, want, want32)[2]
        entry.update(near=near, far=far, share=share, control_share=ctrl)
        check(share <= BF16_SHARE,
              f"bf16 {name}: rel-L2 to the bf16 plain version {near:.3e} is "
              f"{share:.3f} of that to the f32 plain version {far:.3e} "
              f"(> {BF16_SHARE}) for {cfg_kw}")
        check(ctrl > BF16_SHARE,
              f"bf16 {name}: the f32 kernel passes the bf16 hold (share "
              f"{ctrl:.3f} <= {BF16_SHARE}) for {cfg_kw}")
        if gv:
            entry.update(rel_l2=rel_l2(gv, wv), f32_rel_l2=rel_l2(gv, v32))
            check(entry["rel_l2"] <= BF16_TOL,
                  f"bf16 {name}: kernel vs bf16 plain rel-L2 "
                  f"{entry['rel_l2']:.3e} > {BF16_TOL} for {cfg_kw}")
            check(0.0 < entry["f32_rel_l2"] < (1.5e-2 if name == "fwd"
                                               else 2e-2),
                  f"bf16 {name}: vs the f32 plain version "
                  f"{entry['f32_rel_l2']:.3e} for {cfg_kw}")
        if gg:
            entry.update(cos=cosine(gg, wg), f32_cos=cosine(gg, g32),
                         f32_grad_rel_l2=rel_l2(gg, g32))
            check(entry["cos"] >= BF16_COS,
                  f"bf16 {name}: gradient cosine {entry['cos']:.6f} < "
                  f"{BF16_COS} for {cfg_kw}")
            check(entry["f32_cos"] > 0.995 and entry["f32_grad_rel_l2"] < 0.1,
                  f"bf16 {name}: gradients vs f32 cosine "
                  f"{entry['f32_cos']:.6f}, rel-L2 "
                  f"{entry['f32_grad_rel_l2']:.3e} for {cfg_kw}")
        if name != "fwd":
            same = all(torch.equal(x, y) for x, y in
                       zip(sum(parts(name, got), []),
                           sum(parts(name, again), [])))
            check(same, f"two runs of bf16 {name} differ")
        if repeats:
            with torch.no_grad():
                _timed(entry, kern, plain, repeats,
                       forward_cost(args) if name == "fwd"
                       else train_cost(args, adj), bf16=True)
        out[name] = entry
    return out


def print_bf16(what: str, k: dict, card: str) -> None:
    for name, e in k.items():
        if not isinstance(e, dict):
            continue
        line = (f"bf16 {name} {what}: {k['graphs']} graphs in {k['p']} "
                f"packs, max abs err {e['abs_err']:.3e}; "
                f"{'predictions' if name == 'fwd' else 'gradients'} rel-L2 "
                f"vs bf16 plain {e['near']:.3e}, vs f32 plain {e['far']:.3e}, "
                f"share {e['share']:.4g} (limit {BF16_SHARE}; the f32 "
                f"kernel's {e['control_share']:.4g})")
        if name == "train":
            line += (f", SSE rel-L2 vs bf16 plain {e['rel_l2']:.3e}, vs f32 "
                     f"plain {e['f32_rel_l2']:.3e}")
        if "cos" in e:
            line += (f", gradient cosine vs bf16 plain {e['cos']:.8f}, vs "
                     f"f32 plain {e['f32_cos']:.8f} (rel-L2 "
                     f"{e['f32_grad_rel_l2']:.3e})")
        if "ms" in e:
            line += (f"; kernel {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} "
                     f"ms, bf16 bound {e['bound_ms']:.4f} ms "
                     f"({e['ops'] / 1e9:.3f} GFLOP, {e['bytes'] / 1e6:.3f} "
                     f"MB, {e['bound_by']}-bound) [{card}]")
        print(line)


def train_phase_bf16(tmp: Path, seed: int, card: str,
                     f32_steps_per_s) -> dict:
    """``cli.train.main`` with the README's flags and ``--compute_dtype
    bfloat16``: 3 epochs on the card with ``--log_histograms``, then 2 on
    the CPU.  Every training step is one bf16 K2 launch and no f32 K2
    launch, the histograms go through the bf16 K3b and no f32 K3b,
    validation through the bf16 K3f, the test after training through the
    f32 K3f (cli/test.py loads the checkpoint in f32, as the JAX CLI
    does); per-epoch
    RMSE card vs CPU within BF16_TRAIN_TOL; steps/s beside the f32 run's.
    Runs in its own working directory (the run name carries no dtype)."""
    import torch
    from cgr_mpnn_3d_tpu_torch.ops import fused_model as fm
    data = tmp / "datasets"
    work = tmp / "bf16"
    work.mkdir(exist_ok=True)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        # the main path: counts are zeroed just before it and read just after
        fm.launches = fm.train_launches = fm.vjp_launches = 0
        fm.bf16_launches = fm.bf16_train_launches = fm.bf16_vjp_launches = 0
        t0 = time.perf_counter()
        card_res = train_cli(tmp, data, seed, DEVICE, 3, "card_bf16",
                             "--log_histograms", "--compute_dtype",
                             "bfloat16")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fwd=fm.bf16_launches, train=fm.bf16_train_launches,
                        vjp=fm.bf16_vjp_launches, f32=(fm.launches,
                                                       fm.train_launches,
                                                       fm.vjp_launches))
        steps = card_res["steps"]
        check(launches["train"] == steps > 0 and launches["f32"][1:] == (0, 0),
              f"bf16 training launches {launches} for {steps} steps")
        check(launches["vjp"] == 3, f"{launches['vjp']} bf16 VJP launches for "
                                    f"3 epochs of gradient histograms")
        check(launches["fwd"] > 0, "bf16 validation launched no bf16 forward "
                                   "kernel")
        check(launches["f32"][0] > 0, "the f32 test launched no f32 forward "
                                      "kernel")
        cpu_res = train_cli(tmp, data, seed, "cpu", 2, "cpu_bf16",
                            "--log_histograms", "--compute_dtype", "bfloat16")
        steps_per_s = [json.loads(line).get("steps_per_s")
                       for f in (work / "runs").glob("*_e-3_*.jsonl")
                       for line in f.read_text().splitlines()
                       if '"train_loss"' in line]
    finally:
        os.chdir(cwd)
    losses = [card_res["train_losses"], card_res["val_losses"],
              cpu_res["train_losses"], cpu_res["val_losses"],
              [card_res["test_losses"], cpu_res["test_losses"]]]
    check(all(np.isfinite(v).all() and len(v) for v in losses),
          f"bf16 training losses are not finite: {losses}")
    rel = max(abs(a - b) / abs(b) for key in ("train_losses", "val_losses")
              for a, b in zip(card_res[key], cpu_res[key]))
    check(rel <= BF16_TRAIN_TOL, f"bf16 card vs CPU per-epoch RMSE differ "
                                 f"by {rel:.3e} > {BF16_TRAIN_TOL}")
    print(f"train cli bf16 card: 3 epochs, {steps} steps in {wall:.3f} s "
          f"wall, train RMSE {card_res['train_losses']}, val RMSE "
          f"{card_res['val_losses']}, test RMSE {card_res['test_losses']}; "
          f"launches: bf16 training kernel {launches['train']}, bf16 VJP "
          f"kernel {launches['vjp']}, bf16 forward kernel {launches['fwd']}, "
          f"f32 (forward, train, VJP) {launches['f32']}; steps/s per epoch "
          f"(StepTimer) bf16 {steps_per_s}, f32 {f32_steps_per_s} [{card}]")
    print(f"train cli bf16 cpu: 2 epochs, train RMSE "
          f"{cpu_res['train_losses']}, val RMSE {cpu_res['val_losses']}; "
          f"card vs CPU max rel diff {rel:.3e} (limit {BF16_TRAIN_TOL})")
    return dict(launches=launches, rel=rel, steps=steps,
                steps_per_s=steps_per_s)


def nbytes_of(*ts) -> int:
    """Bytes of the tensors, each element at its own size (bf16 2 B)."""
    return sum(t.numel() * t.element_size() for t in ts)


def spmm_cost(src, idx, sign, p: int,
              out_size: int = 4) -> tuple[float, float, float]:
    """(0 products, adds, bytes) of the ELL gather-sum on these inputs: one add
    per counted entry and column; every input read once, the output (f32,
    or of ``out_size`` bytes an element) written once."""
    from cgr_mpnn_3d_tpu_torch.ops.segment import in_pack
    H = src.shape[1]
    n = int(in_pack(idx, p, src.shape[0])[1].sum())
    nbytes = nbytes_of(src, idx) + idx.shape[0] * H * out_size
    if sign is not None:
        n += int(in_pack(sign, p, src.shape[0])[1].sum())
        nbytes += sign.numel() * 4
    return 0.0, float(n * H), float(nbytes)


def glin_cost(xa, xb, idx, wa, p: int, rows_out: int, rows_a: int,
              adj=None, out_size: int = 4) -> tuple[float, float, float]:
    """(product operations, other operations, bytes) of the gather-linear
    on these inputs over the
    real rows: the products, the gathered product taken over the smaller of
    its two row sets ((G·xa)·Wa = G·(xa·Wa)), the gather's adds over the
    narrower width; backward dxa, dxb, dWa, dWb and db (ReLU: dpre from
    the output, no recomputation), when the adjoint ELL ``adj`` is given.
    Bytes: every input read once (the backward's with ``adj``, the output
    and its cotangent, ``out_size`` bytes an element), every output written
    once, each at its type's size."""
    from cgr_mpnn_3d_tpu_torch.ops.segment import in_pack
    FA, FB, H = xa.shape[1], xb.shape[1], wa.shape[1]
    m, R = min(rows_out, rows_a), rows_out
    adds = int(in_pack(idx, p, xa.shape[0])[1].sum()) * min(FA, H)
    weights = (FA + FB + 1) * H * 4
    ins = nbytes_of(xa, xb, idx) + weights
    out = xb.shape[0] * H * out_size
    if adj is None:
        return (float(2 * m * FA * H + 2 * R * FB * H), float(adds),
                float(ins + out))
    nbytes = ins + nbytes_of(adj) + 2 * out + nbytes_of(xa, xb) + weights
    return (float(4 * m * FA * H + 4 * R * FB * H), float(2 * adds + R * H),
            float(nbytes))


def stack_cost(h0, edge_nbr, rev, w, p: int, edges: int,
               backward: bool) -> tuple[float, float, float]:
    """(product operations, other operations, bytes) of the conv stack on
    these inputs over the real
    edges: per layer the product t·W and the message adds; backward the
    replayed forward, then per layer dt = dpre·Wᵀ, dW = tᵀ·dpre and the
    adjoint's adds.  Bytes: every input read once, every output written
    once."""
    from cgr_mpnn_3d_tpu_torch.ops.segment import in_pack
    ET, H = h0.shape
    L = w.shape[0]
    adds = (int(in_pack(edge_nbr, p, ET)[1].sum())
            + int(in_pack(rev, p, ET)[1].sum())) * H
    prod = L * 2 * edges * H * H
    weights = L * (H * H + H + 1) * 4
    ins = nbytes_of(h0, edge_nbr, rev) + weights
    if not backward:
        return float(prod), float(L * adds), float(ins + nbytes_of(h0))
    nbytes = ins + nbytes_of(edge_nbr) + 2 * nbytes_of(h0) + weights
    return (float(3 * prod), float(2 * L * adds + L * edges * H),
            float(nbytes))


def hold(out: dict, name: str, got, want, relu: bool = False,
         exact=None) -> None:
    """A kernel's outputs against its plain version's: finite, each at
    REL_TOL (max |kernel - plain| / max |plain|) -- or, for gradients with
    ReLU, as one vector at most max(3 x the f32 plain version's, REL_TOL)
    away from the float64 evaluation ``exact()`` in relative L1 (the rule of
    train_kernels_vs_plain)."""
    import torch
    got = list(got) if isinstance(got, (tuple, list)) else [got]
    want = list(want) if isinstance(want, (tuple, list)) else [want]
    check(all(bool(torch.isfinite(g).all()) for g in got),
          f"{name} outputs are not finite")
    rels = [float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for g, w in zip(got, want)]
    entry = dict(abs_err=max(float((g - w).abs().max())
                             for g, w in zip(got, want)),
                 rel_err=max(rels))
    if relu and exact is not None:
        ex = exact()
        k64, p64 = l1(got, ex), l1(want, ex)
        entry.update(l1=l1(got, want), l1_64=(k64, p64))
        check(k64 <= max(3.0 * p64, REL_TOL),
              f"{name}: kernel vs float64 L1 {k64:.3e} > max(3 x the f32 "
              f"plain version's {p64:.3e}, {REL_TOL})")
    else:
        check(max(rels) <= REL_TOL, f"{name}: kernel vs plain relative error "
                                    f"{max(rels):.3e} > {REL_TOL}")
    out[name] = entry


def _f32(ts) -> list:
    return [t.float() if t.is_floating_point() else t for t in ts]


def hold_bf16(out: dict, name: str, got, want, want32, ctrl,
              grads: bool = False) -> None:
    """A bf16 kernel's outputs against its bf16 plain version's, by the rule
    of bf16_kernels_vs_plain: finite; values within rel-L2 BF16_TOL, or
    gradients at cosine >= BF16_COS; against the f32 plain version
    ``want32`` (on f32 copies of the same inputs) within tests/test_bf16.py's
    bounds (values rel-L2 < 1.5e-2; gradients cosine > 0.995 and rel-L2 <
    0.1); and the share: rel-L2 to the bf16 plain version at most
    BF16_SHARE of that to the f32 plain version, a hold the f32 kernel's
    result ``ctrl`` on the same inputs must fail."""
    import torch

    def listed(v):
        return list(v) if isinstance(v, (tuple, list)) else [v]
    got, want, want32, ctrl = (listed(v) for v in (got, want, want32, ctrl))
    check(all(bool(torch.isfinite(g).all()) for g in got),
          f"bf16 {name} outputs are not finite")
    near, far = rel_l2(got, want), rel_l2(got, want32)
    share = near / max(far, 1e-30)
    ctrl_share = rel_l2(ctrl, want) / max(rel_l2(ctrl, want32), 1e-30)
    entry = dict(abs_err=max(float((g.double() - w.double()).abs().max())
                             for g, w in zip(got, want)),
                 rel_l2=near, f32_rel_l2=far, share=share,
                 control_share=ctrl_share)
    check(share <= BF16_SHARE,
          f"bf16 {name}: rel-L2 to the bf16 plain version {near:.3e} is "
          f"{share:.3f} of that to the f32 plain version {far:.3e} (> "
          f"{BF16_SHARE})")
    check(ctrl_share > BF16_SHARE,
          f"bf16 {name}: the f32 kernel passes the bf16 hold (share "
          f"{ctrl_share:.3f} <= {BF16_SHARE})")
    if grads:
        entry.update(cos=cosine(got, want), f32_cos=cosine(got, want32))
        check(entry["cos"] >= BF16_COS and entry["f32_cos"] > 0.995
              and far < 0.1,
              f"bf16 {name}: gradient cosine {entry['cos']:.6f} vs bf16 "
              f"plain, {entry['f32_cos']:.6f} and rel-L2 {far:.3e} vs f32 "
              f"plain")
    else:
        check(near <= BF16_TOL and 0.0 < far < 1.5e-2,
              f"bf16 {name}: rel-L2 {near:.3e} vs bf16 plain (> {BF16_TOL}) "
              f"or {far:.3e} vs f32 plain")
    out[name] = entry


def held(out: dict, name: str, kern, plain, args, kw32: dict, kw: dict,
         grads: bool = False, relu: bool = False, args32=None):
    """kern(*args, **kw) against plain(*args, **kw) -> the kernel's result.
    ``kw`` names the run's mat_dtype.  f32: hold (gradients with ``relu``
    by its float64 rule).  bf16: hold_bf16, with the f32 kernel and plain
    version under ``kw32`` on ``args32`` (f32 copies of args by default;
    a backward whose ReLU reads the saved output needs the f32 forward's
    there) as the f32 plain version and the control.  With ``grads`` a
    second kernel run must equal the first bit for bit."""
    import torch
    got = kern(*args, **kw)
    if kw.get("mat_dtype") != BF16:
        hold(out, name, got, plain(*args, **kw), relu and grads,
             lambda: plain(*_f64(args), **kw))
    else:
        a32 = _f32(args) if args32 is None else args32
        hold_bf16(out, name, got, plain(*args, **kw), plain(*a32, **kw32),
                  kern(*a32, **kw32), grads)
    if grads:
        check(all(torch.equal(u, v) for u, v in zip(got, kern(*args, **kw))),
              f"two runs of {name} differ")
    return got


def layered_kernels(cfg_kw: dict, spec, batch, seed: int, repeats: int,
                    dtype: str = "float32") -> dict:
    """The layered kernels against their plain versions on the inputs a
    layered forward of this batch gives them (each stage fed the kernel's
    output of the stage before), with seeded weights and cotangents: K5
    edge_init, K4 in eval and (with the config's dropout) train mode, K5
    readout, K7 pooling, then K7 over the transposed pooling ELL, K7 with
    the sign row on the message arrays, and the backward kernels of K5 and
    K4.  f32: each output at REL_TOL, ReLU gradients by the float64 rule of
    hold.  ``dtype="bfloat16"``: the kernels' bf16 instantiation on the
    model's bf16 tensors (x, e, h0 and the stack's states), each held by
    hold_bf16 with the f32 kernel as control, and every backward rerun bit
    for bit.  With ``repeats``: times, bounds (products at the bf16 peak at
    bf16), and the library call of K7 (``embedding_bag``, on the bf16
    source at bf16)."""
    import torch
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNNConfig, init_params
    from cgr_mpnn_3d_tpu_torch.models.cgr_mpnn import ACTIVATIONS, _skips
    from cgr_mpnn_3d_tpu_torch.ops import conv_stack as cs
    from cgr_mpnn_3d_tpu_torch.ops import gather_linear as gl
    from cgr_mpnn_3d_tpu_torch.ops import onehot_spmm as sp
    from cgr_mpnn_3d_tpu_torch.ops.segment import ext_zero_row, in_pack
    cfg = CGRMPNNConfig(**cfg_kw)
    gen = torch.Generator().manual_seed(seed)
    b = batch
    dev = b.node_x.device
    model = init_params(cfg, gen, dev)
    p, act, mean = spec.p, ACTIVATIONS[cfg.activation], cfg.aggr == "mean"
    relu = act == "relu"
    bf16 = dtype == "bfloat16"
    sd = torch.bfloat16 if bf16 else torch.float32
    x, e = b.node_x.to(sd), b.edge_attr.to(sd)
    F, NT, ET = x.shape[1], x.shape[0], e.shape[0]
    E, N = int((b.senders < NT).sum()), int((b.graph_nodes < NT).sum())
    with torch.no_grad():
        if cfg.use_learnable_skip:
            for w in model.skip_weights:
                w.copy_(torch.rand((), generator=gen) * 2.0 - 0.5)
        wei, wen = model.edge_init, model.edge_to_node
        w_init = (wei.w[:F], wei.w[F:], wei.b)
        w_read = (wen.w[F:], wen.w[:F], wen.b)
        stack = (torch.stack([c.w for c in model.convs]),
                 torch.stack([c.b for c in model.convs]), _skips(model, dev))
    senders, receivers = b.senders[:, None], b.receivers[:, None]
    msg = (b.edge_nbr, b.rev)
    train = dict(train=True, seeds=[int(s) for s in torch.randint(
        0, 2**31 - 1, (cfg.depth,), generator=gen)],
        dropout_ps=cfg.dropout_ps)

    def rand(*shape, like=None):
        t = torch.randn(shape, generator=gen).to(dev)
        return t if like is None else t.to(like.dtype)

    # the keywords of each kernel in f32 and at this dtype (K5: with its
    # out_dtype)
    kw_i = dict(p=p, act=act)
    kw_s = dict(p=p, act=act, mean=mean)
    kw_r = dict(p=p, act=act, mean=mean)
    kw_p = dict(p=p)
    md = dict(mat_dtype=dtype)
    k_i, k_s, k_r, k_p = (dict(kw_i, **md, out_dtype=dtype), dict(kw_s, **md),
                          dict(kw_r, **md, out_dtype="float32"),
                          dict(kw_p, **md))

    out: dict = dict(p=p, graphs=int((b.graph_mask > 0).sum()))
    with torch.no_grad():
        fwd_init = (x, e, senders, *w_init)
        h0 = held(out, "K5 edge_init fwd", gl.gather_linear_forward,
                  gl.gather_linear_forward_ref, fwd_init, kw_i, k_i)
        h = held(out, "K4 fwd eval", cs.conv_stack_forward,
                 cs.conv_stack_forward_ref, (h0, *msg, *stack), kw_s, k_s)
        held(out, "K4 fwd train", cs.conv_stack_forward,
             cs.conv_stack_forward_ref, (h0, *msg, *stack),
             dict(kw_s, **train), dict(k_s, **train))
        fwd_read = (h, x, b.node_inc, *w_read)
        hn = held(out, "K5 readout fwd", gl.gather_linear_forward,
                  gl.gather_linear_forward_ref, fwd_read, kw_r, k_r)
        pooled = held(out, "K7 pool fwd", sp.onehot_spmm,
                      sp.onehot_spmm_ref, (hn, b.graph_nodes), kw_p, k_p)
        dpool = rand(*pooled.shape)
        held(out, "K7 pool bwd", sp.onehot_spmm, sp.onehot_spmm_ref,
             (dpool, b.graph_of_node[:, None]), kw_p, k_p)
        # an f32 source at bf16: a bf16 one is exact at both types
        g_h = rand(*h.shape)
        held(out, "K7 messages (sign)", sp.onehot_spmm, sp.onehot_spmm_ref,
             (g_h if bf16 else h, *msg), kw_p, k_p)

        g_hn, g_h0 = rand(*hn.shape), rand(*h0.shape, like=h0)
        g_h = g_h.to(h.dtype)

        def with_f32_out(args, fwd, kw):
            """A K5 backward's f32 arguments: the saved output, which the
            ReLU backward reads, from the f32 forward on the same inputs."""
            a32 = _f32(args)
            a32[-2] = gl.gather_linear_forward(*_f32(fwd), **kw)
            return a32
        bwd_read = (h, x, b.node_inc, receivers, *w_read, hn, g_hn)
        held(out, "K5 readout bwd", gl.gather_linear_backward,
             gl.gather_linear_backward_ref, bwd_read, kw_r, k_r, True, relu,
             with_f32_out(bwd_read, fwd_read, kw_r) if bf16 else None)
        bwd_stack = (h0, *msg, b.edge_nbr_rev, *stack, g_h)
        held(out, "K4 bwd train", cs.conv_stack_backward,
             cs.conv_stack_backward_ref, bwd_stack, dict(kw_s, **train),
             dict(k_s, **train), True, relu)
        bwd_init = (x, e, senders, b.node_out, *w_init, h0, g_h0)
        held(out, "K5 edge_init bwd", gl.gather_linear_backward,
             gl.gather_linear_backward_ref, bwd_init, kw_i, k_i, True, relu,
             with_f32_out(bwd_init, fwd_init, kw_i) if bf16 else None)
        torch.cuda.synchronize()
        if not repeats:
            return out
        size = 2 if bf16 else 4
        timed = {
            "K5 edge_init fwd": (gl.gather_linear_forward,
                                 gl.gather_linear_forward_ref, fwd_init, k_i,
                                 glin_cost(x, e, senders, w_init[0], p, E, N,
                                           out_size=size)),
            "K5 readout fwd": (gl.gather_linear_forward,
                               gl.gather_linear_forward_ref, fwd_read, k_r,
                               glin_cost(h, x, b.node_inc, w_read[0], p, N,
                                         E)),
            "K4 fwd eval": (cs.conv_stack_forward, cs.conv_stack_forward_ref,
                            (h0, *msg, *stack), k_s,
                            stack_cost(h0, *msg, stack[0], p, E, False)),
            "K7 pool fwd": (sp.onehot_spmm, sp.onehot_spmm_ref,
                            (hn, b.graph_nodes), k_p,
                            spmm_cost(hn, b.graph_nodes, None, p)),
            "K5 edge_init bwd": (gl.gather_linear_backward,
                                 gl.gather_linear_backward_ref, bwd_init, k_i,
                                 glin_cost(x, e, senders, w_init[0], p, E, N,
                                           b.node_out, size)),
            "K5 readout bwd": (gl.gather_linear_backward,
                               gl.gather_linear_backward_ref, bwd_read, k_r,
                               glin_cost(h, x, b.node_inc, w_read[0], p, N,
                                         E, receivers)),
            "K4 bwd train": (cs.conv_stack_backward,
                             cs.conv_stack_backward_ref, bwd_stack,
                             dict(k_s, **train),
                             stack_cost(h0, *msg, stack[0], p, E, True)),
        }
        for name, (kern, plain, args, kw, cost) in timed.items():
            _timed(out[name], lambda: kern(*args, **kw),
                   lambda: plain(*args, **kw), repeats, cost, bf16)
        # K7's library yardstick: one embedding_bag over the same sum, ids
        # outside the pack sent to an appended zero row; at bf16 on the
        # bf16 source (a bf16 sum)
        ids = in_pack(b.graph_nodes, p, NT)[0]
        ext = ext_zero_row(hn.to(sd))
        bag = torch.nn.functional.embedding_bag
        lib_out = bag(ids, ext, mode="sum")
        agree = (rel_l2([lib_out], [pooled]) <= BF16_TOL if bf16 else
                 float((lib_out - pooled).abs().max())
                 <= REL_TOL * max(float(pooled.abs().max()), 1e-30))
        check(agree, "embedding_bag disagrees with the pooling kernel")
        out["K7 pool fwd"]["library_ms"] = time_ms(
            lambda: bag(ids, ext, mode="sum"), repeats)
    return out


def print_layered(what: str, k: dict, card: str) -> None:
    for name, e in k.items():
        if not isinstance(e, dict) or "abs_err" not in e:
            continue
        if "share" in e:
            line = (f"bf16 {name} {what}: {k['graphs']} graphs in {k['p']} "
                    f"packs, max abs err {e['abs_err']:.3e}, rel-L2 vs bf16 "
                    f"plain {e['rel_l2']:.3e}, vs f32 plain "
                    f"{e['f32_rel_l2']:.3e}, share {e['share']:.4g} (limit "
                    f"{BF16_SHARE}; the f32 kernel's "
                    f"{e['control_share']:.4g})")
            if "cos" in e:
                line += (f", cosine vs bf16 plain {e['cos']:.8f}, vs f32 "
                         f"plain {e['f32_cos']:.8f}")
        else:
            line = (f"{name} {what}: {k['graphs']} graphs in {k['p']} packs, "
                    f"max abs err {e['abs_err']:.3e}, rel {e['rel_err']:.3e}")
        if "l1" in e:
            line += (f"; vector L1 vs plain {e['l1']:.3e}, vs float64: kernel "
                     f"{e['l1_64'][0]:.3e}, f32 plain {e['l1_64'][1]:.3e}")
        if "l1_layered_64" in e:
            line += f", layered {e['l1_layered_64']:.3e}"
        if "l1_k2_64" in e:
            line += f", K2 {e['l1_k2_64']:.3e}"
        if "ms" in e:
            line += (f"; kernel {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} "
                     f"ms, {'bf16' if 'share' in e else 'f32'} bound "
                     f"{e['bound_ms']:.4f} ms ({e['ops'] / 1e9:.3f} GFLOP, "
                     f"{e['bytes'] / 1e6:.3f} MB, {e['bound_by']}-bound)")
            if "library_ms" in e:
                line += f", embedding_bag {e['library_ms']:.4f} ms"
            line += f" [{card}]"
        print(line)


def layered_vs_whole(cfg_kw: dict, spec, batch, seed: int) -> dict:
    """One model, seeded weights, in both configurations on the card:
    predictions (eval) of the layered path against the whole-model kernel
    K3f at REL_TOL; then, in train mode under the same dropout seeds, the
    SSE against the training kernel K2's, and the layered gradients
    (autograd through the backward kernels) against K2's, each at REL_TOL
    -- for ReLU, by the rule of hold against the float64 evaluation of K2's
    plain version."""
    import dataclasses
    import torch
    from cgr_mpnn_3d_tpu_torch.models import (CGRMPNN, CGRMPNNConfig, apply,
                                              fused_train_value_and_grad,
                                              init_params, kernel_seeds)
    from cgr_mpnn_3d_tpu_torch.train import sse_loss
    cfg = CGRMPNNConfig(**cfg_kw)
    gen = torch.Generator().manual_seed(seed)
    dev = batch.node_x.device
    whole = init_params(cfg, gen, dev)
    layered = CGRMPNN(dataclasses.replace(cfg, fuse_whole_model=False)).to(dev)
    layered.load_state_dict(whole.state_dict())
    mask = batch.graph_mask > 0
    out = dict(p=spec.p, graphs=int(mask.sum()))
    with torch.no_grad():
        want, got = apply(whole, batch, spec), apply(layered, batch, spec)
    hold(out, "preds", got[mask], want[mask])
    seeds = kernel_seeds(cfg, gen)
    sse_w = fused_train_value_and_grad(whole, batch, spec, seeds)
    layered.zero_grad()
    sse_l = sse_loss(layered, batch, spec, train=True, seeds=seeds)
    sse_l.backward()
    torch.cuda.synchronize()
    hold(out, "sse", sse_l.detach(), sse_w)
    g_w = [w.grad for w in whole.parameters()]
    g_l = [w.grad for w in layered.parameters()]
    if cfg.activation != "ReLU":
        hold(out, "grads", g_l, g_w)
        return out
    # ReLU: the layered gradients against float64, next to the f32 plain
    # version's distance (and, for the record, K2's)
    ex = k2_plain_grads(whole, batch, spec, seeds, torch.float64)
    hold(out, "grads", g_l, k2_plain_grads(whole, batch, spec, seeds,
                                           torch.float32), True, lambda: ex)
    out["grads"]["l1_k2_64"] = l1(g_w, ex)
    return out


def k2_plain_grads(model, batch, spec, seeds, dtype) -> list:
    """The training kernel's plain version (``fused_model_train_ref``) on
    ``model``'s weights in ``dtype``, in train mode under ``seeds``: the
    gradients in the parameters' order and shapes."""
    import torch
    from cgr_mpnn_3d_tpu_torch.models import (CGRMPNN, adjoint_inputs,
                                              kernel_grads_to_params,
                                              kernel_inputs)
    from cgr_mpnn_3d_tpu_torch.models.cgr_mpnn import ACTIVATIONS
    from cgr_mpnn_3d_tpu_torch.ops import fused_model as fm
    cfg = model.cfg
    kw = dict(p=spec.p, act=ACTIVATIONS[cfg.activation], aggr=cfg.aggr,
              pooling=cfg.pooling, train=True, seeds=[int(s) for s in seeds],
              dropout_ps=cfg.dropout_ps)
    with torch.no_grad():
        args = [t.to(dtype) if t.is_floating_point() else t
                for t in kernel_inputs(model, batch)]
        g = fm.fused_model_train_ref(args, adjoint_inputs(batch),
                                     batch.labels.to(dtype),
                                     batch.graph_mask.to(dtype), **kw)[1]
    # the 11 kernel gradients in the parameters' order and shapes
    scratch = CGRMPNN(cfg).to(device=batch.node_x.device, dtype=dtype)
    kernel_grads_to_params(scratch, g)
    return [w.grad for w in scratch.parameters()]


def serve_layered(tmp: Path, seed: int, card: str,
                  dtype: str = "float32") -> dict:
    """Serving through train/evaluate.py::predict with the checkpoint of
    ``serve`` loaded into the layered configuration at ``dtype``: the demo
    set as one request and as 10 single-reaction requests, then the corpus;
    held to the CPU and to the whole-model path at the same dtype (f32:
    max |Δ| / max at REL_TOL; bf16: rel-L2 within 1e-2, the whole-model
    kernels rounding elsewhere), with the launch counts (at bf16 of the
    bf16 kernels, and none of the f32 ones) and, for both configurations,
    the rates."""
    import dataclasses
    import torch
    from cgr_mpnn_3d_tpu_torch.data import ChemDataset, PackedLoader, plan_spec
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNN
    from cgr_mpnn_3d_tpu_torch.ops import conv_stack as cs
    from cgr_mpnn_3d_tpu_torch.ops import fused_model as fm
    from cgr_mpnn_3d_tpu_torch.ops import gather_linear as gl
    from cgr_mpnn_3d_tpu_torch.ops import onehot_spmm as sp
    from cgr_mpnn_3d_tpu_torch.train import load_model, predict
    whole, cfg, _ = load_model(tmp / "CGR-MPNN-3D.npz", DEVICE)
    bf16 = dtype == "bfloat16"
    cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    whole.cfg = cfg
    layered = CGRMPNN(dataclasses.replace(cfg, fuse_whole_model=False))
    layered.load_state_dict(whole.state_dict())
    layered = layered.to(DEVICE).eval()
    on_cpu = CGRMPNN(layered.cfg)
    on_cpu.load_state_dict(whole.state_dict())

    def dataset(csv_path, npz_path):
        ds = ChemDataset(str(csv_path), data_npz_path=str(npz_path))
        ds.prefeaturize()
        return ds, plan_spec([ds.graph(i) for i in range(len(ds))])

    demo = dataset(ROOT / "examples" / "demo.csv", tmp / "demo.npz")
    singles = [dataset(tmp / f"request_{i}.csv", tmp / f"request_{i}.npz")
               for i in range(len(demo[0]))]
    corpus = dataset(ROOT / "tests" / "corpus_reactions.csv",
                     tmp / "corpus.npz")

    def request(model, ds_spec, device=DEVICE):
        t0 = time.perf_counter()
        pred = predict(model, *ds_spec, 64, device)
        if device != "cpu":
            torch.cuda.synchronize()
        return pred, time.perf_counter() - t0

    mods = (gl, cs, sp)

    def counts():
        pre = "bf16_" if bf16 else ""
        out = dict(K5=gl, K4=cs, K7=sp)
        out = {k: getattr(m, pre + "launches") for k, m in out.items()}
        out.update(K3f=fm.launches + fm.bf16_launches,
                   other=sum(getattr(m, ("" if bf16 else "bf16_")
                                     + "launches") for m in mods))
        return out

    def zero():
        for m in (*mods, fm):
            m.launches = m.bf16_launches = 0

    def n_batches(ds_spec):
        return len(PackedLoader(ds_spec[0], ds_spec[1], batch_size=64))

    def err(got, want):
        if bf16:
            return rel_l2([torch.from_numpy(got)], [torch.from_numpy(want)])
        return float(np.abs(got - want).max()) / max(
            float(np.abs(want).max()), 1e-30)

    tol = 1e-2 if bf16 else REL_TOL
    request(layered, demo)          # warm-up, outside the counted run
    # the main path: counts are zeroed just before it and read just after
    zero()
    batch_pred, batch_s = request(layered, demo)
    single = [request(layered, s) for s in singles]
    launches = counts()
    n = n_batches(demo) + sum(n_batches(s) for s in singles)
    check(launches == dict(K5=2 * n, K4=n, K7=n, K3f=0, other=0),
          f"layered {dtype} serving launches {launches} for {n} request "
          f"batches")
    cpu_pred, _ = request(on_cpu, demo, "cpu")
    whole_pred, _ = request(whole, demo)
    single_pred = np.concatenate([s[0] for s in single])
    errs = dict(cpu=err(batch_pred, cpu_pred),
                whole=err(batch_pred, whole_pred),
                single=err(single_pred, cpu_pred))
    check(np.isfinite(batch_pred).all() and max(errs.values()) <= tol,
          f"layered {dtype} serving predictions differ: {errs}")
    latency = statistics.median(s[1] for s in single) * 1e3
    whole_latency = statistics.median(request(whole, s)[1]
                                      for s in singles) * 1e3
    print(f"serve layered {dtype} demo: {len(batch_pred)} reactions, batch "
          f"request {batch_s * 1e3:.3f} ms, single-request latency median "
          f"{latency:.3f} ms over {len(single)} (whole-model "
          f"{whole_latency:.3f} ms), launches {launches} for {n} request "
          f"batches; {'rel-L2' if bf16 else 'rel err'} vs CPU "
          f"{errs['cpu']:.3e}, vs whole-model {errs['whole']:.3e}, single "
          f"{errs['single']:.3e} [{card}]")

    zero()
    runs = [request(layered, corpus) for _ in range(3)]
    corpus_launches = counts()
    whole_runs = [request(whole, corpus) for _ in range(3)]
    m = len(runs[0][0])
    corpus_err = err(runs[0][0], whole_runs[0][0])
    check(corpus_err <= tol, f"layered vs whole-model {dtype} corpus "
                             f"predictions differ by {corpus_err:.3e}")
    gps = m / statistics.median(r[1] for r in runs)
    whole_gps = m / statistics.median(r[1] for r in whole_runs)
    print(f"serve layered {dtype} corpus: {m} reactions per request via "
          f"predict(), launches per request "
          f"{dict((k, v // 3) for k, v in corpus_launches.items())}, median "
          f"{gps:.1f} graphs/s (whole-model {whole_gps:.1f}), "
          f"{'rel-L2' if bf16 else 'rel err'} vs whole-model "
          f"{corpus_err:.3e} [{card}]")
    return dict(launches=launches, latency_ms=latency, graphs_per_s=gps)


def train_layered(tmp: Path, seed: int, card: str, dtype: str = "float32",
                  f32_rates=None) -> dict:
    """RxnGraphTrainer with the README's model and flags in the layered
    configuration, 2 epochs on the corpus on the card and on the CPU, and
    the whole-model configuration on the card: per-epoch RMSE held at
    TRAIN_TOL; every step launches the backward kernels of K5 (twice), K4
    and K7 and no training kernel K2; steps/s of both configurations on
    batches already on the card, and where a layered step's time goes.
    At ``dtype="bfloat16"`` the same in the bf16 layered configuration,
    without the whole-model run: card vs CPU within BF16_TRAIN_TOL, every
    step launching the bf16 backward kernels and no f32 one, its steps/s
    beside the f32 run's ``f32_rates``."""
    import dataclasses
    import torch
    from cgr_mpnn_3d_tpu_torch.data import ChemDataset, plan_spec, to_device
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNNConfig
    from cgr_mpnn_3d_tpu_torch.ops import conv_stack as cs
    from cgr_mpnn_3d_tpu_torch.ops import fused_model as fm
    from cgr_mpnn_3d_tpu_torch.ops import gather_linear as gl
    from cgr_mpnn_3d_tpu_torch.ops import onehot_spmm as sp
    from cgr_mpnn_3d_tpu_torch.train import RxnGraphTrainer
    data = tmp / "datasets"
    ds = ChemDataset(str(data / "train.csv"),
                     data_npz_path=str(data / "train.npz"))
    ds.prefeaturize()
    bf16 = dtype == "bfloat16"
    cfg = CGRMPNNConfig(num_node_features=ds.num_node_features,
                        num_edge_features=ds.num_edge_features, depth=4,
                        hidden_sizes=(400,) * 4, dropout_ps=(0.1,) * 4,
                        fuse_whole_model=False, compute_dtype=dtype)
    spec = plan_spec([ds.graph(i) for i in range(len(ds))])
    pre = "bf16_" if bf16 else ""

    def trainer(fuse: bool, device: str, name: str):
        return RxnGraphTrainer(
            name=name, cfg=dataclasses.replace(cfg, fuse_whole_model=fuse),
            train_data=ds, val_data=ds, spec=spec, lr=1e-4,
            weight_decay=1e-5, gamma=0.9, num_epochs=2, batch_size=64,
            val_frequency=1, seed=seed, model_save_dir=str(tmp / name),
            device=device)

    def zero():
        for m in (gl, cs, sp):
            m.launches = m.bwd_launches = 0
            m.bf16_launches = m.bf16_bwd_launches = 0
        fm.launches = fm.train_launches = fm.vjp_launches = 0
        fm.bf16_launches = fm.bf16_train_launches = fm.bf16_vjp_launches = 0

    # the main path: counts are zeroed just before it and read just after
    zero()
    card_tr = trainer(False, DEVICE, f"layered_card_{dtype}")
    t0 = time.perf_counter()
    card_res = card_tr.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: (getattr(m, pre + "launches"),
                    getattr(m, pre + "bwd_launches"))
                for k, m in (("K5", gl), ("K4", cs), ("K7", sp))}
    launches.update(
        K2=fm.train_launches + fm.bf16_train_launches,
        K3b=fm.vjp_launches + fm.bf16_vjp_launches,
        K3f=fm.launches + fm.bf16_launches,
        other=sum(getattr(m, k) for m in (gl, cs, sp) for k in (
            ("launches", "bwd_launches") if bf16
            else ("bf16_launches", "bf16_bwd_launches"))))
    steps = card_res["steps"]
    check(steps > 0 and launches["K5"][1] == 2 * steps
          and launches["K4"][1] == steps and launches["K7"][1] == steps
          and launches["K2"] == launches["K3b"] == launches["K3f"] == 0
          and launches["other"] == 0,
          f"layered {dtype} training launches {launches} for {steps} steps")
    cpu_res = trainer(False, "cpu", f"layered_cpu_{dtype}").train()
    runs = (("cpu", cpu_res),) if bf16 else (
        ("cpu", cpu_res), ("whole", trainer(True, DEVICE,
                                            "whole_card").train()))
    rel = {}
    for other, res in runs:
        rel[other] = max(abs(a - b) / abs(b)
                         for key in ("train_losses", "val_losses")
                         for a, b in zip(card_res[key], res[key]))
    check(all(np.isfinite(card_res[k]).all() for k in ("train_losses",
                                                       "val_losses")),
          f"layered training losses are not finite: {card_res}")
    tol = BF16_TRAIN_TOL if bf16 else TRAIN_TOL
    check(max(rel.values()) <= tol,
          f"layered {dtype} card RMSE vs {rel} > {tol}")
    print(f"train layered {dtype}: 2 epochs, {steps} steps in {wall:.3f} s "
          f"wall, train RMSE {card_res['train_losses']}, val RMSE "
          f"{card_res['val_losses']}; launches (forward, backward) {launches};"
          f" max rel diff {rel} (limit {tol}) [{card}]")

    # steps/s on batches already on the card, both configurations (at bf16
    # the layered one, beside the f32 run's)
    batches = [to_device(b, DEVICE) for b in card_tr.train_loader]
    rates = {}
    configs = (("layered", card_tr),) if bf16 else (
        ("layered", card_tr), ("whole", trainer(True, DEVICE, "whole_rate")))
    for name, tr in configs:
        for b in batches:
            tr._train_step(b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            for b in batches:
                tr._train_step(b)
        torch.cuda.synchronize()
        rates[name] = 3 * len(batches) / (time.perf_counter() - t0)
    if bf16:
        print(f"train step layered bf16: {rates['layered']:.2f} steps/s "
              f"against f32 {f32_rates['layered']:.2f} "
              f"({rates['layered'] / f32_rates['layered']:.3f}x) over "
              f"{3 * len(batches)} steps of {len(batches)} corpus batches "
              f"already on the card (p = {card_tr.train_loader.spec.p}) "
              f"[{card}]")
    else:
        print(f"train step: layered {rates['layered']:.2f} steps/s, "
              f"whole-model {rates['whole']:.2f} steps/s over "
              f"{3 * len(batches)} steps of {len(batches)} corpus batches "
              f"already on the card (p = {card_tr.train_loader.spec.p}) "
              f"[{card}]")
    zero()
    wall_ms, dev_ms, top = device_busy(
        lambda: [card_tr._train_step(b) for b in batches], top=12)
    per_step = {name: (getattr(m, pre + "launches") / len(batches),
                       getattr(m, pre + "bwd_launches") / len(batches))
                for name, m in (("K5", gl), ("K4", cs), ("K7", sp))}
    check(per_step == dict(K5=(2, 2), K4=(1, 1), K7=(1, 1)),
          f"layered training step launches {per_step} (forward, backward)")
    print(f"profile layered {dtype} train epoch ({len(batches)} steps): wall "
          f"{wall_ms:.3f} ms, device busy {dev_ms:.3f} ms "
          f"({100 * dev_ms / wall_ms:.1f}%), launches per step (forward, "
          f"backward) {per_step}, device time by kernel {top} [{card}]")
    return dict(launches=launches, steps=steps, rates=rates, rel=rel)


def conv_cost(h, h0, edge_nbr, rev, w, p: int, edges: int, backward: bool,
              recompute: bool = False,
              out_size: int | None = None) -> tuple[float, float, float]:
    """(product operations, other operations, bytes) of one conv layer
    (K6) on these inputs over the real edges: the product t·W and the
    message adds; backward the recomputed messages (and, with
    ``recompute`` -- SiLU and GELU, not ReLU or linear -- the recomputed
    product), dt = dpre·Wᵀ, dW = tᵀ·dpre, the adjoint's adds, db, dskip
    and dh0.  Bytes: every input read once (backward: edge_nbr_rev, the
    output and its cotangent too), every output written once; the output
    and its cotangent at h0's element size, or ``out_size`` bytes."""
    from cgr_mpnn_3d_tpu_torch.ops.segment import in_pack
    ET, Hin = h.shape
    H = w.shape[1]
    adds = (int(in_pack(edge_nbr, p, ET)[1].sum())
            + int(in_pack(rev, p, ET)[1].sum())) * Hin
    prod = 2 * edges * Hin * H
    weights = (Hin * H + H + 1) * 4
    ins = nbytes_of(h, h0, edge_nbr, rev) + weights
    outb = h0.numel() * (out_size or h0.element_size())
    if not backward:
        return float(prod), float(adds), float(ins + outb)
    nbytes = (ins + nbytes_of(edge_nbr) + 2 * outb + nbytes_of(h, h0)
              + weights)
    return (float((prod if recompute else 0) + 2 * prod),
            float(2 * adds + 4 * edges * H), float(nbytes))


def fused_conv_kernels(cfg_kw: dict, spec, batch, seed: int, repeats: int,
                       dtype: str = "float32") -> dict:
    """The per-layer conv kernel K6 against its plain version on the inputs
    capture mode gives its second layer (h = the first layer's output, h0 =
    edge_init's), with seeded weights and cotangents: the forward in eval
    and train mode (the config's dropout of that layer), the backward in
    train mode -- each output at REL_TOL, with ReLU by the float64 rule of
    hold, or at ``dtype="bfloat16"`` (bf16 capture's inputs: h and h0c
    bf16) by hold_bf16 with the f32 kernel on f32 copies as control -- and
    a second backward run, which must equal the first bit for bit.  With
    ``repeats``: times of the eval forward and the backward, and their
    bounds (products at the bf16 peak at bf16)."""
    import torch
    from cgr_mpnn_3d_tpu_torch.models import (CGRMPNNConfig, apply,
                                              init_params)
    from cgr_mpnn_3d_tpu_torch.models.cgr_mpnn import ACTIVATIONS, _skips
    from cgr_mpnn_3d_tpu_torch.ops import fused_conv as fc
    cfg = CGRMPNNConfig(**dict(cfg_kw, compute_dtype=dtype))
    gen = torch.Generator().manual_seed(seed)
    b = batch
    dev = b.node_x.device
    model = init_params(cfg, gen, dev)
    p, act = spec.p, ACTIVATIONS[cfg.activation]
    relu = act == "relu"
    bf16 = dtype == "bfloat16"
    with torch.no_grad():
        if cfg.use_learnable_skip:
            for w in model.skip_weights:
                w.copy_(torch.rand((), generator=gen) * 2.0 - 0.5)
        _, acts = apply(model, b, spec, capture=True)
        ws = (model.convs[1].w.detach(), model.convs[1].b.detach(),
              _skips(model, dev)[1].detach())
    h_in = acts["h_0"]
    ins = (h_in, acts["h0"].to(h_in.dtype), b.edge_nbr, b.rev)
    bwd = (*ins, b.edge_nbr_rev, *ws)
    kw = dict(p=p, act=act, mean=cfg.aggr == "mean")
    train = dict(kw, train=True, dropout_p=cfg.dropout_ps[1],
                 seed=int(torch.randint(0, 2**31 - 1, (), generator=gen)))
    g = torch.randn(acts["h0"].shape, generator=gen).to(dev).to(h_in.dtype)
    E = int((b.senders < b.node_x.shape[0]).sum())
    out: dict = dict(p=p, graphs=int((b.graph_mask > 0).sum()))
    md = dict(mat_dtype=dtype)
    k_ev, k_tr = dict(kw, **md), dict(train, **md)
    with torch.no_grad():
        held(out, "K6 fwd eval", fc.fused_conv_forward,
             fc.fused_conv_layer_ref, (*ins, *ws), kw, k_ev)
        y = held(out, "K6 fwd train", fc.fused_conv_forward,
                 fc.fused_conv_layer_ref, (*ins, *ws), train, k_tr)
        args = (*bwd, y, g)
        args32 = ((*_f32(bwd), fc.fused_conv_forward(*_f32(ins), *ws, **train),
                   g.float()) if bf16 else None)
        held(out, "K6 bwd train", fc.fused_conv_backward,
             fc.fused_conv_backward_ref, args, train, k_tr, True, relu,
             args32)
        torch.cuda.synchronize()
        if repeats:
            _timed(out["K6 fwd eval"],
                   lambda: fc.fused_conv_forward(*ins, *ws, **k_ev),
                   lambda: fc.fused_conv_layer_ref(*ins, *ws, **k_ev),
                   repeats, conv_cost(ins[0], ins[1], b.edge_nbr, b.rev,
                                      ws[0], p, E, False), bf16)
            _timed(out["K6 bwd train"],
                   lambda: fc.fused_conv_backward(*args, **k_tr),
                   lambda: fc.fused_conv_backward_ref(*args, **k_tr),
                   repeats, conv_cost(ins[0], ins[1], b.edge_nbr, b.rev,
                                      ws[0], p, E, True, not relu), bf16)
    return out


def fused_conv_hin(spec, batch, seed: int, dtype: str = "float32") -> dict:
    """K6 with Hin = 24 != H = 40 (GELU, mean, dropout 0.2, skip 0.8) on
    seeded random inputs, forward and backward, each output at REL_TOL, or
    at ``dtype="bfloat16"`` (h and h0 bf16) by hold_bf16."""
    import torch
    from cgr_mpnn_3d_tpu_torch.ops import fused_conv as fc
    gen = torch.Generator().manual_seed(seed)
    b = batch
    dev = b.node_x.device
    ET = b.edge_nbr.shape[0]
    sd = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)
    ins = (rand(ET, 24).to(sd), rand(ET, 40).to(sd), b.edge_nbr, b.rev)
    ws = (rand(24, 40, scale=0.2), rand(40, scale=0.1),
          torch.tensor(0.8, device=dev))
    kw = dict(p=spec.p, act="gelu", mean=True, train=True, seed=12345,
              dropout_p=0.2)
    out: dict = dict(p=spec.p, graphs=int((b.graph_mask > 0).sum()))
    k = dict(kw, mat_dtype=dtype)
    with torch.no_grad():
        y = held(out, "K6 fwd Hin 24", fc.fused_conv_forward,
                 fc.fused_conv_layer_ref, (*ins, *ws), kw, k)
        g = rand(*y.shape).to(sd)
        i32 = _f32(ins)
        args32 = ((*i32, b.edge_nbr_rev, *ws,
                   fc.fused_conv_forward(*i32, *ws, **kw), g.float())
                  if dtype == BF16 else None)
        held(out, "K6 bwd Hin 24", fc.fused_conv_backward,
             fc.fused_conv_backward_ref, (*ins, b.edge_nbr_rev, *ws, y, g),
             kw, k, True, False, args32)
    return out


def capture_plain(model, batch, spec, **kw):
    """``apply(capture=True, **kw)`` with the plain versions of K7 and K6
    in place of their wrappers, on the batch's own device (the plain
    versions run on any device); no launch is counted."""
    from cgr_mpnn_3d_tpu_torch.models import apply
    from cgr_mpnn_3d_tpu_torch.models import cgr_mpnn as cm
    from cgr_mpnn_3d_tpu_torch.ops import fused_conv as fc
    from cgr_mpnn_3d_tpu_torch.ops import onehot_spmm as sp

    def spmm_ref(src, idx, idx_bwd, sign=None, sign_bwd=None, *, p,
                 mat_dtype="float32"):
        return sp.onehot_spmm_ref(src, idx, sign, p=p, mat_dtype=mat_dtype)

    def conv_ref(h, h0, edge_nbr, rev, edge_nbr_rev, w, b, skip, **kw):
        return fc.fused_conv_layer_ref(h, h0, edge_nbr, rev, w, b, skip, **kw)
    wrappers = cm.spmm, cm.fused_conv_layer
    cm.spmm, cm.fused_conv_layer = spmm_ref, conv_ref
    try:
        return apply(model, batch, spec, capture=True, **kw)
    finally:
        cm.spmm, cm.fused_conv_layer = wrappers


def _capture_bf16(cfg_kw: dict, spec, batch, seed: int, on_cpu: bool,
                  repeats: int) -> dict:
    """capture_vs_paths at bf16 (see there): capture on the card (the bf16
    K7 and K6) against capture through the bf16 plain versions on the card
    and, with ``on_cpu``, on the CPU -- every activation and the
    predictions, each on its own, then in train mode the parameter
    gradients -- each by hold_bf16, with the same model computing in f32 as the f32
    plain version (capture_plain) and the control (the f32 kernels).  The
    train-mode run is the main path: 3 bf16 K7 and depth bf16 K6 launches
    forward, 2 and depth backward, nothing else.  With ``repeats``: the
    forward's and the training step's ms at bf16 beside f32, and the
    card's time by kernel in one bf16 capture forward."""
    import dataclasses
    import torch
    from cgr_mpnn_3d_tpu_torch.models import (CGRMPNN, CGRMPNNConfig, apply,
                                              init_params, kernel_seeds)
    from cgr_mpnn_3d_tpu_torch.ops import conv_stack as cs
    from cgr_mpnn_3d_tpu_torch.ops import fused_conv as fc
    from cgr_mpnn_3d_tpu_torch.ops import fused_model as fm
    from cgr_mpnn_3d_tpu_torch.ops import gather_linear as gl
    from cgr_mpnn_3d_tpu_torch.ops import onehot_spmm as sp
    cfg = CGRMPNNConfig(**dict(cfg_kw, compute_dtype="bfloat16"))
    gen = torch.Generator().manual_seed(seed)
    dev = batch.node_x.device
    m16 = init_params(cfg, gen, dev)
    if cfg.use_learnable_skip:
        with torch.no_grad():
            for w in m16.skip_weights:
                w.copy_(torch.rand((), generator=gen) * 2.0 - 0.5)
    m32 = CGRMPNN(dataclasses.replace(cfg, compute_dtype="float32")).to(dev)
    m32.load_state_dict(m16.state_dict())
    mask = batch.graph_mask > 0
    out: dict = dict(p=spec.p, graphs=int(mask.sum()))

    def named(pred, acts) -> dict:
        """Every activation and the predictions, on the card."""
        return dict({k: v.to(dev) for k, v in acts.items()},
                    preds=pred.to(dev)[mask])

    def hold_each(what, got, want, want32, ctrl):
        for k in sorted(got):
            hold_bf16(out, f"capture {k} vs {what}", got[k], want[k],
                      want32[k], ctrl[k])
    with torch.no_grad():
        got = named(*apply(m16, batch, spec, capture=True))
        ctrl = named(*apply(m32, batch, spec, capture=True))
        hold_each("plain", got, named(*capture_plain(m16, batch, spec)),
                  named(*capture_plain(m32, batch, spec)), ctrl)
        if on_cpu:
            b_cpu = type(batch)(*(t.cpu() for t in batch))
            cpu = {}
            for md, m in (("bfloat16", m16), ("float32", m32)):
                c = CGRMPNN(m.cfg)
                c.load_state_dict(m.state_dict())
                cpu[md] = named(*apply(c, b_cpu, spec, capture=True))
            hold_each("CPU", got, cpu["bfloat16"], cpu["float32"], ctrl)

    seeds = kernel_seeds(cfg, gen)

    def step(model, plain=False):
        """The masked SSE's parameter gradients of one train-mode capture
        forward and backward, through the kernels or the plain versions."""
        model.zero_grad()
        pred, _ = (capture_plain(model, batch, spec, train=True, seeds=seeds)
                   if plain else apply(model, batch, spec, train=True,
                                       seeds=seeds, capture=True))
        err = (pred - batch.labels) * batch.graph_mask
        (err * err).sum().backward()
        return [w.grad.clone() for w in model.parameters()]

    # the main path: counts are zeroed just before it and read just after
    for m in (sp, fc, gl, cs):
        m.launches = m.bwd_launches = m.bf16_launches = m.bf16_bwd_launches = 0
    fm.launches = fm.train_launches = fm.vjp_launches = 0
    fm.bf16_launches = fm.bf16_train_launches = fm.bf16_vjp_launches = 0
    g16 = step(m16)
    torch.cuda.synchronize()
    launches = dict(K7=(sp.bf16_launches, sp.bf16_bwd_launches),
                    K6=(fc.bf16_launches, fc.bf16_bwd_launches),
                    f32=[(m.launches, m.bwd_launches) for m in (sp, fc)],
                    other=[gl.bf16_launches, gl.bf16_bwd_launches,
                           cs.bf16_launches, cs.bf16_bwd_launches,
                           gl.launches, cs.launches, fm.launches,
                           fm.train_launches, fm.vjp_launches,
                           fm.bf16_launches, fm.bf16_train_launches,
                           fm.bf16_vjp_launches])
    L = cfg.depth
    check(launches == dict(K7=(3, 2), K6=(L, L), f32=[(0, 0), (0, 0)],
                           other=[0] * 12),
          f"bf16 capture forward + backward launches {launches}")
    out["launches"] = dict(K7=launches["K7"], K6=launches["K6"])
    hold_bf16(out, "capture grads vs plain", g16, step(m16, True),
              step(m32, True), step(m32), True)
    if repeats:
        with torch.no_grad():
            out["fwd_ms"] = {
                md: time_ms(lambda: apply(m, batch, spec, capture=True),
                            repeats)
                for md, m in (("bf16", m16), ("f32", m32))}
            wall, busy, top = device_busy(
                lambda: apply(m16, batch, spec, capture=True), top=12)
        out["step_ms"] = {md: time_ms(lambda: step(m), repeats)
                          for md, m in (("bf16", m16), ("f32", m32))}
        out["profile"] = dict(wall_ms=wall, busy_ms=busy, top=top)
    return out


def capture_vs_paths(cfg_kw: dict, spec, batch, seed: int, on_cpu: bool,
                     repeats: int = 0, dtype: str = "float32") -> dict:
    """Capture mode (``apply(capture=True)``: K7 for x[senders], the
    incoming sum and the pooling, K6 per layer) on the card against the
    other paths, one model with seeded weights.  Eval: every activation
    and the predictions against capture through the plain versions on the
    card (capture_plain) and, with ``on_cpu``, against the CPU's capture;
    the predictions against the layered path's and K3f's.
    Train mode under the same dropout seeds: the SSE and the parameter
    gradients (autograd through K6's and K7's backward kernels) against the
    layered path's and K2's, at REL_TOL output by output -- for ReLU by the
    rule of hold against the float64 evaluation of K2's plain version.  The
    train-mode run is the main path of capture mode: the counts are zeroed
    just before it and read just after, and must show 3 K7 and depth K6
    launches forward, 2 K7 (node features take no gradient, so x[senders]
    has no backward) and depth K6 backward, and no other kernel.  With
    ``repeats``: the forward's time in the three paths (capture, layered,
    K3f), a training step's forward and backward in capture and layered
    mode, and the card's time by kernel in one capture forward.  At
    ``dtype="bfloat16"``: _capture_bf16."""
    if dtype == "bfloat16":
        return _capture_bf16(cfg_kw, spec, batch, seed, on_cpu, repeats)
    import dataclasses
    import torch
    from cgr_mpnn_3d_tpu_torch.models import (CGRMPNN, CGRMPNNConfig, apply,
                                              fused_train_value_and_grad,
                                              init_params, kernel_seeds)
    from cgr_mpnn_3d_tpu_torch.ops import conv_stack as cs
    from cgr_mpnn_3d_tpu_torch.ops import fused_conv as fc
    from cgr_mpnn_3d_tpu_torch.ops import fused_model as fm
    from cgr_mpnn_3d_tpu_torch.ops import gather_linear as gl
    from cgr_mpnn_3d_tpu_torch.ops import onehot_spmm as sp
    from cgr_mpnn_3d_tpu_torch.train import sse_loss
    cfg = CGRMPNNConfig(**cfg_kw)
    gen = torch.Generator().manual_seed(seed)
    dev = batch.node_x.device
    whole = init_params(cfg, gen, dev)
    if cfg.use_learnable_skip:
        with torch.no_grad():
            for w in whole.skip_weights:
                w.copy_(torch.rand((), generator=gen) * 2.0 - 0.5)
    layered = CGRMPNN(dataclasses.replace(cfg, fuse_whole_model=False)).to(dev)
    layered.load_state_dict(whole.state_dict())
    mask = batch.graph_mask > 0
    out: dict = dict(p=spec.p, graphs=int(mask.sum()))
    with torch.no_grad():
        got, acts = apply(whole, batch, spec, capture=True)
        want, acts_plain = capture_plain(whole, batch, spec)
        keys = sorted(acts_plain)
        check(sorted(acts) == keys, f"capture keys {sorted(acts)}")
        hold(out, "capture acts vs plain", [acts[k] for k in keys],
             [acts_plain[k] for k in keys])
        hold(out, "capture preds vs plain", got[mask], want[mask])
        del acts_plain
        hold(out, "capture preds vs K3f", got[mask],
             apply(whole, batch, spec)[mask])
        hold(out, "capture preds vs layered", got[mask],
             apply(layered, batch, spec)[mask])
        if on_cpu:
            cpu = CGRMPNN(cfg)
            cpu.load_state_dict(whole.state_dict())
            b_cpu = type(batch)(*(t.cpu() for t in batch))
            want, acts_cpu = apply(cpu, b_cpu, spec, capture=True)
            hold(out, "capture acts vs CPU", [acts[k] for k in keys],
                 [acts_cpu[k].to(dev) for k in keys])
            hold(out, "capture preds vs CPU", got[mask],
                 want.to(dev)[mask])

    seeds = kernel_seeds(cfg, gen)
    labels, gmask = batch.labels, batch.graph_mask
    whole.zero_grad()
    # the main path: counts are zeroed just before it and read just after
    for m in (sp, fc, gl, cs):
        m.launches = m.bwd_launches = 0
    fm.launches = fm.train_launches = fm.vjp_launches = 0
    pred, _ = apply(whole, batch, spec, train=True, seeds=seeds, capture=True)
    err = (pred - labels) * gmask
    sse_c = (err * err).sum()
    sse_c.backward()
    torch.cuda.synchronize()
    launches = dict(K7=(sp.launches, sp.bwd_launches),
                    K6=(fc.launches, fc.bwd_launches),
                    K5=(gl.launches, gl.bwd_launches),
                    K4=(cs.launches, cs.bwd_launches),
                    K3f=fm.launches, K3b=fm.vjp_launches, K2=fm.train_launches)
    L = cfg.depth
    check(launches == dict(K7=(3, 2), K6=(L, L), K5=(0, 0), K4=(0, 0),
                           K3f=0, K3b=0, K2=0),
          f"capture forward + backward launches {launches}")
    out["launches"] = launches
    g_c = [w.grad.clone() for w in whole.parameters()]
    layered.zero_grad()
    sse_l = sse_loss(layered, batch, spec, train=True, seeds=seeds)
    sse_l.backward()
    g_l = [w.grad for w in layered.parameters()]
    sse_w = fused_train_value_and_grad(whole, batch, spec, seeds)
    g_w = [w.grad for w in whole.parameters()]
    torch.cuda.synchronize()
    hold(out, "capture sse vs layered", sse_c.detach(), sse_l.detach())
    hold(out, "capture sse vs K2", sse_c.detach(), sse_w)
    if cfg.activation != "ReLU":
        hold(out, "capture grads vs layered", g_c, g_l)
        hold(out, "capture grads vs K2", g_c, g_w)
        return out
    ex = k2_plain_grads(whole, batch, spec, seeds, torch.float64)
    hold(out, "capture grads", g_c, k2_plain_grads(whole, batch, spec, seeds,
                                                   torch.float32),
         True, lambda: ex)
    out["capture grads"].update(l1_layered_64=l1(g_l, ex),
                                l1_k2_64=l1(g_w, ex))
    if repeats:
        _capture_times(out, whole, layered, batch, spec, seeds, repeats)
    return out


def _capture_times(out: dict, whole, layered, batch, spec, seeds,
                   repeats: int) -> None:
    """Forward ms of capture, layered and K3f; fwd + bwd ms of a capture and
    a layered training step (autograd); device time by kernel of one
    capture forward (torch.profiler)."""
    import torch
    from cgr_mpnn_3d_tpu_torch.models import apply

    def step(model, capture):
        model.zero_grad(set_to_none=True)
        pred = apply(model, batch, spec, train=True, seeds=seeds,
                     capture=capture)
        pred = pred[0] if capture else pred
        err = (pred - batch.labels) * batch.graph_mask
        (err * err).sum().backward()
    with torch.no_grad():
        fwd = {"capture": lambda: apply(whole, batch, spec, capture=True),
               "layered": lambda: apply(layered, batch, spec),
               "K3f": lambda: apply(whole, batch, spec)}
        out["fwd_ms"] = {k: time_ms(f, repeats) for k, f in fwd.items()}
        wall, busy, top = device_busy(fwd["capture"], top=12)
    out["step_ms"] = {"capture": time_ms(lambda: step(whole, True), repeats),
                      "layered": time_ms(lambda: step(layered, False),
                                         repeats)}
    out["profile"] = dict(wall_ms=wall, busy_ms=busy, top=top)


def print_capture(what: str, k: dict, card: str) -> None:
    print_layered(what, k, card)
    if "launches" in k:
        print(f"capture launches {what}: one forward + backward (forward, "
              f"backward) {k['launches']} [{card}]")
    if "fwd_ms" in k:
        pr = k["profile"]
        print(f"capture times {what}: forward ms {k['fwd_ms']}, training step"
              f" (forward + backward) ms {k['step_ms']}; one capture forward "
              f"under torch.profiler: wall {pr['wall_ms']:.3f} ms, device busy"
              f" {pr['busy_ms']:.3f} ms, device time by kernel {pr['top']} "
              f"[{card}]")


def goldens_on_card(card: str) -> None:
    """The eight cases of tests/goldens/reference_gnn.npz (the original
    model's activations on fixed inputs and weights) through capture mode
    on the card: h0, every h_l, s, h_node, pooled and the predictions at
    rtol = atol = 1e-4, the bounds of tests/test_reference_goldens.py.  The
    graphs are rebuilt with the port's GraphArrays and packed into one
    pack."""
    import torch
    from cgr_mpnn_3d_tpu_torch.chem.featurize import GraphArrays
    from cgr_mpnn_3d_tpu_torch.data import PackSpec, pack_graphs, to_device
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNN, CGRMPNNConfig, apply
    from cgr_mpnn_3d_tpu_torch.ops import fused_conv as fc
    acts_of = {"relu": "ReLU", "gelu": "GELU", "silu": "SiLU"}
    worst = {}
    with np.load(ROOT / "tests" / "goldens" / "reference_gnn.npz",
                 allow_pickle=True) as z:
        cases = sorted({k.split("/")[0] for k in z.files})
        check(len(cases) == 8, f"goldens cases {cases}")
        for case in cases:
            depth, hidden, skip = (int(v) for v in z[f"{case}/meta"])
            mstr = [str(v) for v in z[f"{case}/meta_str"]]
            x, e = z[f"{case}/in/x"], z[f"{case}/in/edge_attr"]
            snd, rcv = z[f"{case}/in/senders"], z[f"{case}/in/receivers"]
            graphs, noff, eoff = [], 0, 0
            for nn, ne in zip(z[f"{case}/in/n_nodes"],
                              z[f"{case}/in/n_edges"]):
                nn, ne = int(nn), int(ne)
                graphs.append(GraphArrays(
                    node_feats=x[noff:noff + nn],
                    edge_feats=e[eoff:eoff + ne],
                    senders=(snd[eoff:eoff + ne] - noff).astype(np.int32),
                    receivers=(rcv[eoff:eoff + ne] - noff).astype(np.int32),
                    rev_edge_index=np.arange(ne, dtype=np.int32) ^ 1))
                noff, eoff = noff + nn, eoff + ne
            cfg = CGRMPNNConfig(
                num_node_features=x.shape[1], num_edge_features=e.shape[1],
                depth=depth, hidden_sizes=(hidden,) * depth,
                dropout_ps=(0.0,) * depth,
                activation=acts_of[mstr[0].lower()], aggr=mstr[1],
                pooling=mstr[2] if len(mstr) > 2 else "add",
                use_learnable_skip=bool(skip))
            model = CGRMPNN(cfg)
            state = model.state_dict()
            model.load_state_dict({n: torch.as_tensor(np.asarray(
                z[f"{case}/param/{n}"], np.float32)).reshape(t.shape)
                for n, t in state.items()})
            model = model.to(DEVICE)
            E, N, B = eoff, noff, len(graphs)
            spec = PackSpec(te=E + 2, tn=N + 2, tb=B + 1,
                            d=max(int(np.bincount(g.receivers).max())
                                  for g in graphs if g.num_edges) + 1,
                            dn=max(g.num_nodes for g in graphs), p=1)
            batch = to_device(pack_graphs(graphs, [0.0] * B, spec), DEVICE)
            before = fc.launches
            with torch.no_grad():
                out, acts = apply(model, batch, spec, capture=True)
            check(fc.launches == before + depth,
                  f"{case}: capture made {fc.launches - before} K6 launches")
            acts["preds"] = out
            rows = dict(h0=E, s=N, h_node=N, pooled=B, preds=B,
                        **{f"h_{l}": E for l in range(depth)})
            errs = []
            for key, n in rows.items():
                got = acts[key][:n].cpu().numpy()
                gold = z[f"{case}/act/{key}"]
                check(np.allclose(got, gold, rtol=1e-4, atol=1e-4),
                      f"{case} {key}: capture on the card vs the reference "
                      f"max abs err {np.abs(got - gold).max():.3e}")
                errs.append(float(np.abs(got - gold).max()))
            worst[case] = max(errs)
    print(f"goldens on the card: {len(worst)} cases through capture mode, "
          f"every activation within rtol = atol = 1e-4; max abs err per "
          f"case {json.dumps(worst)} [{card}]")


def bench_ops_phase(card: str, seed: int) -> dict:
    """``cli/bench_ops.py`` at its defaults (2 repeats), its lines tagged
    with the card; every time finite and positive, and the bf16 K6, K7,
    K3f and K3b counts risen (the rows' dtypes are the JAX module's), no
    f32 K6 or K7 one.  Then every kernel it timed, held once against its
    plain version on its batch (te = 512): K6 forward and backward on its
    bf16 conv inputs and K7 with the rev sign on its bf16 h by hold_bf16
    (the control: the f32 kernels on f32 copies; K7's bf16 source is exact
    at both types, so its share is taken on an f32 source of the same
    shape), and K3f, K2 and K3b (kernel_vs_plain, train_kernels_vs_plain)
    with the benchmark model's config and seeded weights, in f32 and
    (bf16_kernels_vs_plain, the model rows' dtype) in bf16."""
    import contextlib
    import io
    import torch
    from cgr_mpnn_3d_tpu_torch.cli import bench_ops
    from cgr_mpnn_3d_tpu_torch.ops import fused_conv as fc
    from cgr_mpnn_3d_tpu_torch.ops import fused_model as fm
    from cgr_mpnn_3d_tpu_torch.ops import onehot_spmm as sp
    for m in (fc, sp):
        m.launches = m.bwd_launches = m.bf16_launches = m.bf16_bwd_launches = 0
    fm.bf16_launches = fm.bf16_vjp_launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = bench_ops.main([], repeats=2)
    wall = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        print(f"bench_ops {line} [{card}]")
    check(all(np.isfinite(t) and t > 0 for t, _ in res.values()),
          f"bench_ops times {res}")
    check(fc.bf16_launches > 0 and fc.bf16_bwd_launches > 0
          and sp.bf16_launches > 0
          and fc.launches == fc.bwd_launches == sp.launches == 0,
          f"bench_ops launches: bf16 K6 {fc.bf16_launches} + "
          f"{fc.bf16_bwd_launches}, bf16 K7 {sp.bf16_launches}; f32 K6 "
          f"{fc.launches}, K7 {sp.launches}")
    check(fm.bf16_launches > 0 and fm.bf16_vjp_launches > 0,
          f"bench_ops' bf16 model rows launched bf16 K3f "
          f"{fm.bf16_launches}, K3b {fm.bf16_vjp_launches} times")
    print(f"bench_ops: {len(res)} lines in {wall:.3f} s; launches bf16 K6 "
          f"{fc.bf16_launches} forward + {fc.bf16_bwd_launches} backward, "
          f"bf16 K7 {sp.bf16_launches}")

    args = bench_ops.parser().parse_args([])
    dev = torch.device(DEVICE)
    spec, batch, _ = bench_ops.bench_batch(args.graphs, dev)
    (h, h0), ws = bench_ops.conv_inputs(spec, args.hidden, dev)
    ins = (h, h0, batch.edge_nbr, batch.rev)
    bwd = (*ins, batch.edge_nbr_rev, *ws)
    g = torch.randn(h0.shape, generator=torch.Generator().manual_seed(seed)
                    ).to(dev)
    p = spec.p
    kw, k16 = dict(p=p), dict(p=p, mat_dtype=BF16)
    g = g.to(h.dtype)
    results: dict = {}
    with torch.no_grad():
        y = held(results, "K6 fwd", fc.fused_conv_forward,
                 fc.fused_conv_layer_ref, (*ins, *ws), kw, k16)
        args32 = (*_f32(bwd), fc.fused_conv_forward(*_f32(ins), *ws, **kw),
                  g.float())
        held(results, "K6 bwd", fc.fused_conv_backward,
             fc.fused_conv_backward_ref, (*bwd, y, g), kw, k16, True, True,
             args32)
        msg = (batch.edge_nbr, batch.rev)
        check(rel_l2([sp.onehot_spmm(h, *msg, **k16)],
                     [sp.onehot_spmm_ref(h, *msg, **k16)]) <= BF16_TOL,
              "bf16 K7 messages on bench_ops' bf16 h")
        src = torch.randn(h.shape, generator=torch.Generator().manual_seed(
            seed)).to(dev)
        held(results, "K7 messages", sp.onehot_spmm, sp.onehot_spmm_ref,
             (src, *msg), kw, k16)
    del h, h0, ins, bwd, g, y, args32, src
    kw = bench_ops.model_kw(args.hidden)
    results["K3f"] = kernel_vs_plain(kw, spec, batch, seed, 0)
    train = train_kernels_vs_plain(kw, spec, batch, seed, 0)
    results.update(K2=train["train"], K3b=train["vjp"])
    bf16 = bf16_kernels_vs_plain(kw, spec, batch, seed, 0)
    results.update({f"{k} bf16": bf16[n] for k, n in
                    (("K3f", "fwd"), ("K2", "train"), ("K3b", "vjp"))})
    errs = {k: {e: v[e] for e in ("rel_err", "l1_64", "rel_l2", "cos",
                                  "share", "control_share")
                if e in v}
            for k, v in results.items()}
    print(f"bench_ops batch ({p} packs of te = {spec.te}): every timed "
          f"kernel against its plain version {json.dumps(errs)} [{card}]")
    return res


def act_chain_phase(cfg_kw: dict, spec, batch, seed: int, card: str) -> dict:
    """P1: the probe at its defaults (its JSON line), given the layered
    training step on ``batch`` (``spec``, ``cfg_kw``) to predict for; then
    the chain kernel against its plain version on the probe's own [N, H]
    input for each function at k = 1 and k = 4 (REL_TOL); the kernel's
    k = 1 time beside the plain version's and the bytes bound; then that
    training step (forward and backward) with ReLU and with GELU, timed,
    and the measured increase beside the probe's prediction."""
    import torch
    from cgr_mpnn_3d_tpu_torch.models import (CGRMPNNConfig, init_params,
                                              kernel_seeds)
    from cgr_mpnn_3d_tpu_torch.ops import act_chain as ac
    from cgr_mpnn_3d_tpu_torch.tools import gelu_roofline
    from cgr_mpnn_3d_tpu_torch.train import sse_loss
    dev = batch.node_x.device
    # the main path: the probe; counts zeroed just before, read just after
    ac.launches = 0
    probe = gelu_roofline.main([], step=(spec, CGRMPNNConfig(**cfg_kw)))
    launches = ac.launches
    check(launches > 0, "the probe made no chain-kernel launches")
    N, H = probe["n"], probe["h"]
    # the probe's own input (gelu_roofline.main's x0)
    x0 = torch.randn((N, H), generator=torch.Generator().manual_seed(0)).to(
        dev)
    abs_err = 0.0
    for fn in ac.FNS:
        for k in (1, 4):
            got, want = ac.act_chain(x0, fn, k), ac.act_chain_ref(x0, fn, k)
            err, rel = rel_err(got, want, slice(None))
            check(rel <= REL_TOL, f"act_chain {fn} k={k}: rel err {rel:.3e}")
            abs_err = max(abs_err, err)
            del got, want
    plain_ms = time_ms(lambda: ac.act_chain_ref(x0, "gelu", 1), 5)
    del x0
    nbytes = 2 * N * H * 4
    entry = dict(abs_err=abs_err, ms=probe["k1_ms"]["gelu"],
                 plain_ms=plain_ms, bound_ms=nbytes / PEAK_BYTES * 1e3,
                 bound_by="bytes")
    print(f"act_chain: kernel vs plain max abs err {abs_err:.3e} over "
          f"{len(ac.FNS)} functions at k = 1, 4 on the probe's [{N}, {H}] "
          f"input; gelu at k = 1 kernel {entry['ms']:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {entry['bound_ms']:.4f} ms "
          f"({nbytes / 1e6:.3f} MB, bytes-bound); probe launches {launches} "
          f"[{card}]")

    step_ms = {}
    for act in ("ReLU", "GELU"):
        cfg = CGRMPNNConfig(**dict(cfg_kw, activation=act,
                                   fuse_whole_model=False))
        model = init_params(cfg, torch.Generator().manual_seed(seed), dev)
        seeds = kernel_seeds(cfg, torch.Generator().manual_seed(seed))

        def step():
            model.zero_grad(set_to_none=True)
            sse_loss(model, batch, spec, train=True, seeds=seeds).backward()
        step_ms[act] = time_ms(step, 3)
    delta = step_ms["GELU"] - step_ms["ReLU"]
    print(f"layered training step (forward + backward) on {spec.p} packs: "
          f"ReLU {step_ms['ReLU']:.4f} ms, GELU {step_ms['GELU']:.4f} ms; "
          f"GELU - ReLU measured {delta:.4f} ms, predicted by the probe "
          f"{probe['pred_gelu_step_ms']:.4f} ms [{card}]")
    return dict(entry=entry, launches=launches, probe=probe,
                step_ms=step_ms)


def ptxas_lines(name: str) -> list[str]:
    """(kernel, registers / shared memory) lines of ptxas -v for the library
    ``name`` from this run's build, one per entry function."""
    from cgr_mpnn_3d_tpu_torch.ops import _build
    out, fn = [], None
    for line in _build.build_logs.get(name, "").splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "registers" in line and fn is not None:
            out.append(f"{fn}: {line.split(':', 1)[1].strip()}")
            fn = None
    return out


def mm_probe_phase(seed: int, card: str) -> dict:
    """P2: the probe at its defaults (``tools/int8_microbench.py``: cuBLAS
    and cuBLASLt, then P2, in bf16 and int8 at N = 4096), its kernel and
    int8 transpose launches counted; then P2 against its plain version on
    seeded random inputs at the probe's N (bf16 normal, int8 in [-3, 3]
    and over the full [-128, 127], where the sums wrap): int8 exactly,
    bf16 within rel-L2 4e-3; the int8 transpose alone against ``b.t()``;
    the plain versions' times, the bounds 2N³ over the bf16 and int8
    tensor-core peaks (the transpose: 2N² bytes over PEAK_BYTES), each
    kernel's share of its bound and of the library call, and the kernels'
    registers and static shared memory from ptxas."""
    import torch
    from cgr_mpnn_3d_tpu_torch.ops import mm_probe as mp
    from cgr_mpnn_3d_tpu_torch.tools import int8_microbench
    # the main path: the probe; counts zeroed just before, read just after
    mp.launches = mp.transpose_launches = 0
    res = int8_microbench.main([])
    launches, t_launches = mp.launches, mp.transpose_launches
    check(launches > 0 and t_launches > 0,
          f"the probe made {launches} P2 and {t_launches} transpose launches")
    check(all(np.isfinite(v) and v > 0 for v in res["tops"].values()),
          f"probe rates {res['tops']}")
    N = res["n"]
    gen = torch.Generator().manual_seed(seed)
    dev = torch.device(DEVICE)
    a16 = torch.randn((N, N), generator=gen).bfloat16().to(dev)
    b16 = torch.randn((N, N), generator=gen).bfloat16().to(dev)
    a8 = torch.randint(-3, 4, (N, N), generator=gen, dtype=torch.int8).to(dev)
    b8 = torch.randint(-3, 4, (N, N), generator=gen, dtype=torch.int8).to(dev)
    got16, want16 = mp.mm_probe(a16, b16), mp.mm_probe_ref(a16, b16)
    got8, want8 = mp.mm_probe(a8, b8), mp.mm_probe_ref(a8, b8)
    torch.cuda.synchronize()
    check(torch.equal(got8, want8), "P2 int8 differs from its plain version")
    err16 = rel_l2([got16], [want16])
    check(err16 <= 4e-3, f"P2 bf16 vs plain rel-L2 {err16:.3e} > 4e-3")
    a8f = torch.randint(-128, 128, (N, N), generator=gen,
                        dtype=torch.int8).to(dev)
    b8f = torch.randint(-128, 128, (N, N), generator=gen,
                        dtype=torch.int8).to(dev)
    check(torch.equal(mp.mm_probe(a8f, b8f), mp.mm_probe_ref(a8f, b8f)),
          "P2 int8 over [-128, 127] differs from its plain version")
    check(torch.equal(mp.transpose_s8(b8f), mp.transpose_s8_ref(b8f)),
          "P2's int8 transpose differs from b.t()")
    del a8f
    plain16 = time_ms(lambda: mp.mm_probe_ref(a16, b16), 5)
    plain8 = time_ms(lambda: mp.mm_probe_ref(a8, b8), 3)
    ops = 2.0 * N ** 3
    entry = dict(abs_err=float((got16.float() - want16.float()).abs().max()),
                 ms=res["ms"]["P2 bf16->f32"], plain_ms=plain16,
                 bound_ms=ops / PEAK_BF16_FLOPS * 1e3, bound_by="operations",
                 library_ms=res["ms"]["cuBLAS bf16->f32"])
    int8 = dict(ms=res["ms"]["P2 int8->int32"], plain_ms=plain8,
                bound_ms=ops / PEAK_INT8_OPS * 1e3,
                library_ms=res["ms"]["cuBLASLt int8->int32"])
    # the transpose alone (part of every int8 call above); its plain
    # version and the library call are the same torch call, timed apart
    t_plain = [time_ms(lambda: mp.transpose_s8_ref(b8f), 32)]
    t_ms = [time_ms(lambda: mp.transpose_s8(b8f), 32) for _ in range(2)]
    t_plain.append(time_ms(lambda: mp.transpose_s8_ref(b8f), 32))
    trans = dict(abs_err=0.0, ms=statistics.mean(t_ms),
                 plain_ms=statistics.mean(t_plain),
                 bound_ms=2.0 * N * N / PEAK_BYTES * 1e3, bound_by="bytes",
                 library_ms=time_ms(lambda: b8f.t().contiguous(), 32))
    print(f"mm_probe bf16 N = {N}: rel-L2 vs plain {err16:.3e}, max abs err "
          f"{entry['abs_err']:.3e}; kernel {entry['ms']:.4f} ms "
          f"({res['tops']['P2 bf16->f32']:.1f} TFLOP/s, "
          f"{entry['bound_ms'] / entry['ms']:.3f} of the bound, "
          f"{entry['library_ms'] / entry['ms']:.3f} of cuBLAS's rate), plain "
          f"{plain16:.4f} ms, cuBLAS {entry['library_ms']:.4f} ms "
          f"({res['tops']['cuBLAS bf16->f32']:.1f} TFLOP/s), bound "
          f"{entry['bound_ms']:.4f} ms [{card}]")
    print(f"mm_probe int8 N = {N}: equal to plain at [-3, 3] and [-128, "
          f"127]; kernel with its transpose {int8['ms']:.4f} ms "
          f"({res['tops']['P2 int8->int32']:.1f} TOP/s, "
          f"{int8['bound_ms'] / int8['ms']:.3f} of the bound, "
          f"{int8['library_ms'] / int8['ms']:.3f} of cuBLASLt's rate), plain "
          f"{plain8:.4f} ms, cuBLASLt {int8['library_ms']:.4f} ms "
          f"({res['tops']['cuBLASLt int8->int32']:.1f} TOP/s, B column-major "
          f"made outside its timed loop), bound {int8['bound_ms']:.4f} ms; "
          f"probe launches {launches} [{card}]")
    print(f"mm_probe int8 transpose N = {N}: equal to b.t(); kernel "
          f"{trans['ms']:.4f} ms, plain {trans['plain_ms']:.4f} ms, "
          f"b.t().contiguous() {trans['library_ms']:.4f} ms, bound "
          f"{trans['bound_ms']:.4f} ms by bytes; launches in the probe "
          f"{t_launches} [{card}]")
    for line in ptxas_lines("mm_probe") or ["(no ptxas log: built before "
                                            "this run)"]:
        print(f"mm_probe ptxas: {line}")
    return dict(entry=entry, int8=int8, launches=launches, probe=res,
                transpose=trans, transpose_launches=t_launches)


# -- edge partitioning: K8/K9, K10/K11 and the EP paths ---------------------

EP_CHAIN = 9600    # atoms of the full-width wired batch's chain (cut at 2, 4)
EP_GRAPHS = 200    # synthetic graphs beside it


class GraphSet:
    """A ChemDataset stand-in over graphs in memory (what the EP loader
    reads of a dataset)."""

    def __init__(self, graphs, labels, F: int, Fe: int = 14):
        self.graphs, self.labels = graphs, np.asarray(labels, np.float32)
        self.use_npz = False
        self.num_node_features, self.num_edge_features = F, Fe

    def __len__(self):
        return len(self.graphs)

    def graph(self, i):
        return self.graphs[i]


def ep_graphs(seed: int, n_graphs: int, chains, F: int = 270):
    """Seeded synthetic graphs plus path graphs of ``chains`` atoms, and
    normal labels."""
    from cgr_mpnn_3d_tpu_torch.data.synthetic import (chain_graph,
                                                      synthetic_graphs)
    rng = np.random.default_rng(seed)
    graphs = synthetic_graphs(n_graphs, rng, node_feat_dim=F) + [
        chain_graph(n, rng, F) for n in chains]
    return graphs, rng.standard_normal(len(graphs)).astype(np.float32)


# the launch counters of the EP paths, by kernel: (module, forward counter,
# backward counter); "bf16 " names the bf16 instantiation's
EP_COUNTERS = {
    "K5": ("gl", "launches", "bwd_launches"),
    "K4": ("cs", "launches", "bwd_launches"),
    "K8": ("fc", "r_launches", "r_bwd_launches"),
    "K9": ("fc", "rm_launches", "rm_bwd_launches"),
    "K10": ("gl", "r_launches", "r_bwd_launches"),
    "K11": ("gl", "pool_launches", "pool_bwd_launches"),
    "K6 linear": ("fc", "linear_launches", "linear_bwd_launches"),
    "K12": ("rx", "launches", "bwd_launches"),
}


def nonzero(launches: dict) -> dict:
    """The counters of ``launches`` that moved."""
    return {k: v for k, v in launches.items() if v not in (0, (0, 0))}


def _ep_modules() -> dict:
    from cgr_mpnn_3d_tpu_torch.ops import conv_stack as cs
    from cgr_mpnn_3d_tpu_torch.ops import fused_conv as fc
    from cgr_mpnn_3d_tpu_torch.ops import fused_model as fm
    from cgr_mpnn_3d_tpu_torch.ops import gather_linear as gl
    from cgr_mpnn_3d_tpu_torch.parallel import ep_pack as ep
    from cgr_mpnn_3d_tpu_torch.parallel import rdma_exchange as rx
    return dict(cs=cs, fc=fc, fm=fm, gl=gl, ep=ep, rx=rx)


def ep_zero():
    """Every launch counter the EP paths move, set to 0 (and the ring
    copies' count)."""
    m = _ep_modules()
    for mod, fwd, bwd in EP_COUNTERS.values():
        for key in (fwd, bwd):
            setattr(m[mod], key, 0)
            if mod != "rx":
                setattr(m[mod], "bf16_" + key, 0)
    for key in ("launches", "train_launches", "vjp_launches"):
        setattr(m["fm"], key, 0)
        setattr(m["fm"], "bf16_" + key, 0)
    m["ep"].ring_moves = 0


def ep_counts() -> dict:
    """(forward, backward) launches of each kernel the EP paths run, f32
    and ("<id> bf16") bf16; K2 and K3f launches; the ring copies' runs."""
    m = _ep_modules()
    out = {}
    for name, (mod, fwd, bwd) in EP_COUNTERS.items():
        out[name] = (getattr(m[mod], fwd), getattr(m[mod], bwd))
        if mod != "rx":
            out[name + " bf16"] = (getattr(m[mod], "bf16_" + fwd),
                                   getattr(m[mod], "bf16_" + bwd))
    fm = m["fm"]
    out.update(K2=fm.train_launches, K3f=fm.launches,
               **{"K2 bf16": fm.bf16_train_launches,
                  "K3f bf16": fm.bf16_launches},
               ring=m["ep"].ring_moves)
    return out


def conv_r_cost(h, r, h0, b, w, p: int, edges: int, backward: bool,
                scale=None) -> tuple[float, float, float]:
    """conv_cost of K6 (ReLU) plus the boundary term of K8/K9 on these
    inputs: one add (K9: and a multiply) per counted sender and column;
    r, senders and the scale read once; backward also the dr gather's adds
    through node_out, node_out read and dr written once."""
    from cgr_mpnn_3d_tpu_torch.ops.segment import in_pack
    prod, other, nbytes = conv_cost(h, h0, b.edge_nbr, b.rev, w, p, edges,
                                    backward)
    n_r = int(in_pack(b.senders, p, r.shape[0])[1].sum()) * h.shape[1]
    n_r *= 2 if scale is not None else 1
    extra = nbytes_of(r, b.senders) + (0 if scale is None
                                       else nbytes_of(scale))
    if not backward:
        return prod, other + n_r, nbytes + extra
    return (prod, other + 2 * n_r,
            nbytes + extra + nbytes_of(b.node_out, r))


def glin_r_cost(xa, xr, xb, b, wa, p: int, backward: bool,
                pool: bool) -> tuple[float, float, float]:
    """glin_cost of the readout (K5 through node_inc) plus K10's xr and
    K11's pool on these inputs: one add per element of xr (backward: dxr
    written), and per counted pool entry and column (forward: pool_ell read
    and the pool written; backward: node_group and the pool's cotangent
    read, one add per output element)."""
    from cgr_mpnn_3d_tpu_torch.ops.segment import in_pack
    adj = b.dst[:, None] if backward else None
    prod, other, nbytes = glin_cost(xa, xb, b.node_inc, wa, p, xb.shape[0],
                                    xa.shape[0], adj)
    rows, H = xr.shape[0], wa.shape[1]
    other += xr.numel()
    nbytes += nbytes_of(xr) * (2 if backward else 1)
    if pool and not backward:
        other += int(in_pack(b.pool_ell, p, rows)[1].sum()) * H
        nbytes += nbytes_of(b.pool_ell) + b.pool_ell.shape[0] * H * 4
    elif pool:
        other += rows * H
        nbytes += nbytes_of(b.node_group) + b.pool_ell.shape[0] * H * 4
    return prod, other, nbytes


def ep_kernels(seed: int, repeats: int, n_ep: int, n_graphs: int = EP_GRAPHS,
               chains=(EP_CHAIN,), dtype: str = "float32") -> dict:
    """K8, K9, K10 and K11 against their plain versions at full width
    (hidden 400, F = 270) on the most wired shard of a batch of
    ``n_graphs`` synthetic graphs and chains of ``chains`` atoms (te 128 /
    tn 72 before the tile grows to a chain's fragment; by default the wired
    batch, whose chain is cut), seeded inputs (r random, as the kernels'
    work does not depend on the cut), and K6 with act="linear" (f32
    output) on the same shard, as the overlap path calls it: f32 forward
    at REL_TOL, backward by the float64 rule of hold (ReLU), a second
    backward bit for bit.  ``dtype="bfloat16"``: h, h0, x and the states'
    cotangents bf16 (r, xr and the readout f32), each held by hold_bf16
    with the f32 kernel as control.  Times of both, plain versions' and
    bounds (products at the bf16 peak at bf16)."""
    import torch
    from cgr_mpnn_3d_tpu_torch.ops import fused_conv as fc
    from cgr_mpnn_3d_tpu_torch.ops import gather_linear as gl
    from cgr_mpnn_3d_tpu_torch.parallel import ep_shards, pack_shard_edges
    graphs, labels = ep_graphs(seed, n_graphs, chains)
    host, spec = pack_shard_edges(graphs, labels, n_ep, te=128, tn=72)
    check(any(spec.caps) or chains != (EP_CHAIN,),
          f"the wired batch has no cut at n_ep={n_ep}")
    shards = ep_shards(host, DEVICE)
    b = max(shards, key=lambda s: float(s.halo_mask.sum()))
    gen = torch.Generator().manual_seed(seed)
    H, F, p = 400, 270, spec.p
    bf16 = dtype == BF16
    sd = torch.bfloat16 if bf16 else torch.float32

    def rand(*shape, scale=1.0, dt=torch.float32):
        return (torch.randn(shape, generator=gen) * scale).to(DEVICE).to(dt)

    h, h0, r = rand(spec.pe, H).relu().to(sd), rand(spec.pe, H).relu().to(
        sd), rand(spec.pn, H, scale=0.5)
    w, bias = rand(H, H, scale=H ** -0.5), rand(H, scale=0.1)
    skip = torch.tensor(1.0, device=DEVICE)
    scale = torch.cat([b.inv_deg, b.inv_deg.new_zeros(1)])[
        b.senders.long()].contiguous()
    E = int((b.senders < spec.pn).sum())
    out: dict = dict(p=p, te=spec.te, tn=spec.tn, caps=spec.caps, edges=E,
                     halo=int(b.halo_mask.sum()), dtype=dtype)
    conv = (h, r, h0, b.edge_nbr, b.rev, b.senders)
    conv_w = (w, bias, skip)
    g = rand(spec.pe, H, dt=sd)
    md = dict(mat_dtype=dtype)
    with torch.no_grad():
        for name, sc in (("K8", None), ("K9", scale)):
            kw = dict(p=p, tn=spec.tn, scale=sc)
            k = dict(kw, **md)
            y = held(out, f"{name} fwd", fc.fused_conv_r_forward,
                     fc.fused_conv_layer_r_ref, (*conv, *conv_w), kw, k)
            args = (*conv, b.edge_nbr_rev, b.node_out, *conv_w, y, g)
            args32 = ((*_f32(args[:-2]), fc.fused_conv_r_forward(
                *_f32(conv), *conv_w, **kw), g.float()) if bf16 else None)
            held(out, f"{name} bwd", fc.fused_conv_r_backward,
                 fc.fused_conv_r_backward_ref, args, kw, k, True, True,
                 args32)
            if repeats:
                _timed(out[f"{name} fwd"],
                       lambda: fc.fused_conv_r_forward(*conv, *conv_w, **k),
                       lambda: fc.fused_conv_layer_r_ref(*conv, *conv_w,
                                                         **k),
                       repeats, conv_r_cost(h, r, h0, b, w, p, E, False, sc),
                       bf16)
                _timed(out[f"{name} bwd"],
                       lambda: fc.fused_conv_r_backward(*args, **k),
                       lambda: fc.fused_conv_r_backward_ref(*args, **k),
                       repeats, conv_r_cost(h, r, h0, b, w, p, E, True, sc),
                       bf16)
        # K6 with the linear activation: the overlap path's pre-activations
        lin = (h, h0, b.edge_nbr, b.rev)
        kl = dict(p=p, act="linear", out_dtype="float32")
        kl16 = dict(kl, **md)
        yl = held(out, "K6 linear fwd", fc.fused_conv_forward,
                  fc.fused_conv_layer_ref, (*lin, *conv_w), kl, kl16)
        gl32 = rand(spec.pe, H)
        largs = (*lin, b.edge_nbr_rev, *conv_w, yl, gl32)
        held(out, "K6 linear bwd", fc.fused_conv_backward,
             fc.fused_conv_backward_ref, largs, kl, kl16, True)
        xr = rand(spec.pn, H, scale=0.5)
        x = b.node_x.to(sd)
        wa, wb, bb = rand(H, H, scale=H ** -0.5), rand(F, H, scale=F ** -0.5), \
            rand(H, scale=0.1)
        gn = rand(spec.pn, H)
        kw = dict(p=p)
        k = dict(kw, **md)
        ro = (h, xr, x, b.node_inc)
        y = held(out, "K10 fwd", gl.gather_linear_r_forward,
                 gl.gather_linear_r_forward_ref, (*ro, wa, wb, bb), kw, k)
        args10 = (*ro, b.dst[:, None], wa, wb, bb, y, gn)
        a10_32 = ((*_f32(args10[:-2]), gl.gather_linear_r_forward(
            *_f32(ro), wa, wb, bb, **kw), gn) if bf16 else None)
        held(out, "K10 bwd", gl.gather_linear_r_backward,
             gl.gather_linear_r_backward_ref, args10, kw, k, True, True,
             a10_32)
        pool_t = (b.node_group, b.pool_ell)
        y, pool = held(out, "K11 fwd", gl.gather_linear_pool_forward,
                       gl.gather_linear_pool_forward_ref,
                       (*ro, *pool_t, wa, wb, bb), kw, k)
        gp = rand(*pool.shape)
        args11 = (*ro, b.dst[:, None], *pool_t, wa, wb, bb, y, gn, gp)
        a11_32 = ((*_f32(args11[:-3]), gl.gather_linear_pool_forward(
            *_f32(ro), *pool_t, wa, wb, bb, **kw)[0], gn, gp) if bf16
            else None)
        held(out, "K11 bwd", gl.gather_linear_pool_backward,
             gl.gather_linear_pool_backward_ref, args11, kw, k, True, True,
             a11_32)
        torch.cuda.synchronize()
        if repeats:
            for name, fwd, ref, fargs, bwd, bref, bargs, pooled in (
                    ("K10", gl.gather_linear_r_forward,
                     gl.gather_linear_r_forward_ref, (*ro, wa, wb, bb),
                     gl.gather_linear_r_backward,
                     gl.gather_linear_r_backward_ref, args10, False),
                    ("K11", gl.gather_linear_pool_forward,
                     gl.gather_linear_pool_forward_ref,
                     (*ro, *pool_t, wa, wb, bb),
                     gl.gather_linear_pool_backward,
                     gl.gather_linear_pool_backward_ref, args11, True)):
                _timed(out[f"{name} fwd"], lambda: fwd(*fargs, **k),
                       lambda: ref(*fargs, **k), repeats,
                       glin_r_cost(h, xr, x, b, wa, p, False, pooled), bf16)
                _timed(out[f"{name} bwd"], lambda: bwd(*bargs, **k),
                       lambda: bref(*bargs, **k), repeats,
                       glin_r_cost(h, xr, x, b, wa, p, True, pooled), bf16)
            _timed(out["K6 linear fwd"],
                   lambda: fc.fused_conv_forward(*lin, *conv_w, **kl16),
                   lambda: fc.fused_conv_layer_ref(*lin, *conv_w, **kl16),
                   repeats, conv_cost(h, h0, b.edge_nbr, b.rev, w, p, E,
                                      False, out_size=4), bf16)
            _timed(out["K6 linear bwd"],
                   lambda: fc.fused_conv_backward(*largs, **kl16),
                   lambda: fc.fused_conv_backward_ref(*largs, **kl16),
                   repeats, conv_cost(h, h0, b.edge_nbr, b.rev, w, p, E,
                                      True, out_size=4), bf16)
    return out


def print_ep_kernels(what: str, k: dict, card: str) -> None:
    print(f"EP kernels {k['dtype']} {what}: {k['p']} packs of te {k['te']} "
          f"/ tn {k['tn']}, caps {k['caps']}, {k['edges']} edges, "
          f"{k['halo']} halo slots [{card}]")
    for name, e in k.items():
        if not isinstance(e, dict):
            continue
        line = f"  {name}: max abs err {e['abs_err']:.3e}"
        if "share" in e:
            line += (f", rel-L2 vs bf16 plain {e['rel_l2']:.3e}, vs f32 plain "
                     f"{e['f32_rel_l2']:.3e}, share {e['share']:.4g} (the f32 "
                     f"kernel's {e['control_share']:.4g})")
        if "cos" in e:
            line += f", gradient cosine {e['cos']:.8f}"
        if "l1_64" in e:
            line += (f", L1 vs float64 kernel {e['l1_64'][0]:.3e} plain "
                     f"{e['l1_64'][1]:.3e}")
        if "ms" in e:
            line += (f"; kernel {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} "
                     f"ms, bound {e['bound_ms']:.4f} ms by {e['bound_by']} "
                     f"({e['ops'] / 1e9:.3f} GOP, {e['bytes'] / 1e6:.3f} MB)")
        print(line)


def single_device_batch(graphs, labels, device):
    """``graphs`` packed by the single-device packer into packs big enough
    for the largest graph (tb 64) -> (spec, batch on ``device``)."""
    from cgr_mpnn_3d_tpu_torch.data import (pack_graphs, packs_needed,
                                            place_graphs, to_device)
    from cgr_mpnn_3d_tpu_torch.data.batch import PackSpec
    te = max(256, -(-max(g.num_edges for g in graphs) // 8) * 8)
    tn = max(128, -(-max(g.num_nodes for g in graphs) // 8) * 8)
    d = max(int(np.bincount(g.receivers).max()) for g in graphs
            if g.num_edges)
    dn = max(g.num_nodes for g in graphs)
    spec = PackSpec(te=te, tn=tn, tb=64, d=d, dn=dn)
    p = packs_needed(graphs, spec)
    while not place_graphs(graphs, spec.with_packs(p)):
        p += 1
    spec = spec.with_packs(p)
    return spec, to_device(pack_graphs(graphs, list(labels), spec), device)


def ep_vs_single(seed: int, n_ep: int, graphs, labels) -> dict:
    """The EP forward and gradients on the card (every shard in this
    process: K5, K8 per layer, K11) against the single-device model on the
    same graphs and weights at full width (ReLU, add/add, depth 4): the
    predictions against the layered ``apply`` on the card at REL_TOL, the
    SSE too, and the gradients against K2's plain version by the float64
    rule of hold; with the launch counts of the EP run."""
    import dataclasses
    import torch
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNN, CGRMPNNConfig, apply
    from cgr_mpnn_3d_tpu_torch.models import init_params
    from cgr_mpnn_3d_tpu_torch.parallel import (ep_pack_forward, ep_shards,
                                                pack_shard_edges)
    cfg = CGRMPNNConfig(num_node_features=270, num_edge_features=14,
                        depth=4, hidden_sizes=(400,) * 4,
                        dropout_ps=(0.0,) * 4)
    whole = init_params(cfg, torch.Generator().manual_seed(seed), DEVICE)
    layered = CGRMPNN(dataclasses.replace(cfg, fuse_whole_model=False)).to(
        DEVICE)
    layered.load_state_dict(whole.state_dict())
    host, spec = pack_shard_edges(graphs, labels, n_ep, te=128, tn=72)
    shards = ep_shards(host, DEVICE)
    spec1, batch1 = single_device_batch(graphs, labels, DEVICE)
    mask = batch1.graph_mask > 0
    rows = batch1.row_ids.long()[mask]
    out: dict = dict(n_ep=n_ep, caps=spec.caps, p=spec.p, te=spec.te,
                     graphs=len(graphs))
    with torch.no_grad():
        want = apply(layered, batch1, spec1)[mask]
    ep_zero()
    sse, preds = ep_pack_forward(layered, shards, spec)
    sse.backward()
    torch.cuda.synchronize()
    out["launches"] = ep_counts()
    hold(out, "preds", preds.detach()[rows], want)
    hold(out, "sse", sse.detach(),
         ((want - batch1.labels[mask]) ** 2).sum())
    seeds = torch.zeros(cfg.depth, dtype=torch.int32)
    hold(out, "grads", [w.grad for w in layered.parameters()],
         k2_plain_grads(whole, batch1, spec1, seeds, torch.float32), True,
         lambda: k2_plain_grads(whole, batch1, spec1, seeds, torch.float64))
    return out


def ep_step_times(seed: int, card: str) -> dict:
    """The EP training step's compute (every shard in this process,
    autograd through the layered EP kernels) at n_ep 2 against the
    single-device layered step (K5, K4, K5, K7) on the same graphs at full
    width, on the zero-cut batch (2,500 synthetic graphs and two 480-atom
    chains: K5, K4, K11 per shard) and on the wired batch (K5, K8 per
    layer, K11 per shard): ms per step over 3 steps (host clock around
    steps ending in a synchronize), and the wired step's device busy share
    under torch.profiler."""
    import torch
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNNConfig, init_params
    from cgr_mpnn_3d_tpu_torch.parallel import (ep_shards,
                                                make_ep_pack_train_step,
                                                pack_shard_edges)
    from cgr_mpnn_3d_tpu_torch.train import sse_loss
    cfg = CGRMPNNConfig(num_node_features=270, num_edge_features=14,
                        depth=4, hidden_sizes=(400,) * 4,
                        dropout_ps=(0.1,) * 4, fuse_whole_model=False)
    model = init_params(cfg, torch.Generator().manual_seed(seed), DEVICE)
    seeds = torch.randint(0, 2**31 - 1, (2, 4), dtype=torch.int32)
    res = {}
    for case, (n, chains) in (("zero-cut", (2500, (480, 480))),
                              ("wired", (EP_GRAPHS, (EP_CHAIN,)))):
        graphs, labels = ep_graphs(seed, n, chains)
        host, spec = pack_shard_edges(graphs, labels, 2, te=128, tn=72)
        shards = ep_shards(host, DEVICE)
        spec1, batch1 = single_device_batch(graphs, labels, DEVICE)
        ep_step = make_ep_pack_train_step(model, spec)

        def single():
            model.zero_grad(set_to_none=True)
            sse_loss(model, batch1, spec1, train=True,
                     seeds=seeds[0]).backward()

        def ep():
            ep_step([shards], seeds[None])

        ms = {}
        for name, fn in (("single", single), ("ep", ep), ("ep2", ep),
                         ("single2", single)):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) / 3 * 1e3
        entry = dict(ep_ms=(ms["ep"] + ms["ep2"]) / 2,
                     single_ms=(ms["single"] + ms["single2"]) / 2,
                     caps=spec.caps, p=spec.p, te=spec.te,
                     single_p=spec1.p, single_te=spec1.te)
        if case == "wired":
            wall, dev_ms, top = device_busy(ep, top=6)
            entry.update(busy=dev_ms / wall, top=top)
        res[case] = entry
        print(f"EP step n_ep 2 {case} ({len(graphs)} graphs, caps "
              f"{spec.caps}, {spec.p} packs of te {spec.te} per shard): "
              f"{entry['ep_ms']:.3f} ms against the single-device layered "
              f"step {entry['single_ms']:.3f} ms ({spec1.p} packs of te "
              f"{spec1.te})" + (f"; device busy {100 * entry['busy']:.1f}% "
                                f"of the EP step, by kernel {entry['top']}"
                                if "busy" in entry else "") + f" [{card}]")
    return res


def wire_buffers(seed: int, n_ep: int, H: int = 400) -> tuple:
    """(spec, per-shard wire buffers [TW, H] f32): the push hop's rows of the
    wired batch at ``n_ep`` -- each shard's local partial sums of seeded
    edge states, gathered on its halo slots (ep_pack's glue)."""
    import torch
    from cgr_mpnn_3d_tpu_torch.parallel import ep_shards, pack_shard_edges
    from cgr_mpnn_3d_tpu_torch.parallel.ep_pack import (_node_partial,
                                                        _wire_gather)
    graphs, labels = ep_graphs(seed, EP_GRAPHS, (EP_CHAIN,))
    host, spec = pack_shard_edges(graphs, labels, n_ep, te=128, tn=72)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        bufs = [_wire_gather(_node_partial(
            torch.randn((spec.pe, H), generator=gen).to(DEVICE), b), b)
            for b in ep_shards(host, DEVICE)]
    return spec, bufs


def exchange_phase(seed: int, repeats: int, card: str) -> dict:
    """K12 (``parallel/rdma_exchange.py``) against its plain version
    (ep_pack's ring copies, ``_ring_move``) on the wired batch's real wire
    buffers at n_ep 2 and 4, f32 and bf16: both directions and the
    autograd backward (the inverse exchange) bit for bit, one launch per
    exchange; times of the kernel, the plain version and the library call
    (one ``index_select`` over the stacked buffers through a row map built
    beforehand; the kernel and the library call are timed in turn, the
    median of 5 rounds of 200 calls each), the device time per call of
    the kernel and of the library call under torch.profiler, the
    wrapper's host time step by step (tools/k12_host.py), and the bytes
    bound 2 · n_ep · TW · H · elem over PEAK_BYTES."""
    import torch
    from cgr_mpnn_3d_tpu_torch.parallel import ep_pack as ep
    from cgr_mpnn_3d_tpu_torch.parallel import rdma_exchange as rx
    from cgr_mpnn_3d_tpu_torch.tools import k12_host
    out = {}
    for n_ep in (2, 4):
        spec, bufs32 = wire_buffers(seed, n_ep)
        caps, tw = spec.caps, spec.tw
        # the library call's row map: output row k*TW + r of the stacked
        # buffers reads input row src*TW + r
        rows = np.empty(n_ep * tw, np.int64)
        off = 0
        for hop, s_h in enumerate(caps, start=1):
            for k in range(n_ep):
                src = (k - hop) % n_ep
                rows[k * tw + off:k * tw + off + s_h] = src * tw + np.arange(
                    off, off + s_h)
            off += s_h
        row_map = torch.from_numpy(rows).to(DEVICE)
        for dtype in (torch.float32, torch.bfloat16):
            bufs = [b.to(dtype).contiguous() for b in bufs32]
            name = f"n_ep {n_ep} {str(dtype)[6:]}"
            before = (rx.launches, rx.bwd_launches)
            for inverse in (False, True):
                got = rx.ring_exchange_rdma(bufs, caps, inverse)
                want = rx._ring_move(bufs, caps, inverse)
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"K12 {name} inverse={inverse} differs from the ring "
                      f"copies")
            leaves = [b.clone().requires_grad_() for b in bufs]
            wts = [torch.randn_like(b) for b in leaves]
            grads = [torch.autograd.grad(
                sum((o * w).sum() for o, w in zip(fn(leaves, caps), wts)),
                leaves) for fn in (rx.ring_exchange_rdma, ep.ring_exchange)]
            check(all(torch.equal(a, b) for a, b in zip(*grads)),
                  f"K12 {name}: its backward differs from the ring copies'")
            check((rx.launches - before[0], rx.bwd_launches - before[1])
                  == (3, 1), f"K12 {name}: launches "
                  f"{(rx.launches - before[0], rx.bwd_launches - before[1])}"
                  f", expected one per exchange")
            stacked = torch.stack(bufs).reshape(n_ep * tw, -1)
            lib = stacked.index_select(0, row_map).reshape(n_ep, tw, -1)
            check(all(torch.equal(lib[k], w) for k, w in enumerate(
                rx._ring_move(bufs, caps, False))),
                f"index_select {name} differs from the ring copies")
            nbytes = 2 * n_ep * tw * bufs[0].shape[1] * bufs[0].element_size()
            entry = dict(abs_err=0.0, tw=tw, caps=caps)
            _timed(entry, lambda: rx.ring_exchange_rdma(bufs, caps),
                   lambda: rx._ring_move(bufs, caps, False), repeats,
                   (0.0, 0.0, float(nbytes)))
            # K12 and the library call in turn, 5 rounds of 200 calls:
            # both are host-bound, and the host is shared
            rounds = alternating_ms({
                "K12": lambda: rx.ring_exchange_rdma(bufs, caps),
                "index_select": lambda: stacked.index_select(0, row_map)},
                200)
            entry["ms"] = statistics.median(rounds["K12"])
            entry["library_ms"] = statistics.median(rounds["index_select"])
            entry["rounds"] = rounds
            entry["host_us"] = k12_host.split(bufs, caps, 2000)
            # the card's own time per call, beside the event times (which
            # hold the wrappers' host work when it exceeds the kernel's)
            for key, fn in (("device_ms", lambda: rx.ring_exchange_rdma(
                    bufs, caps)), ("library_device_ms",
                                   lambda: stacked.index_select(0, row_map))):
                _, busy, top = device_busy(
                    lambda: [fn() for _ in range(repeats)], top=2)
                entry[key], entry[key + "_by"] = busy / repeats, top
            out[name] = entry
            print(f"K12 {name}: caps {caps}, TW {tw}: bit for bit both ways "
                  f"and backward; kernel {entry['ms']:.4f} ms, plain (ring "
                  f"copies) {entry['plain_ms']:.4f} ms, index_select "
                  f"{entry['library_ms']:.4f} ms, bound "
                  f"{entry['bound_ms']:.6f} ms by {entry['bound_by']} "
                  f"({nbytes / 1e6:.3f} MB) [{card}]")
            # the profiler may record no device time for a call this short
            factor = (f"{entry['device_ms'] / entry['library_device_ms']:.3f}"
                      if entry["library_device_ms"] > 0 else
                      "not measured (no device time recorded for "
                      "index_select)")
            print(f"K12 {name} device time per call (torch.profiler, "
                  f"{repeats} calls): kernel {entry['device_ms']:.6f} ms "
                  f"{entry['device_ms_by']}, index_select "
                  f"{entry['library_device_ms']:.6f} ms "
                  f"{entry['library_device_ms_by']}: device factor {factor}, "
                  f"event factor {entry['ms'] / entry['library_ms']:.3f}; "
                  f"host share of the kernel's event time "
                  f"{1 - entry['device_ms'] / entry['ms']:.3f} [{card}]")
            print(f"K12 {name} wrapper host time, µs a call "
                  f"(tools/k12_host.py): " + "; ".join(
                      f"{k} {v:.3f}" for k, v in entry["host_us"].items())
                  + f"; event times, 5 alternating rounds of 200 calls: "
                  f"K12 {[round(1e3 * t, 3) for t in entry['rounds']['K12']]}"
                  f", index_select "
                  f"{[round(1e3 * t, 3) for t in entry['rounds']['index_select']]}"
                  f" [{card}]")
    return out


def ep_variants(seed: int, card: str) -> dict:
    """The wired EP training step at n_ep 2 (README model, dropout 0.1, one
    seed set) in each variant: f32 through the ring copies and through K12
    (--ep_rdma: SSE and gradients equal bit for bit, one K12 launch per
    exchange and no ring copy, also at n_ep 4), bf16 (the EP forward and
    gradients against the f32 path within tests/test_bf16.py's bounds),
    and --ep_overlap at f32 (predictions and SSE at REL_TOL against the
    K8 path, gradients by the float64 rule of hold, the float64
    evaluation on the CPU, on the smaller wired batch of ep_vs_single) and
    at bf16 (the bf16 rule against the bf16 K8 path); ms per step (host
    clock over 3 steps ending in a synchronize) of each, the device busy
    share of each, launches per step."""
    import dataclasses
    import torch
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNN, CGRMPNNConfig
    from cgr_mpnn_3d_tpu_torch.parallel import (ep_pack_forward, ep_shards,
                                                pack_shard_edges)
    base = CGRMPNNConfig(num_node_features=270, num_edge_features=14,
                         depth=4, hidden_sizes=(400,) * 4,
                         dropout_ps=(0.1,) * 4, fuse_whole_model=False)
    weights = CGRMPNN(base, torch.Generator().manual_seed(seed)).state_dict()

    def model_of(device=DEVICE, **kw):
        m = CGRMPNN(dataclasses.replace(base, **kw)).to(device)
        m.load_state_dict(weights)
        return m

    def run(model, shards, spec, seeds):
        model.zero_grad(set_to_none=True)
        sse, preds = ep_pack_forward(model, shards, spec, train=True,
                                     seeds=seeds)
        sse.backward()
        return sse.detach(), preds.detach(), [p.grad.clone()
                                              for p in model.parameters()]

    def step_ms(model, shards, spec, seeds):
        run(model, shards, spec, seeds)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            run(model, shards, spec, seeds)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 3 * 1e3

    res: dict = {}
    for n_ep in (2, 4):
        graphs, labels = ep_graphs(seed, EP_GRAPHS, (EP_CHAIN,))
        host, spec = pack_shard_edges(graphs, labels, n_ep, te=128, tn=72)
        shards = ep_shards(host, DEVICE)
        seeds = torch.randint(0, 2**31 - 1, (n_ep, 4), dtype=torch.int32,
                              generator=torch.Generator().manual_seed(seed))
        variants = ((("f32", {}), ("f32 --ep_rdma",
                                   dict(ep_rdma_exchange=True)))
                    if n_ep == 4 else
                    (("f32", {}), ("f32 --ep_rdma",
                                   dict(ep_rdma_exchange=True)),
                     ("bf16", dict(compute_dtype=BF16)),
                     ("f32 --ep_overlap", dict(ep_overlap=True)),
                     ("bf16 --ep_overlap", dict(ep_overlap=True,
                                                compute_dtype=BF16))))
        runs = {}
        for name, kw in variants:
            model = model_of(**kw)
            ep_zero()
            runs[name] = run(model, shards, spec, seeds)
            torch.cuda.synchronize()
            launches = ep_counts()
            wall, dev_ms, top = device_busy(
                lambda: run(model, shards, spec, seeds), top=6)
            res[f"n_ep {n_ep} {name}"] = dict(
                launches=launches, ms=step_ms(model, shards, spec, seeds),
                busy=dev_ms / wall, top=top)
        ring, rdma = runs["f32"], runs["f32 --ep_rdma"]
        check(torch.equal(ring[0], rdma[0])
              and all(torch.equal(a, b) for a, b in zip(ring[2], rdma[2])),
              f"--ep_rdma at n_ep {n_ep}: the SSE or gradients differ from "
              f"the ring copies'")
        lr = res[f"n_ep {n_ep} f32 --ep_rdma"]["launches"]
        check(lr["K12"] == (9, 9) and lr["ring"] == 0
              and res[f"n_ep {n_ep} f32"]["launches"]["ring"] == 18,
              f"--ep_rdma at n_ep {n_ep}: K12 launches {lr['K12']} and "
              f"ring copies {lr['ring']} per step, expected (9, 9) and 0")
        if n_ep != 2:
            continue
        b16 = runs["bf16"]
        sse_rel = abs(float(b16[0]) - float(ring[0])) / abs(float(ring[0]))
        pr, gr, gc = (rel_l2([b16[1]], [ring[1]]), rel_l2(b16[2], ring[2]),
                      cosine(b16[2], ring[2]))
        check(pr < 1.5e-2 and sse_rel < 2e-2 and gc > 0.995 and gr < 0.1,
              f"bf16 EP vs f32 EP: preds rel-L2 {pr:.3e}, SSE {sse_rel:.3e},"
              f" gradient cosine {gc:.6f} rel-L2 {gr:.3e}")
        res["bf16 vs f32"] = dict(preds=pr, sse=sse_rel, grads=gr, cos=gc)
        lb = res["n_ep 2 bf16"]["launches"]
        check(all(lb[k] == (0, 0) for k in ("K5", "K8", "K11"))
              and lb["K8 bf16"] == (8, 8),
              f"the bf16 EP step launched {lb}")
        o16 = runs["bf16 --ep_overlap"]
        opr, ogc = rel_l2([o16[1]], [b16[1]]), cosine(o16[2], b16[2])
        check(opr <= BF16_TOL and ogc >= BF16_COS,
              f"bf16 --ep_overlap vs the bf16 K8 path: preds rel-L2 "
              f"{opr:.3e}, gradient cosine {ogc:.6f}")
        res["bf16 overlap vs K8"] = dict(preds=opr, cos=ogc)
        lo = res["n_ep 2 f32 --ep_overlap"]["launches"]
        check(lo["K6 linear"] == (8, 8) and lo["K8"] == (0, 0),
              f"the overlap step launched {lo}")
    # --ep_overlap at f32 against the K8 path, gradients by the float64 rule
    graphs, labels = ep_graphs(seed, 50, (2400,))
    host, spec = pack_shard_edges(graphs, labels, 2, te=128, tn=72)
    shards = ep_shards(host, DEVICE)
    seeds = torch.randint(0, 2**31 - 1, (2, 4), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(seed))
    k8 = run(model_of(), shards, spec, seeds)
    ov = run(model_of(ep_overlap=True), shards, spec, seeds)
    exact = run(model_of("cpu").double(), ep_shards(host, "cpu"), spec,
                seeds)
    hold_ov: dict = dict(caps=spec.caps)
    hold(hold_ov, "preds", ov[1], k8[1])
    hold(hold_ov, "sse", ov[0], k8[0])
    hold(hold_ov, "grads", ov[2], k8[2], True,
         lambda: [g.to(DEVICE) for g in exact[2]])
    res["f32 overlap vs K8"] = hold_ov
    for name, e in res.items():
        line = f"EP wired step {name}: " + (
            f"{e['ms']:.3f} ms per step; launches {nonzero(e['launches'])}"
            + f"; device busy {100 * e['busy']:.1f}%, by kernel {e['top']}"
            if "ms" in e else
            ", ".join(f"{k} {v}" for k, v in e.items()))
        print(line + f" [{card}]")
    return res


def profile_ep_phase(card: str) -> dict:
    """``tools/profile_ep.py`` at its defaults (2,500 graphs, te 128 / tn 64,
    bf16): every row, with the bf16 K10 launches of its readout row (K10's
    only caller, as in JAX)."""
    from cgr_mpnn_3d_tpu_torch.tools import profile_ep
    res = profile_ep.main([])
    check(res["launches"] > 0 and all(np.isfinite(v) and v > 0
                                      for v in res["ms"].values()),
          f"tools/profile_ep.py: {res['launches']} bf16 K10 launches, rows "
          f"{res['ms']}")
    print(f"tools/profile_ep.py (bf16, p = {res['spec']['p']} packs of te "
          f"128): K10 readout row {res['ms']['K10 readout fwd']:.4f} ms, "
          f"{res['launches']} bf16 K10 launches; ep fwd "
          f"{res['ms']['ep fwd']:.3f} ms, fwd+bwd {res['ms']['ep fwd+bwd']:.3f}"
          f" ms [{card}]")
    return res


def ep_cli_phase(tmp: Path, seed: int, card: str,
                 dtype: str = "float32") -> dict:
    """``cli.train.main --ep 2`` (at ``dtype``: ``--compute_dtype``) with the
    README's model and flags on the corpus, 3 epochs on the card and 2 on
    the CPU (zero cut: one K2 per shard and step; validation through K5,
    K4, K11; the test after training through the f32 K3f, as the
    checkpoint loads in f32), per-epoch RMSE held at TRAIN_TOL (bf16:
    BF16_TRAIN_TOL); at bf16 every EP launch is a bf16 one; steps/s per
    epoch (StepTimer).  Its runs/ go to ``tmp/ep_cli`` (``ep_cli_bf16``)."""
    import torch
    data = tmp / "datasets"
    cwd = os.getcwd()
    bf16 = dtype == BF16
    sfx = " bf16" if bf16 else ""
    flags = ["--ep", "2", "--compute_dtype", dtype]
    run_dir = tmp / ("ep_cli_bf16" if bf16 else "ep_cli")
    run_dir.mkdir(exist_ok=True)
    os.chdir(run_dir)
    try:
        ep_zero()
        t0 = time.perf_counter()
        card_res = train_cli(tmp, data, seed, DEVICE, 3, "ep_card" + dtype,
                             *flags)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ep_counts()
        cpu_res = train_cli(tmp, data, seed, "cpu", 2, "ep_cpu" + dtype,
                            *flags, "--skip_test")
        steps_per_s = [json.loads(line).get("steps_per_s")
                       for f in Path("runs").glob("*_e-3_*.jsonl")
                       for line in f.read_text().splitlines()
                       if '"train_loss"' in line]
    finally:
        os.chdir(cwd)
    steps = card_res["steps"]
    check(steps > 0 and launches["K2" + sfx] == 2 * steps,
          f"--ep 2 {dtype}: {launches['K2' + sfx]} K2 launches for {steps} "
          f"steps (one per shard and step on the zero-cut corpus)")
    check(launches["K5" + sfx][0] > 0 and launches["K4" + sfx][0] > 0
          and launches["K11" + sfx][0] > 0 and launches["K3f"] > 0,
          f"--ep 2 {dtype} validation or test launched no kernel: "
          f"{launches}")
    zero = [k for k in ("K8", "K9", "K10", "K8 bf16", "K9 bf16", "K10 bf16")
            if launches[k] != (0, 0)]
    if bf16:
        zero += [k for k in ("K5", "K4", "K11") if launches[k] != (0, 0)]
        zero += ["K2"] if launches["K2"] else []
    check(not zero, f"--ep 2 {dtype} launched {zero}: {launches}")
    tol = BF16_TRAIN_TOL if bf16 else TRAIN_TOL
    rel = max(abs(a - b) / abs(b) for key in ("train_losses", "val_losses")
              for a, b in zip(card_res[key], cpu_res[key]))
    check(all(np.isfinite(card_res[k]).all() for k in ("train_losses",
                                                       "val_losses"))
          and rel <= tol,
          f"--ep 2 {dtype} card vs CPU per-epoch RMSE differ by {rel:.3e}")
    print(f"train cli --ep 2 {dtype} card: 3 epochs, {steps} steps in "
          f"{wall:.3f} s wall, train RMSE {card_res['train_losses']}, val "
          f"RMSE {card_res['val_losses']}, test RMSE "
          f"{card_res['test_losses']}; launches {nonzero(launches)}; steps/s per "
          f"epoch (StepTimer) {steps_per_s}; card vs CPU (2 epochs) max rel "
          f"diff {rel:.3e} (limit {tol}) [{card}]")
    return dict(launches=launches, steps_per_s=steps_per_s, rel=rel)


# the wired training runs: (name, config fields, the (forward, backward)
# launches of the counters that move; every other counter stays 0 and
# the ring copies run unless K12 replaces them)
WIRED_RUNS = (
    ("add", dict(aggr="add"), {"K5": (12, 6), "K8": (48, 24),
                               "K11": (12, 6)}),
    ("mean", dict(aggr="mean"), {"K5": (12, 6), "K9": (48, 24),
                                 "K11": (12, 6)}),
    ("add bf16", dict(aggr="add", compute_dtype=BF16),
     {"K5 bf16": (12, 6), "K8 bf16": (48, 24), "K11 bf16": (12, 6)}),
    ("mean bf16", dict(aggr="mean", compute_dtype=BF16),
     {"K5 bf16": (12, 6), "K9 bf16": (48, 24), "K11 bf16": (12, 6)}),
    # one K12 launch per exchange: 2 per wired layer and 1 in the readout
    ("add --ep_rdma", dict(aggr="add", ep_rdma_exchange=True),
     {"K5": (12, 6), "K8": (48, 24), "K11": (12, 6), "K12": (54, 27),
      "ring": 0}),
    ("add --ep_overlap", dict(aggr="add", ep_overlap=True),
     {"K5": (12, 6), "K6 linear": (48, 24), "K11": (12, 6)}),
)


def ep_train_wired(tmp: Path, seed: int, card: str) -> dict:
    """RxnGraphTrainer with ``n_ep=2`` on a wired dataset (a 480-atom chain
    and 7 synthetic graphs, one batch: the chain is cut), the README's
    model at full width with dropout 0.1, in each of WIRED_RUNS' configs
    (aggr add: K8, mean: K9; at bf16; with --ep_rdma: K12; with
    --ep_overlap: K6 linear), 3 epochs on the card and on the CPU:
    per-epoch RMSE held at TRAIN_TOL (bf16: BF16_TRAIN_TOL), and per epoch
    K5, the conv kernel per layer and K11 once per shard forward and
    backward in the step, forward again in validation; every other
    counter stays 0."""
    import torch
    from cgr_mpnn_3d_tpu_torch.data.batch import PackSpec
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNNConfig
    from cgr_mpnn_3d_tpu_torch.train import RxnGraphTrainer
    graphs, labels = ep_graphs(seed + 3, 7, (480,))
    ds = GraphSet(graphs, labels, 270)
    out = {}
    for name, fields, want in WIRED_RUNS:
        cfg = CGRMPNNConfig(num_node_features=270, num_edge_features=14,
                            depth=4, hidden_sizes=(400,) * 4,
                            dropout_ps=(0.1,) * 4, **fields)
        tag = name.replace(" ", "_").replace("-", "")

        def trainer(device):
            return RxnGraphTrainer(
                name=f"ep_wired_{tag}_{device}", cfg=cfg, train_data=ds,
                val_data=ds, spec=PackSpec(), lr=1e-4, weight_decay=1e-5,
                gamma=0.9, num_epochs=3, batch_size=len(ds), val_frequency=1,
                seed=seed, model_save_dir=str(tmp / f"ep_wired_{device}"),
                device=device, n_ep=2)

        t0 = time.perf_counter()
        ep_zero()
        card_res = trainer(DEVICE).train()
        torch.cuda.synchronize()
        launches = ep_counts()
        cpu_res = trainer("cpu").train()
        moved = {k: v for k, v in nonzero(launches).items()
                 if k != "ring" or "ring" in want}
        check(card_res["steps"] == 3
              and moved == {k: v for k, v in want.items() if v},
              f"wired {name} training launches {nonzero(launches)}, "
              f"expected {want}")
        tol = BF16_TRAIN_TOL if "bf16" in name else TRAIN_TOL
        rel = max(abs(a - b) / abs(b) for key in ("train_losses",
                                                  "val_losses")
                  for a, b in zip(card_res[key], cpu_res[key]))
        check(all(np.isfinite(card_res[k]).all() for k in ("train_losses",
                                                           "val_losses"))
              and rel <= tol,
              f"wired {name} card vs CPU per-epoch RMSE differ by {rel:.3e}")
        print(f"train wired EP {name} n_ep 2: 3 steps, train RMSE "
              f"{card_res['train_losses']}, val RMSE "
              f"{card_res['val_losses']}; launches {nonzero(launches)}; card "
              f"vs CPU max rel diff {rel:.3e} (limit {tol}); phase wall "
              f"{time.perf_counter() - t0:.1f} s [{card}]")
        out[name] = dict(launches=launches, rel=rel)
    return out


# ---------------------------------------------------------------------------
# the flat edge-partition layout (parallel/edge_partition.py) through K7
# ---------------------------------------------------------------------------

# the plain gathers of ops/segment.py and K7's plain version
FLAT_PLAIN = (("segment", ("gather_nodes", "node_partial_sum", "gather_rev",
                           "graph_pool_sum", "node_incoming_sum")),
              ("onehot_spmm", ("onehot_spmm_ref",)))


class NoPlainGathers:
    """While active, every plain gather op of ``ops/segment.py`` and K7's
    plain version raise: a flat run on the card that reaches one fails."""

    def __enter__(self):
        from cgr_mpnn_3d_tpu_torch.ops import onehot_spmm, segment
        mods = dict(segment=segment, onehot_spmm=onehot_spmm)
        self.saved = [(mods[m], n, getattr(mods[m], n))
                      for m, names in FLAT_PLAIN for n in names]

        def refuse(*a, **k):
            raise RuntimeError("chip_smoke check failed: a plain gather ran "
                               "during a flat run on the card")
        for mod, name, _ in self.saved:
            setattr(mod, name, refuse)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def spmm_counts() -> tuple:
    """K7's (f32 forward, f32 backward, bf16 forward, bf16 backward)
    launches so far."""
    from cgr_mpnn_3d_tpu_torch.ops import onehot_spmm as om
    return (om.launches, om.bwd_launches, om.bf16_launches,
            om.bf16_bwd_launches)


def _moved(before: tuple) -> tuple:
    return tuple(a - b for a, b in zip(spmm_counts(), before))


def _flat_model(cfg, src, device, dtype=None):
    """A model of ``cfg`` on ``device`` with the weights of ``src``."""
    import torch
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNN
    m = CGRMPNN(cfg).to(device)
    m.load_state_dict({k: v.to(device) for k, v in src.state_dict().items()})
    return m.to(dtype or torch.float32)


def _flat_step(model, shards, seeds=None):
    """(SSE, gradients on the CPU) of one flat train step."""
    from cgr_mpnn_3d_tpu_torch.parallel import edge_partition as flat
    sse = flat.make_ep_train_step(model)([shards], seeds)
    return sse.detach().cpu(), [p.grad.detach().cpu()
                                for p in model.parameters()]


def flat_case(out: dict, name: str, cfg, src, graphs, labels, n_ep: int,
              single=None, f64: bool = True) -> dict:
    """The flat layout at ``n_ep`` on ``graphs`` with the weights of
    ``src`` in the layered ``cfg``: the forward (eval) and one training
    step on the card under NoPlainGathers, their K7 launches against the
    plan (``edge_partition.flat_launches``), predictions and SSE against
    the same code on the CPU at REL_TOL (and against ``single`` =
    (rows, predictions) of the single-device model on the card), gradients
    against the CPU's by hold's float64 rule (``f64``), a rerun of the
    card's step bit for bit.  Returns the case's shards and host batch."""
    import torch
    from cgr_mpnn_3d_tpu_torch.parallel import edge_partition as flat
    host = flat.shard_edges(graphs, labels, n_ep)
    shards = flat.flat_shards(host, DEVICE)
    cpu_shards = flat.flat_shards(host, "cpu")
    NKH = host.node_x.shape[1]
    NK = host.own_recv_inc.shape[1]
    e = dict(n_ep=n_ep, nk=NK, nkh=NKH, ek=host.src_idx.shape[1],
             s=(NKH - NK) // n_ep, d=host.part_inc.shape[2],
             real_edges=[int((host.src_idx[k] < NKH).sum())
                         for k in range(n_ep)],
             boundary=[int((host.recv_idx[k] < NK).sum())
                       for k in range(n_ep)])
    card_m = _flat_model(cfg, src, DEVICE)
    cpu_m = _flat_model(cfg, src, "cpu")
    L = cfg.depth
    with NoPlainGathers(), torch.no_grad():
        before = spmm_counts()
        sse, preds = flat.ep_forward(card_m, shards)
        torch.cuda.synchronize()
        fwd = _moved(before)
    plan_fwd = n_ep * flat.flat_launches(L, False)
    check(fwd == (plan_fwd, 0, 0, 0),
          f"flat {name} forward K7 launches {fwd}, plan "
          f"({plan_fwd}, 0, 0, 0)")
    with torch.no_grad():
        sse_cpu, preds_cpu = flat.ep_forward(cpu_m, cpu_shards)
    hold(e, "preds vs CPU", preds.cpu(), preds_cpu)
    hold(e, "sse vs CPU", sse.cpu(), sse_cpu)
    if single is not None:
        rows, want = single
        hold(e, "preds vs single device", preds[rows], want)
    with NoPlainGathers():
        before = spmm_counts()
        sse_c, grads_c = _flat_step(card_m, shards)
        torch.cuda.synchronize()
        step = _moved(before)
        _, again = _flat_step(card_m, shards)
    plan_bwd = n_ep * (flat.flat_launches(L, True)
                       - flat.flat_launches(L, False))
    check(step == (plan_fwd, plan_bwd, 0, 0),
          f"flat {name} step K7 launches {step}, plan "
          f"({plan_fwd}, {plan_bwd}, 0, 0)")
    check(all(torch.equal(a, b) for a, b in zip(grads_c, again)),
          f"flat {name}: two card steps differ")
    sse_p, grads_p = _flat_step(cpu_m, cpu_shards)
    hold(e, "step sse vs CPU", sse_c, sse_p)
    exact = (lambda: _flat_step(_flat_model(cfg, src, "cpu", torch.float64),
                                cpu_shards)[1]) if f64 else None
    hold(e, "grads vs CPU", grads_c, grads_p, cfg.activation == "ReLU"
         and f64, exact)
    e.update(launches=dict(forward=fwd, step=step), sse=float(sse_c),
             grads=grads_c, preds=preds.detach())
    out[name] = e
    print(f"flat EP {name} (NK {NK}, S {e['s']}, EK "
          f"{e['ek']}, D {e['d']}, real edges a shard {e['real_edges']}, "
          f"boundary rows served {e['boundary']}): preds vs CPU rel "
          f"{e['preds vs CPU']['rel_err']:.3e}"
          + (f", vs single device {e['preds vs single device']['rel_err']:.3e}"
             if single is not None else "")
          + f", step SSE {e['step sse vs CPU']['rel_err']:.3e}, gradients "
          + (f"L1 vs float64 {e['grads vs CPU']['l1_64'][0]:.3e} (CPU "
             f"{e['grads vs CPU']['l1_64'][1]:.3e})"
             if "l1_64" in e["grads vs CPU"] else
             f"rel {e['grads vs CPU']['rel_err']:.3e}")
          + f"; K7 launches forward {fwd[0]}, step {step[:2]} (plan "
          f"{plan_fwd}, ({plan_fwd}, {plan_bwd})), no plain gather")
    return shards


def _host_ms3(fn) -> float:
    """ms a call of ``fn``: 3 calls on the host clock, ending in a
    synchronize, after one call that is not timed."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / 3 * 1e3


def flat_ep_phase(tmp: Path, seed: int, card: str) -> dict:
    """The flat layout (``shard_edges``, ``ep_forward``, the train step and
    ``EPLoader``) on the card, every shard in this process: see item 25 of
    the module doc."""
    import dataclasses
    import torch
    from cgr_mpnn_3d_tpu_torch.data import ChemDataset
    from cgr_mpnn_3d_tpu_torch.data.descriptors import \
        synthetic_descriptors_npz
    from cgr_mpnn_3d_tpu_torch.data.synthetic import chain_graph
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNNConfig, apply, init_params
    from cgr_mpnn_3d_tpu_torch.parallel import edge_partition as flat
    from cgr_mpnn_3d_tpu_torch.parallel import (EPLoader, ep_shards,
                                                make_ep_pack_train_step,
                                                pack_shard_edges)
    t_phase = time.perf_counter()
    out: dict = {"cases": {}, "times": {}}
    before_all = spmm_counts()
    full = CGRMPNNConfig(num_node_features=270, num_edge_features=14,
                         depth=4, hidden_sizes=(400,) * 4,
                         dropout_ps=(0.0,) * 4)
    whole = init_params(full, torch.Generator().manual_seed(seed), DEVICE)
    lay = dataclasses.replace(full, fuse_whole_model=False)
    graphs, labels = ep_graphs(seed, EP_GRAPHS, (EP_CHAIN,))
    spec1, batch1 = single_device_batch(graphs, labels, DEVICE)
    mask = batch1.graph_mask > 0
    rows = batch1.row_ids.long()[mask]
    with torch.no_grad():
        want = apply(whole, batch1, spec1)[mask]      # K3f
    cases = out["cases"]
    shards_of = {}
    for n_ep in (2, 4):
        shards_of[n_ep] = flat_case(cases, f"wired full width n_ep {n_ep}",
                                    lay, whole, graphs, labels, n_ep,
                                    (rows, want))
    # bf16: the linears' operands rounded, K7 at f32 (its bf16 counters
    # stay 0), held to the f32 oracle at tests/test_bf16.py's bounds
    f32 = cases["wired full width n_ep 2"]
    m16 = _flat_model(dataclasses.replace(lay, compute_dtype=BF16), whole,
                      DEVICE)
    with NoPlainGathers():
        before = spmm_counts()
        with torch.no_grad():
            _, preds16 = flat.ep_forward(m16, shards_of[2])
        sse16, grads16 = _flat_step(m16, shards_of[2])
        torch.cuda.synchronize()
        moved16 = _moved(before)
    r16 = rel_l2([preds16], [f32["preds"]])
    c16 = cosine(grads16, f32["grads"])
    fwd16 = 2 * flat.flat_launches(4, False)
    plan16 = (2 * fwd16, 2 * flat.flat_launches(4, True) - fwd16, 0, 0)
    check(0.0 < r16 < 1.5e-2 and c16 > 0.995,
          f"flat bf16 n_ep 2: preds rel-L2 {r16:.3e} to f32 (limit 1.5e-2), "
          f"gradient cosine {c16:.6f} (limit 0.995)")
    check(moved16 == plan16, f"flat bf16 n_ep 2: K7 launches {moved16} "
                             f"(eval forward and step), plan {plan16}")
    out["bf16"] = dict(rel_l2=r16, cos=c16, launches=moved16,
                       sse=float(sse16))
    print(f"flat EP bf16 n_ep 2, full width: predictions rel-L2 {r16:.3e} "
          f"to the f32 run, gradient cosine {c16:.6f}, step SSE "
          f"{float(sse16):.6e} against f32 {f32['sse']:.6e}; K7 launches "
          f"{moved16} (f32 fwd, f32 bwd, bf16 fwd, bf16 bwd)")
    # the step's and the forward's ms beside the pack-local EP step
    model = _flat_model(lay, whole, DEVICE)
    for n_ep in (2, 4):
        host, spec = pack_shard_edges(graphs, labels, n_ep, te=128, tn=72)
        pshards = ep_shards(host, DEVICE)
        pack_step = make_ep_pack_train_step(model, spec)
        flat_step = flat.make_ep_train_step(model)
        shards = shards_of[n_ep]

        def flat_forward():
            with torch.no_grad():
                flat.ep_forward(model, shards)

        fns = {"flat forward": flat_forward,
               "flat step": lambda: flat_step([shards]),
               "pack-local step": lambda: pack_step([pshards])}
        ms = {k: [] for k in fns}
        for _ in range(2):
            for k, fn in fns.items():
                ms[k].append(_host_ms3(fn))
        out["times"][n_ep] = ms
        print(f"flat EP n_ep {n_ep}, full width, wired set: ms a call "
              f"(host clock, 3 calls ending in a synchronize, two rounds) "
              f"{ {k: [round(v, 3) for v in vs] for k, vs in ms.items()} }; "
              f"pack-local caps {spec.caps}, {spec.p} packs of te {spec.te} "
              f"a shard [{card}]")
    # mean aggregation and pooling at small width, against K3f too
    small = CGRMPNNConfig(num_node_features=78, num_edge_features=14,
                          depth=3, hidden_sizes=(40,) * 3,
                          dropout_ps=(0.0,) * 3, activation="SiLU",
                          aggr="mean", pooling="mean",
                          use_learnable_skip=True)
    w_small = init_params(small, torch.Generator().manual_seed(seed + 1),
                          DEVICE)
    with torch.no_grad():
        for w, v in zip(w_small.skip_weights, (0.8, -0.3, 1.2)):
            w.fill_(v)
    lay_s = dataclasses.replace(small, fuse_whole_model=False)
    g_s, l_s = ep_graphs(seed + 1, 50, (600,), F=78)
    spec_s, batch_s = single_device_batch(g_s, l_s, DEVICE)
    mask_s = batch_s.graph_mask > 0
    with torch.no_grad():
        want_s = apply(w_small, batch_s, spec_s)[mask_s]
    flat_case(cases, "small width SiLU mean/mean n_ep 4", lay_s, w_small,
              g_s, l_s, 4, (batch_s.row_ids.long()[mask_s], want_s))
    # empty parts: a zero cut (every boundary row a sentinel) and shards
    # that own no edge
    rng = np.random.default_rng(seed + 2)
    zero_cut = [chain_graph(20, rng, 78), chain_graph(20, rng, 78)]
    flat_case(cases, "zero cut n_ep 2", lay_s, w_small, zero_cut,
              [0.5, -0.5], 2, f64=False)
    check(sum(cases["zero cut n_ep 2"]["boundary"]) == 0,
          "the zero-cut case has boundary rows")
    edgeless = [chain_graph(12, rng, 78)] + [chain_graph(1, rng, 78)
                                             for _ in range(12)]
    flat_case(cases, "edgeless shards n_ep 4", lay_s, w_small, edgeless,
              list(np.linspace(-1, 1, 13)), 4, f64=False)
    check(cases["edgeless shards n_ep 4"]["real_edges"].count(0) >= 2,
          "no shard of the edgeless case is without edges")
    # an EPLoader epoch on the corpus (n_dp 2, n_ep 2), card against CPU
    corpus = ROOT / "tests" / "corpus_reactions.csv"
    synthetic_descriptors_npz(corpus, tmp / "flat_corpus.npz", 64, seed=seed)
    ds = ChemDataset(str(corpus), data_npz_path=str(tmp / "flat_corpus.npz"))
    ds.prefeaturize()
    cfg_c = CGRMPNNConfig(num_node_features=ds.num_node_features,
                          num_edge_features=ds.num_edge_features, depth=4,
                          hidden_sizes=(400,) * 4, dropout_ps=(0.1,) * 4,
                          fuse_whole_model=False)
    w_c = init_params(cfg_c, torch.Generator().manual_seed(seed), "cpu")
    loader = EPLoader(ds, n_ep=2, batch_size=64, n_dp=2, shuffle=True,
                      seed=seed)
    items = list(loader)
    seeds = torch.randint(0, 2**31 - 1, (len(items), 2, 2, 4),
                          dtype=torch.int32,
                          generator=torch.Generator().manual_seed(seed))
    losses, evals = {}, {}
    t0 = time.perf_counter()
    for tag, dev in (("card", DEVICE), ("cpu", "cpu")):
        m = _flat_model(cfg_c, w_c, dev)
        opt = torch.optim.Adam(m.parameters(), lr=1e-4)
        step = flat.make_ep_train_step(m)
        before = spmm_counts()
        losses[tag] = []
        with (NoPlainGathers() if tag == "card"
              else contextlib.nullcontext()):
            for i, item in enumerate(items):
                groups = [flat.flat_shards(type(item)(*(a[g] for a in item)),
                                           dev) for g in range(2)]
                losses[tag].append(float(step(groups, seeds[i])))
                opt.step()
        if tag == "card":
            torch.cuda.synchronize()
            moved_c = _moved(before)
        # the trained weights' predictions on the first item
        item = items[0]
        _, evals[tag] = flat.make_ep_eval_step(m)(
            [flat.flat_shards(type(item)(*(a[g] for a in item)), dev)
             for g in range(2)])
    plan_c = len(items) * 4 * flat.flat_launches(4, True)
    hold(out, "loader epoch preds vs CPU", evals["card"].cpu(), evals["cpu"])
    rel_c = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                    losses["cpu"]))
    check(moved_c[0] + moved_c[1] == plan_c and moved_c[2:] == (0, 0)
          and np.isfinite(losses["card"]).all() and rel_c <= TRAIN_TOL,
          f"EPLoader epoch on the corpus: card SSEs {losses['card']}, CPU "
          f"{losses['cpu']} (max rel {rel_c:.3e}, limit {TRAIN_TOL}); K7 "
          f"launches {moved_c}, plan {plan_c}")
    out["loader"] = dict(items=len(items), pins=loader.pins,
                         losses=losses["card"], rel=rel_c, launches=moved_c)
    print(f"flat EPLoader epoch on the corpus (n_dp 2, n_ep 2, bs 64, "
          f"README model at full width, dropout 0.1, Adam): {len(items)} "
          f"steps, pins {loader.pins}, card SSEs {losses['card']} against "
          f"the CPU's (max rel {rel_c:.3e}), the trained model's predictions "
          f"on the first item against the CPU's rel "
          f"{out['loader epoch preds vs CPU']['rel_err']:.3e}; K7 launches "
          f"{moved_c} (plan "
          f"{plan_c}); wall {time.perf_counter() - t0:.1f} s [{card}]")
    total = _moved(before_all)
    out["launches"] = total[0] + total[1]
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase wall: the flat edge-partition layout {out['wall_s']:.1f} "
          f"s; K7 launches {total} [{card}]")
    return out


def flat_wired_step(seed: int, device, save: Path | None = None) -> dict:
    """The flat layout on the wired set of ``wired_trainer`` (15 synthetic
    graphs and a 480-atom chain) with the README's model (dropout 0.1):
    one training step (seeds fixed) and one eval at n_ep 2, every shard in
    this process, or this rank's shard when a process group is up (one
    shard a rank).  Returns the SSEs, K7's launches and, with ``save``, the
    gradients written there."""
    import torch
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNNConfig, init_params
    from cgr_mpnn_3d_tpu_torch.parallel import edge_partition as flat
    from cgr_mpnn_3d_tpu_torch.parallel import multihost
    graphs, labels = ep_graphs(seed + 3, 15, (480,))
    cfg = CGRMPNNConfig(num_node_features=270, num_edge_features=14,
                        depth=4, hidden_sizes=(400,) * 4,
                        dropout_ps=(0.1,) * 4, fuse_whole_model=False)
    model = init_params(cfg, torch.Generator().manual_seed(seed), device)
    seeds = torch.tensor([[[11, 12, 13, 14], [21, 22, 23, 24]]],
                         dtype=torch.int32)
    shards = flat.flat_shards(flat.shard_edges(graphs, labels, 2), device)
    comm = None
    if multihost.world_size() > 1:
        comm = multihost.ep_comm(multihost.layout(1, 2))
        shards = [shards[comm.shard]]
        seeds = seeds[:, comm.shard:comm.shard + 1]
    before = spmm_counts()
    sse = flat.make_ep_train_step(model, comm)([shards], seeds)
    sse_eval, _ = flat.make_ep_eval_step(model, comm)([shards])
    torch.cuda.synchronize()
    res = dict(sse=float(sse), sse_eval=float(sse_eval),
               launches=_moved(before))
    if save is not None:
        np.savez(save, *[p.grad.detach().cpu().numpy()
                         for p in model.parameters()])
    return res


def sweep_phase(tmp: Path, seed: int, card: str) -> dict:
    """``cli/sweep.py`` and ``cli/runbook.py`` on the card: see item 24 of
    the module doc."""
    import torch
    from cgr_mpnn_3d_tpu_torch.cli import runbook, sweep
    t_phase = time.perf_counter()
    base = tmp / "sweep"
    data = training_data(base, seed)
    space = {"method": "bayes",
             "metric": {"name": "val_loss", "goal": "minimize"},
             "parameters": {
                 "name": {"value": "CGR-MPNN-3D"}, "depth": {"values": [4]},
                 "hidden_sizes": {"values": [[400]]},
                 "dropout_ps": {"values": [[0.1]]},
                 "lr": {"distribution": "log_uniform_values", "min": 1e-5,
                        "max": 1e-3},
                 "weight_decay": {"value": 1e-5},
                 "batch_size": {"values": [64]},
                 "gamma": {"distribution": "uniform", "min": 0.9,
                           "max": 1.0},
                 "learnable_skip": {"values": [True, False]},
                 "num_epochs": {"value": 1},
                 "data_path": {"value": str(data)},
                 "save_path": {"value": str(base / "saved")}}}
    moved, real = [], sweep._default_train_fn

    def counted(config, device="cuda"):
        before = launch_counters()
        try:
            return real(config, device=device)
        finally:
            torch.cuda.synchronize()
            after = launch_counters()
            moved.append({k: v - before[k] for k, v in after.items()
                          if v != before[k]})
    sweep._default_train_fn = counted
    try:
        trials = sweep.run_sweep(space, 2, base / "study.jsonl", seed=seed,
                                 device=DEVICE)
    finally:
        sweep._default_train_fn = real
    ranked = sweep.evaluate_sweep(base / "study.jsonl")
    k2 = [m.get("fused_model.train_launches", 0) for m in moved]
    check(len(trials) == 2 and all(t["status"] == "ok" for t in trials)
          and all(n > 0 for n in k2) and len(moved) == 2
          and all(np.isfinite(t["val_loss"]) for t in trials),
          f"sweep trials {[(t['status'], t.get('error')) for t in trials]}, "
          f"launches {moved}")
    out = dict(trials=[dict(config={k: v for k, v in t["config"].items()
                                    if k not in ("data_path", "save_path")},
                            val_loss=t["val_loss"]) for t in trials],
               launches=moved, best=ranked[0]["run_id"])
    print(f"sweep on the card: 2 bayes trials of 1 epoch on the corpus "
          f"(README model), every trial ok: "
          f"{[(round(t['val_loss'], 4), round(t['config']['lr'], 7)) for t in trials]} "
          f"(val RMSE, lr); launches a trial {moved} [{card}]")
    summary = base / "runbook.json"
    argv = ["--data_path", str(data), "--save_path", str(base / "rb"),
            "--epochs", "1", "--device", DEVICE, "--gate_cgr", "1000",
            "--gate_3d", "1000"]
    before = launch_counters()
    t0 = time.perf_counter()
    runbook.main(argv + ["--summary", str(summary)])
    torch.cuda.synchronize()
    after = launch_counters()
    s = json.loads(summary.read_text())
    check(s["all_passed"] is True
          and set(s["gates"]) == {"CGR", "CGR-MPNN-3D"}
          and all(np.isfinite(g["test_rmse_kcal_mol"])
                  for g in s["gates"].values()),
          f"runbook summary {s['gates']}")
    code = None
    try:
        runbook.main(argv + ["--skip_3d", "--gate_cgr", "0.0001",
                             "--summary", str(base / "runbook_fail.json")])
    except SystemExit as e:
        code = e.code
    fail = json.loads((base / "runbook_fail.json").read_text())
    check(code == 1 and fail["all_passed"] is False,
          f"runbook with a failing gate exited {code}")
    rb = {k: v - before[k] for k, v in after.items() if v != before[k]}
    out.update(runbook=dict(gates={k: g["test_rmse_kcal_mol"]
                                   for k, g in s["gates"].items()},
                            launches=rb, wall_s=time.perf_counter() - t0))
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"runbook on the card (1 epoch, README model at bf16, gates "
          f"overridden to 1000): test RMSE {out['runbook']['gates']}, "
          f"summary written; a failing gate exits {code}; launches of the "
          f"passing run {rb}; phase wall {out['wall_s']:.1f} s [{card}]")
    return out


TRACE_KERNEL = "fused_model_bwd_kernel"   # K2's __global__ in the trace


TRACE_SPANS = ("train.run", "train.epoch", "train.step", "model.grads",
               "ops.k2", "train.readback", "train.validate", "train.save")


def trace_job(job: dict) -> int:
    """``--trace_job``: ``train.profiler.trace`` around three staged epochs
    (``RxnGraphTrainer(reuse_packs=True, device_epoch=True)``, the README
    model on the 300-reaction corpus, bs 64; epoch 0 ran before, untraced)
    in this fresh process; prints TRACE_RESULT with the trace file, its K2
    kernel records, the K2 launches, the steps and the host records of the
    program's spans (``utils/tracing.py``) by name."""
    import torch
    from cgr_mpnn_3d_tpu_torch.data import ChemDataset, plan_spec
    from cgr_mpnn_3d_tpu_torch.data.descriptors import \
        synthetic_descriptors_npz
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNNConfig
    from cgr_mpnn_3d_tpu_torch.ops import fused_model as fm
    from cgr_mpnn_3d_tpu_torch.train import RxnGraphTrainer, trace
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = Path(job["dir"])
    corpus = ROOT / "tests" / "corpus_reactions.csv"
    synthetic_descriptors_npz(corpus, tmp / "corpus.npz", 64,
                              seed=job["seed"])
    ds = ChemDataset(str(corpus), data_npz_path=str(tmp / "corpus.npz"))
    ds.prefeaturize()
    cfg = CGRMPNNConfig(num_node_features=ds.num_node_features,
                        num_edge_features=ds.num_edge_features, depth=4,
                        hidden_sizes=(400,) * 4,
                        dropout_ps=(0.1,) * 4)
    tr = RxnGraphTrainer(
        name="trace", cfg=cfg, train_data=ds, val_data=ds,
        spec=plan_spec([ds.graph(i) for i in range(len(ds))]), lr=1e-4,
        num_epochs=1, batch_size=64, val_frequency=3, seed=job["seed"],
        model_save_dir=str(tmp / "saved"), device=DEVICE, reuse_packs=True,
        device_epoch=True)
    tr.train()
    steps, before = tr.step, fm.train_launches
    tr.start_epoch, tr.num_epochs = 1, 4
    with trace(str(tmp / "trace")):
        tr.train()
    launches = fm.train_launches - before
    files = sorted((tmp / "trace").glob("trace-*.json"))
    events = json.loads(files[0].read_text())["traceEvents"] if files else []
    k2 = [e for e in events if TRACE_KERNEL in str(e.get("name", ""))]
    spans = {n: sum(1 for e in events if e.get("name") == n
                    and e.get("cat") == "user_annotation")
             for n in TRACE_SPANS}
    print("TRACE_RESULT " + json.dumps(dict(
        files=[str(f) for f in files],
        bytes=files[0].stat().st_size if files else 0, events=len(events),
        k2_records=len(k2), k2_kernel_records=sum(
            1 for e in k2 if e.get("cat") == "kernel"),
        k2_ms=sum(float(e.get("dur", 0)) for e in k2
                  if e.get("cat") == "kernel") / 1e3,
        launches=launches, steps=tr.step - steps, spans=spans)), flush=True)
    return 0


def trace_phase(tmp: Path, seed: int, card: str) -> dict:
    """``train.profiler.trace`` around three staged epochs in a fresh
    process (a second profiler session in one process has lost the card's
    kernel records): the trace file exists and names K2 (its kernel's
    records, one a step), K2 ran once a step, and the program's spans are
    in it: ``train.step`` and ``ops.k2`` once a step, ``train.run`` once,
    ``train.epoch`` once an epoch."""
    t0 = time.perf_counter()
    job = dict(dir=str(tmp / "trace_job"), seed=seed)
    Path(job["dir"]).mkdir(parents=True, exist_ok=True)
    p = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                        "--trace_job", json.dumps(job)], cwd=str(ROOT),
                       capture_output=True, text=True, timeout=600)
    lines = [ln for ln in p.stdout.splitlines()
             if ln.startswith("TRACE_RESULT ")]
    check(p.returncode == 0 and len(lines) == 1,
          f"trace job exited {p.returncode}:\n{p.stdout[-3000:]}\n"
          f"{p.stderr[-3000:]}")
    res = json.loads(lines[0][len("TRACE_RESULT "):])
    n, sp = res["steps"], res["spans"]
    check(len(res["files"]) == 1 and n > 0 and res["k2_kernel_records"] == n
          and res["launches"] == n,
          f"trace: files {res['files']}, {n} steps, K2 kernel records "
          f"{res['k2_kernel_records']}, K2 launches {res['launches']} "
          f"(want one a step)")
    check(sp["train.step"] == sp["ops.k2"] == sp["model.grads"] == n
          and sp["train.run"] == 1 and sp["train.epoch"] == 3,
          f"trace: spans {sp} in {n} steps (want train.step, model.grads "
          f"and ops.k2 one a step, train.run once, train.epoch 3)")
    res["wall_s"] = time.perf_counter() - t0
    print(f"trace: train.profiler.trace around 3 staged epochs (README "
          f"model, corpus, {n} steps) in a fresh process wrote "
          f"{Path(res['files'][0]).name} ({res['bytes']} bytes, "
          f"{res['events']} events) naming K2 ({TRACE_KERNEL}) in "
          f"{res['k2_kernel_records']} kernel records, "
          f"{res['k2_ms']:.3f} ms of device time; K2 launches "
          f"{res['launches']}; spans {sp}; wall {res['wall_s']:.1f} s "
          f"[{card}]")
    return res


def print_ep_vs_single(k: dict, card: str) -> None:
    print(f"EP vs single device, n_ep {k['n_ep']} (caps {k['caps']}, "
          f"{k['p']} packs of te {k['te']} per shard, {k['graphs']} graphs): "
          f"preds rel err {k['preds']['rel_err']:.3e}, sse rel err "
          f"{k['sse']['rel_err']:.3e}, gradients L1 vs float64 "
          f"{k['grads']['l1_64'][0]:.3e} (plain {k['grads']['l1_64'][1]:.3e})"
          f"; launches {k['launches']} [{card}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--graphs", type=int, default=2500)
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--parent", type=Path, default=None,
                    help="csrc/ of an earlier commit's package (unpacked "
                         "whole with git archive, its ops/ beside): its "
                         "K3f, K5, K10/K11, conv layer (K6, K8/K9, K4), K7 "
                         "and K2 are held and timed beside the shipped "
                         "ones")
    ap.add_argument("--rank_job", default=None,
                    help="run one rank of multiprocess_phase (JSON; the "
                         "phase starts these itself)")
    ap.add_argument("--trace_job", default=None,
                    help="run trace_phase's traced steps (JSON; the phase "
                         "starts it itself)")
    ap.add_argument("--mace_only", action="store_true",
                    help="after the build, run mace_phase alone and print "
                         "its kernels line")
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
    if args.rank_job:
        return rank_job(json.loads(args.rank_job))
    if args.trace_job:
        return trace_job(json.loads(args.trace_job))

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: matmul False, cudnn False")
    if args.mace_only:
        with tempfile.TemporaryDirectory() as tmp:
            mc = mace_phase(Path(tmp), args.seed, args.repeats, card)
        print(json.dumps({"kernels": mace_entries(mc)}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    builds = start_variant_builds(args.parent)
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
    pool_ell = tuple(batch.graph_nodes.shape)   # K7's pool at this batch
    main_k = kernel_vs_plain(full, spec, batch, args.seed, args.repeats)
    print(f"fused_model_fwd full width: {main_k['graphs']} synthetic graphs "
          f"in {main_k['p']} packs, max abs err {main_k['abs_err']:.3e}, rel "
          f"{main_k['rel_err']:.3e}; kernel {main_k['ms']:.4f} ms, plain "
          f"{main_k['plain_ms']:.4f} ms, f32 bound {main_k['bound_ms']:.4f} "
          f"ms ({main_k['ops'] / 1e9:.3f} GFLOP, "
          f"{main_k['bytes'] / 1e6:.3f} MB) [{card}]")
    t0 = time.perf_counter()
    k3f_grid_phase(full, spec, batch, args.seed, args.repeats, builds, card,
                   "full width, synthetic")
    print(f"phase wall: K3f grid builds {time.perf_counter() - t0:.1f} s")
    full_train = dict(full, dropout_ps=(0.1,) * 4)
    train_k = train_kernels_vs_plain(full_train, spec, batch, args.seed,
                                     args.repeats)
    print_train_kernels("full width, dropout 0.1, synthetic", train_k, card)
    bf16_k = bf16_kernels_vs_plain(full_train, spec, batch, args.seed,
                                   args.repeats)
    print_bf16("full width, dropout 0.1, synthetic", bf16_k, card)
    k2_grid_phase(card)
    t0 = time.perf_counter()
    k2_phases_phase(card, builds["K2 stamped"])
    print(f"phase wall: tools/k2_phases.py {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    k3f_phases_phase(card, builds)
    print(f"phase wall: tools/k2_phases.py --forward "
          f"{time.perf_counter() - t0:.1f} s")
    for act in ("SiLU", "GELU"):
        k = train_kernels_vs_plain(dict(full_train, activation=act), spec,
                                   batch, args.seed, 0)
        print_train_kernels(f"full width {act}, dropout 0.1, synthetic", k,
                            card)
    lay_reps = max(1, args.repeats // 4)
    # the inputs of K5 and K10/K11, and of K7, where the main paths and the
    # kernel phases launch them, replayed beside the forced builds, the
    # plain versions and the parent's build at the end; those of the
    # kernels not redesigned here (K6, K8/K9, K4, K2/K3b) beside the
    # parent's
    glin_runs = {name: LaunchRecorder(GLIN_LAUNCHES, 24) for name in (
        "436 packs", "p = 4, corpus training batch", "wired batch",
        "layered training", "--ep 2 validation", "wired training runs")}
    glin_runs["layered serving"] = LaunchRecorder(GLIN_LAUNCHES, 12)
    spmm_runs = {name: LaunchRecorder(SPMM_LAUNCHES, 12) for name in (
        "436 packs", "p = 4, corpus training batch", "capture step",
        "layered serving", "layered training", "bench_ops", "profile_ep")}
    unmoved = LaunchRecorder(UNMOVED_LAUNCHES, 80)
    with glin_runs["436 packs"], spmm_runs["436 packs"]:
        lay_k = layered_kernels(full_train, spec, batch, args.seed, lay_reps)
    print_layered("full width, dropout 0.1, synthetic", lay_k, card)
    print_layered("layered vs whole-model, full width, dropout 0.1, "
                  "synthetic", layered_vs_whole(full_train, spec, batch,
                                                args.seed), card)
    conv_k = fused_conv_kernels(full_train, spec, batch, args.seed, lay_reps)
    print_capture("full width, dropout 0.1, synthetic", conv_k, card)
    cap = capture_vs_paths(full_train, spec, batch, args.seed, False,
                           lay_reps)
    print_capture("capture vs the other paths, full width, dropout 0.1, "
                  "synthetic", cap, card)
    what = "full width, dropout 0.1, synthetic"
    with glin_runs["436 packs"], spmm_runs["436 packs"]:
        lay_k16 = layered_kernels(full_train, spec, batch, args.seed,
                                  lay_reps, BF16)
        print_layered(what, lay_k16, card)
        conv_k16 = fused_conv_kernels(full_train, spec, batch, args.seed,
                                      lay_reps, BF16)
    print_capture(what, conv_k16, card)
    cap16 = capture_vs_paths(full_train, spec, batch, args.seed, False,
                             lay_reps, BF16)
    print_capture(f"bf16 capture vs plain, {what}", cap16, card)
    chain = act_chain_phase(full_train, spec, batch, args.seed, card)
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
        small_train = dict(small, dropout_ps=(0.1,) * 3)
        what = f"small width {act} mean/mean learnable skip, dropout 0.1"
        print_bf16(what, bf16_kernels_vs_plain(small_train, spec, batch,
                                               args.seed + 1, 0), card)
        print_layered(what, layered_kernels(small_train, spec, batch,
                                            args.seed + 1, 0), card)
        print_layered(f"layered vs whole-model, {what}", layered_vs_whole(
            small_train, spec, batch, args.seed + 1), card)
        print_capture(what, fused_conv_kernels(small_train, spec, batch,
                                               args.seed + 1, 0), card)
        print_capture(f"capture vs the other paths, {what}", capture_vs_paths(
            small_train, spec, batch, args.seed + 1, True), card)
        print_layered(what, layered_kernels(small_train, spec, batch,
                                            args.seed + 1, 0, BF16), card)
        print_capture(what, fused_conv_kernels(small_train, spec, batch,
                                               args.seed + 1, 0, BF16), card)
        print_capture(f"bf16 capture vs plain, {what}", capture_vs_paths(
            small_train, spec, batch, args.seed + 1, True, 0, BF16), card)
    for dtype in ("float32", BF16):
        print_capture("small width, GELU mean, dropout 0.2, skip 0.8",
                      fused_conv_hin(spec, batch, args.seed, dtype), card)

    with tempfile.TemporaryDirectory() as tmp:
        spec, batch = corpus_batch(Path(tmp), args.seed, dev)
        req_k = kernel_vs_plain(full, spec, batch, args.seed, args.repeats)
        print(f"fused_model_fwd request batch: {req_k['graphs']} corpus "
              f"reactions in {req_k['p']} packs, rel err "
              f"{req_k['rel_err']:.3e}; kernel {req_k['ms']:.4f} ms, plain "
              f"{req_k['plain_ms']:.4f} ms, f32 bound "
              f"{req_k['bound_ms']:.4f} ms [{card}]")
        k3f_grid_phase(full, spec, batch, args.seed, args.repeats, builds,
                       card, "request batch")
        print_bf16("request batch, full width, dropout 0.1",
                   bf16_kernels_vs_plain(full_train, spec, batch, args.seed,
                                         args.repeats), card)
        print_layered("layered vs whole-model, request batch",
                      layered_vs_whole(full, spec, batch, args.seed), card)
        with unmoved, spmm_runs["capture step"]:
            print_capture("capture vs the other paths, request batch",
                          capture_vs_paths(full, spec, batch, args.seed, True,
                                           args.repeats), card)
            print_capture("bf16 capture vs plain, request batch",
                          capture_vs_paths(full, spec, batch, args.seed, True,
                                           args.repeats, BF16), card)
        spec, batch = corpus_batch(Path(tmp), args.seed, dev, shuffle=True)
        with unmoved:
            k = train_kernels_vs_plain(full_train, spec, batch, args.seed,
                                       args.repeats)
        print_train_kernels("corpus training batch, full width, dropout 0.1",
                            k, card)
        print_bf16("corpus training batch, full width, dropout 0.1",
                   bf16_kernels_vs_plain(full_train, spec, batch, args.seed,
                                         args.repeats), card)
        with glin_runs["p = 4, corpus training batch"], unmoved, \
                spmm_runs["p = 4, corpus training batch"]:
            print_layered("corpus training batch, full width, dropout 0.1",
                          layered_kernels(full_train, spec, batch, args.seed,
                                          args.repeats), card)
        print_layered("layered vs whole-model, corpus training batch",
                      layered_vs_whole(full_train, spec, batch, args.seed),
                      card)
        with glin_runs["p = 4, corpus training batch"], unmoved:
            conv_p4 = fused_conv_kernels(full_train, spec, batch, args.seed,
                                         args.repeats)
            print_capture("corpus training batch, full width, dropout 0.1",
                          conv_p4, card)
            with spmm_runs["p = 4, corpus training batch"]:
                print_layered("corpus training batch, full width, dropout "
                              "0.1", layered_kernels(
                                  full_train, spec, batch, args.seed,
                                  args.repeats, BF16), card)
            print_capture("corpus training batch, full width, dropout 0.1",
                          fused_conv_kernels(full_train, spec, batch,
                                             args.seed, args.repeats, BF16),
                          card)
        t0 = time.perf_counter()
        native_phase(Path(tmp), args.seed, card)
        print(f"phase wall: native featurizer and packer "
              f"{time.perf_counter() - t0:.1f} s")
        srv = serve(Path(tmp), args.seed, card)
        t0 = time.perf_counter()
        serve_native(Path(tmp), srv, card)
        print(f"phase wall: serve native vs Python "
              f"{time.perf_counter() - t0:.1f} s")
        desc = descriptor_phase(Path(tmp), args.seed, srv["ckpt"], card)
        print(f"phase wall: the descriptor pipeline {desc['wall_s']:.1f} s")
        mc = mace_phase(Path(tmp), args.seed, args.repeats, card)
        print(f"phase wall: the MACE kernels {mc['wall_s']:.1f} s")
        with glin_runs["layered serving"], spmm_runs["layered serving"]:
            srv_l = serve_layered(Path(tmp), args.seed, card)
            srv_l16 = serve_layered(Path(tmp), args.seed, card, BF16)
        # the training CLI writes runs/, hyperparameter_study/ and a parity
        # plot into its working directory
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            trn = train_phase(Path(tmp), args.seed, card)
            t0 = time.perf_counter()
            train_modes_phase(Path(tmp), args.seed, card)
            print(f"phase wall: train with the loader's modes "
                  f"{time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            device_epoch_phase(Path(tmp), args.seed, card)
            print(f"phase wall: the trainer's device-resident modes "
                  f"{time.perf_counter() - t0:.1f} s")
            dp = dp_phase(Path(tmp), args.seed, card)
            print(f"phase wall: data parallelism "
                  f"{dp['wall_s']['phase']:.1f} s")
            mp = multiprocess_phase(Path(tmp), args.seed, card)
            print(f"phase wall: multi-process training "
                  f"{mp['wall_s']['phase']:.1f} s")
            sw = sweep_phase(Path(tmp), args.seed, card)
            tr = trace_phase(Path(tmp), args.seed, card)
            rates = train_profile(Path(tmp), args.seed, card)
            trn_16 = train_phase_bf16(Path(tmp), args.seed, card,
                                      trn["steps_per_s"])
            print(f"train step bf16 vs f32: {rates['bfloat16']:.2f} against "
                  f"{rates['float32']:.2f} steps/s "
                  f"({rates['bfloat16'] / rates['float32']:.3f}x) [{card}]")
            with glin_runs["layered training"], unmoved, \
                    spmm_runs["layered training"]:
                trn_l = train_layered(Path(tmp), args.seed, card)
                trn_l16 = train_layered(Path(tmp), args.seed, card, BF16,
                                        trn_l["rates"])
        finally:
            os.chdir(cwd)

    goldens_on_card(card)
    with spmm_runs["bench_ops"]:
        bench_ops_phase(card, args.seed)
    p2 = mm_probe_phase(args.seed, card)

    # edge partitioning: every shard of a step in this process
    with glin_runs["wired batch"], unmoved:
        ep_k = {2: ep_kernels(args.seed, lay_reps, 2)}
    ep_k[4] = ep_kernels(args.seed, lay_reps, 4)
    for n, k in ep_k.items():
        print_ep_kernels(f"full width, wired batch, n_ep {n}", k, card)
    for n in (2, 4):
        # 2,500 graphs and two 480-atom chains: LPT gives each chain whole
        # to a shard (neither holds 1/n_ep of the edges), so no cut
        print_ep_kernels(f"full width, 2,500 graphs + two 480-atom chains "
                         f"(zero cut), n_ep {n}", ep_kernels(
                             args.seed, lay_reps, n, 2500, (480, 480)), card)
    # a smaller wired batch here: K2's plain version in float64 gathers
    # [graphs, nodes of the largest graph, hidden] for the pooling
    wired = ep_graphs(args.seed, 50, (2400,))
    for n in (2, 4):
        print_ep_vs_single(ep_vs_single(args.seed, n, *wired), card)
    ep_step_times(args.seed, card)
    # EP at bf16, K6's linear activation, K12, --ep_rdma and --ep_overlap
    t0 = time.perf_counter()
    with glin_runs["wired batch"]:
        ep_k16 = ep_kernels(args.seed, lay_reps, 2, dtype=BF16)
    print_ep_kernels("full width, wired batch, n_ep 2", ep_k16, card)
    print(f"phase wall: bf16 K8-K11 and K6 linear "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    k12 = exchange_phase(args.seed, args.repeats, card)
    print(f"phase wall: K12 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ep_variants(args.seed, card)
    print(f"phase wall: EP step variants {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        flat_k = flat_ep_phase(Path(tmp), args.seed, card)
    t0 = time.perf_counter()
    with spmm_runs["profile_ep"]:
        prof = profile_ep_phase(card)
    print(f"phase wall: tools/profile_ep.py {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        training_data(Path(tmp), args.seed)
        with glin_runs["--ep 2 validation"]:
            ep_cli = ep_cli_phase(Path(tmp), args.seed, card)
            t0 = time.perf_counter()
            ep_cli16 = ep_cli_phase(Path(tmp), args.seed, card, BF16)
        print(f"phase wall: --ep 2 --compute_dtype bfloat16 CLI "
              f"{time.perf_counter() - t0:.1f} s")
        with glin_runs["wired training runs"], unmoved:
            ep_wired = ep_train_wired(Path(tmp), args.seed, card)
    t0 = time.perf_counter()
    for label, rec in glin_runs.items():
        held_beside_parent({label: rec}, builds, lay_reps
                           if label == "436 packs" else args.repeats, card,
                           args.parent, glin=True)
    print(f"phase wall: K5 and K10/K11 at the recorded shapes, beside their "
          f"forced builds, plain versions and the parent's "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    glin_phases_phase(card, builds, args.parent)
    print(f"phase wall: tools/glin_phases.py --probe "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    held_beside_parent({"unmoved": unmoved}, builds, args.repeats, card,
                       args.parent)
    print(f"phase wall: K6, K8/K9, K4 and K2/K3b beside the parent's "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    spmm_k = spmm_held(spmm_runs, builds, args.repeats, card, args.parent)
    check(any(e["row_bytes"] % 16 for e in spmm_k.values()),
          "no recorded K7 launch has rows whose bytes are not a multiple "
          "of 16")
    k7_host_phase(card, args.parent)
    print(f"phase wall: K7 at the recorded shapes ({len(spmm_k)}), beside "
          f"its forced builds, plain version and the parent's, and "
          f"tools/k7_host.py {time.perf_counter() - t0:.1f} s")
    print(f"train steps/s per epoch (StepTimer), README model on the corpus:"
          f" --ep 2 {ep_cli['steps_per_s']}, at bf16 "
          f"{ep_cli16['steps_per_s']}, against the single-device run's "
          f"{trn['steps_per_s']} [{card}]")
    ep_runs = [ep_cli["launches"], ep_cli16["launches"],
               *(run["launches"] for run in ep_wired.values())]
    ep_launches = {k: sum(sum(run[k]) for run in ep_runs)
                   for k in ("K8", "K9", "K10", "K11", "K8 bf16", "K9 bf16",
                             "K11 bf16", "K6 linear", "K12")}

    def kernel(name, cu, replaces, launches, k):
        return {"name": name, "route": "cuda",
                "source": f"cgr_mpnn_3d_tpu_torch/csrc/{cu}",
                "replaces": (replaces if "/" in replaces
                             else f"cgr_mpnn_3d_tpu/ops/{replaces}"),
                "launches": launches, "max_abs_err": k["abs_err"],
                "ms": k["ms"], "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                "library_ms": k.get("library_ms")}

    def glin(lay: dict, bf16: bool) -> dict:
        """K5's entry: its two calls of one layered forward (edge_init and
        readout) together, the bound of their summed work."""
        a, b = lay["K5 edge_init fwd"], lay["K5 readout fwd"]
        bound_ms, bound_by = bound((a["ops"] + b["ops"], 0.0,
                                    a["bytes"] + b["bytes"]), bf16)
        return dict(abs_err=max(a["abs_err"], b["abs_err"]),
                    ms=a["ms"] + b["ms"],
                    plain_ms=a["plain_ms"] + b["plain_ms"],
                    bound_ms=bound_ms, bound_by=bound_by)

    def pool(lay: dict, md: str) -> dict:
        """K7's entry: the pool forward of layered_kernels (errors, bound,
        plain and embedding_bag times), its ms the replay's call by CUDA
        events at this batch (spmm_held: alternating rounds of
        ``--repeats`` calls, no recorder active)."""
        e = next(e for e in spmm_k.values() if e["label"] == "436 packs"
                 and e["dtype"] == md and (e["rows"], e["D"]) == pool_ell)
        return dict(lay["K7 pool fwd"], ms=e["call_ms"]["shipped"])

    def lay_launches(srv_run: dict, trn_run: dict) -> dict:
        return {key: srv_run["launches"][key] + sum(trn_run["launches"][key])
                for key in ("K5", "K4", "K7")}
    lay32, lay16 = lay_launches(srv_l, trn_l), lay_launches(srv_l16, trn_l16)
    # the data-parallel runs' launches (dp_phase), added to each kernel's
    dp32, dp16 = dp["cli_f32"]["launches"], dp["cli_bf16"]["launches"]
    dp_lay = dp["layered_launches"]
    dp_layered = {k: sum(v for c, v in dp_lay.items()
                       if c.startswith(m) and "bf16" not in c)
                for k, m in (("K5", "gather_linear"), ("K4", "conv_stack"),
                             ("K7", "onehot_spmm"))}
    dp_ep = {k: sum(sum(run["launches"].get(k, (0, 0)))
                    for run in dp["dp_ep"].values())
             for k in ("K8", "K9", "K11")}

    def mp_launches(run: str, *counters: str) -> int:
        """The ranks' launches of ``counters`` in one multi-process run."""
        return sum(moved.get(c, 0) for moved in mp["runs"][run]["launches"]
                   for c in counters)
    mp_k2 = mp_launches("dp2_f32", "fused_model.train_launches")
    mp_k3f = mp_launches("dp2_f32", "fused_model.launches")
    mp_k2_16 = mp_launches("dp2_bf16_device_epoch",
                           "fused_model.bf16_train_launches")
    mp_k3f_16 = mp_launches("dp2_bf16_device_epoch",
                            "fused_model.bf16_launches")
    mp_k5 = mp_launches("wired_ep2", "gather_linear.launches",
                        "gather_linear.bwd_launches")
    mp_k8 = mp_launches("wired_ep2", "fused_conv.r_launches",
                        "fused_conv.r_bwd_launches")
    mp_k11 = mp_launches("wired_ep2", "gather_linear.pool_launches",
                         "gather_linear.pool_bwd_launches")
    mp_k7 = mp_launches("flat_ep2", "onehot_spmm.launches",
                        "onehot_spmm.bwd_launches")
    mp_k12 = mp_launches("wired_ep2_rdma", "rdma_exchange.rank_launches",
                         "rdma_exchange.rank_bwd_launches")
    # the cross-rank K12's entry: the 2-rank f32 case at the main path's
    # wire (TW 8, H 400), rank 0's times; no library call runs here (NCCL
    # takes no two ranks on one device)
    k12r = mp["runs"]["k12_ranks"][2]["ranks"][0]["cases"]["(8,) float32"]
    k12r_bound = bound((0.0, 0.0, float(k12r["bytes"])), False)
    k12_ranks = dict(abs_err=k12r["max_abs_err"], ms=k12r["rank_k12_ms"],
                     plain_ms=k12r["gloo_ms"], bound_ms=k12r_bound[0],
                     bound_by=k12r_bound[1], library_ms=None)

    def sw_launches(*counters: str) -> int:
        """The sweep's trials' and the runbook's launches of ``counters``."""
        return sum(m.get(c, 0) for m in sw["launches"]
                   + [sw["runbook"]["launches"]] for c in counters)
    sw_k2, sw_k3f = (sw_launches("fused_model.train_launches"),
                     sw_launches("fused_model.launches"))
    sw_k2_16, sw_k3f_16 = (sw_launches("fused_model.bf16_train_launches"),
                           sw_launches("fused_model.bf16_launches"))
    print(json.dumps({"kernels": [
        kernel("fused_model_fwd", "fused_model_fwd.cu", "pallas_model.py:376",
               srv["launches"] + desc["launches"] + mc["launches"]["K3f"]
               + dp32["fused_model.launches"] + mp_k3f + sw_k3f,
               main_k),
        kernel("fused_model_train", "fused_model_bwd.cu",
               "pallas_model.py:439", trn["launches"]["train"]
               + dp32["fused_model.train_launches"] + mp_k2 + sw_k2
               + tr["launches"], train_k["train"]),
        kernel("fused_model_vjp", "fused_model_bwd.cu", "pallas_model.py:397",
               trn["launches"]["vjp"], train_k["vjp"]),
        kernel("conv_stack", "conv_stack.cu", "pallas_stack.py:177",
               lay32["K4"] + dp_layered["K4"], lay_k["K4 fwd eval"]),
        kernel("gather_linear", "gather_linear.cu", "pallas_glin.py:160",
               lay32["K5"] + dp_layered["K5"] + mp_k5, glin(lay_k, False)),
        kernel("onehot_spmm", "onehot_spmm.cu", "pallas_ops.py:93",
               lay32["K7"] + dp_layered["K7"] + flat_k["launches"]
               + mp_k7, pool(lay_k, "float32")),
        kernel("fused_conv", "fused_conv.cu", "pallas_fused.py:330",
               sum(cap["launches"]["K6"]), conv_k["K6 fwd eval"]),
        kernel("act_chain", "act_chain.cu", "tools/gelu_roofline.py:66",
               chain["launches"], chain["entry"]),
        kernel("fused_model_fwd_bf16", "fused_model_fwd.cu",
               "pallas_model.py:376", trn_16["launches"]["fwd"]
               + dp16["fused_model.bf16_launches"] + mp_k3f_16
               + sw_k3f_16, bf16_k["fwd"]),
        kernel("fused_model_train_bf16", "fused_model_bwd.cu",
               "pallas_model.py:439", trn_16["launches"]["train"]
               + dp16["fused_model.bf16_train_launches"] + mp_k2_16
               + sw_k2_16, bf16_k["train"]),
        kernel("fused_model_vjp_bf16", "fused_model_bwd.cu",
               "pallas_model.py:397", trn_16["launches"]["vjp"],
               bf16_k["vjp"]),
        kernel("conv_stack_bf16", "conv_stack.cu", "pallas_stack.py:177",
               lay16["K4"], lay_k16["K4 fwd eval"]),
        kernel("gather_linear_bf16", "gather_linear.cu", "pallas_glin.py:160",
               lay16["K5"], glin(lay_k16, True)),
        kernel("onehot_spmm_bf16", "onehot_spmm.cu", "pallas_ops.py:93",
               lay16["K7"], pool(lay_k16, BF16)),
        kernel("fused_conv_bf16", "fused_conv.cu", "pallas_fused.py:330",
               sum(cap16["launches"]["K6"]), conv_k16["K6 fwd eval"]),
        kernel("mm_probe", "mm_probe.cu", "tools/int8_microbench.py:72",
               p2["launches"], p2["entry"]),
        kernel("mm_probe_transpose_s8", "mm_probe.cu",
               "tools/int8_microbench.py:72", p2["transpose_launches"],
               p2["transpose"]),
        kernel("fused_conv_r", "fused_conv.cu", "pallas_fused.py:555",
               ep_launches["K8"] + dp_ep["K8"] + mp_k8, ep_k[2]["K8 fwd"]),
        kernel("fused_conv_rm", "fused_conv.cu", "pallas_fused.py:686",
               ep_launches["K9"] + dp_ep["K9"], ep_k[2]["K9 fwd"]),
        kernel("gather_linear_r", "gather_linear.cu", "pallas_glin.py:306",
               ep_launches["K10"], ep_k[2]["K10 fwd"]),
        kernel("gather_linear_pool", "gather_linear.cu", "pallas_glin.py:491",
               ep_launches["K11"] + dp_ep["K11"] + mp_k11,
               ep_k[2]["K11 fwd"]),
        kernel("fused_conv_r_bf16", "fused_conv.cu", "pallas_fused.py:555",
               ep_launches["K8 bf16"], ep_k16["K8 fwd"]),
        kernel("fused_conv_rm_bf16", "fused_conv.cu", "pallas_fused.py:686",
               ep_launches["K9 bf16"], ep_k16["K9 fwd"]),
        kernel("gather_linear_r_bf16", "gather_linear.cu",
               "pallas_glin.py:306", prof["launches"], ep_k16["K10 fwd"]),
        kernel("gather_linear_pool_bf16", "gather_linear.cu",
               "pallas_glin.py:491", ep_launches["K11 bf16"],
               ep_k16["K11 fwd"]),
        kernel("fused_conv_linear", "fused_conv.cu", "pallas_fused.py:330",
               ep_launches["K6 linear"], ep_k[2]["K6 linear fwd"]),
        kernel("ring_exchange", "ring_exchange.cu",
               "cgr_mpnn_3d_tpu/parallel/rdma_exchange.py:99",
               ep_launches["K12"], k12["n_ep 2 float32"]),
        kernel("ring_exchange_ranks", "rank_exchange.cu",
               "cgr_mpnn_3d_tpu/parallel/rdma_exchange.py:99", mp_k12,
               k12_ranks), *mace_entries(mc)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
