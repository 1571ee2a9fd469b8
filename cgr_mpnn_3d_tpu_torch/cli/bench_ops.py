"""Kernel microbenchmarks: time each hot op against the card's dense-matmul
anchor to see where the step time goes.

  python -m cgr_mpnn_3d_tpu_torch.cli.bench_ops [--graphs N] [--hidden H] [--cpu]

The counterpart of ``cgr_mpnn_3d_tpu/cli/bench_ops.py``, with its flags, its
synthetic batch (``synthetic_graphs(N)`` packed at te=512, tn=256, tb=32
into ``packs_needed(fill_target=0.92)`` packs) and its result lines:

    dense_matmul[ET,H]x[H,H]   torch.matmul of bf16 h and w, the library
                               anchor
    xla_gather_messages        the plain dmpnn_messages of h cast to f32
    pallas_onehot_messages     the ELL gather-sum (K7) with the rev sign, at
                               mat_dtype bf16 on bf16 h (f32 out)
    fused_conv_fwd             the per-layer conv kernel (K6) at bf16 on
                               bf16 h, h0 (bf16 out)
    fused_conv_fwd+bwd         K6 forward, then backward (autograd on dh, dh0)
    model_fwd                  apply through the whole-model kernel (K3f),
                               bf16 compute
    model_fwd+bwd              the same, backward through the VJP kernel (K3b)
    optimizer_update           the trainer's Adam(amsgrad=True) step

Deviations from the JAX module:

* every row runs at the JAX module's type: bf16 for the anchor, K7, K6
  and the model rows (``compute_dtype="bfloat16"``, the whole-model
  kernels' bf16 instantiation), f32 for the plain gather and Adam (TF32
  off).  The header line lists the dtype of each row and every line ends
  with its own;
* no ``build_indices`` line: the port gathers through the packer's ELL
  arrays and builds no index rows;
* timing by CUDA events, not a ``lax.scan``: after a warm-up call, a loop of
  ``scan_len`` calls between two events, the best of ``repeats`` (the scan
  works around a TPU runtime's caching, which the card does not have);
* work counts are the port's own: K6's is ``2·E·Hin·H`` multiply-adds plus
  the gather's ``E·(D+1)·Hin`` adds over the E real edges (the JAX module
  counts the TPU's one-hot product, ``2·ET·(te·H + H·H)``), and the TF/s
  divides that;
* where best-fit leaves a graph over at 0.92 fill, the pack count grows
  until every graph is placed;
* ``--cpu`` runs the plain versions, at whatever size is asked.

Calls under about 0.1 ms measure the host's launch rate as much as the
card; their lines say so.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

__all__ = ["main", "parser", "bench_batch", "conv_inputs", "model_kw",
           "DTYPES"]

# the operand type of every line (the JAX module's)
DTYPES = {"dense_matmul[ET,H]x[H,H]": "bfloat16",
          "xla_gather_messages": "float32",
          "pallas_onehot_messages": "bfloat16",
          "fused_conv_fwd": "bfloat16", "fused_conv_fwd+bwd": "bfloat16",
          "model_fwd": "bfloat16", "model_fwd+bwd": "bfloat16",
          "optimizer_update": "float32"}


def bench_batch(n_graphs: int, device):
    """The benchmark's batch: ``synthetic_graphs(n_graphs)`` (seed 0)
    packed at te=512, tn=256, tb=32 into ``packs_needed(fill_target=0.92)``
    packs, more where best-fit leaves a graph over -> (spec, batch on
    ``device``, real edges)."""
    from ..data import (pack_graphs, packs_needed, place_graphs, plan_spec,
                        to_device)
    from ..data.synthetic import synthetic_graphs
    graphs = synthetic_graphs(n_graphs, np.random.default_rng(0))
    spec = plan_spec(graphs, te=512, tn=256, tb=32)
    p = packs_needed(graphs, spec, fill_target=0.92)
    while not place_graphs(graphs, spec.with_packs(p)):
        p += 1
    spec = spec.with_packs(p)
    batch = to_device(pack_graphs(graphs, [0.0] * len(graphs), spec), device)
    return spec, batch, sum(g.num_edges for g in graphs)


def conv_inputs(spec, H: int, device) -> tuple:
    """Seeded inputs of one conv layer on the benchmark's batch: (h, h0)
    [ET, H] bf16 and (w [H, H], b [H], skip = 1) f32."""
    gen = torch.Generator().manual_seed(0)
    ET = spec.total_edges
    h = torch.randn((ET, H), generator=gen).bfloat16().to(device)
    h0 = torch.randn((ET, H), generator=gen).bfloat16().to(device)
    w = (torch.randn((H, H), generator=gen) * 0.05).to(device)
    return (h, h0), (w, torch.zeros(H, device=device),
                     torch.ones((), device=device))


def model_kw(H: int) -> dict:
    """The benchmark model's CGRMPNNConfig fields at hidden width H."""
    return dict(num_node_features=78, num_edge_features=14, depth=4,
                hidden_sizes=(H,) * 4, dropout_ps=(0.0,) * 4)


def _time(fn, device, repeats: int = 3, scan_len: int = 16) -> float:
    """Seconds per call of ``fn``: the best of ``repeats`` loops of
    ``scan_len`` calls, after one warm-up call; CUDA events on the card,
    the host clock on the CPU."""
    fn()
    best = float("inf")
    cuda = device.type == "cuda"
    for _ in range(repeats):
        if cuda:
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(scan_len):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            t = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(scan_len):
                fn()
            t = time.perf_counter() - t0
        best = min(best, t / scan_len)
    return best


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--graphs", type=int, default=2500)
    ap.add_argument("--hidden", type=int, default=400)
    ap.add_argument("--cpu", action="store_true")
    return ap


def main(argv=None, repeats: int = 3) -> dict:
    """Run the benchmark; returns {line name: (seconds per call, TF/s or
    None)} and prints one line per op."""
    args = parser().parse_args(argv)

    from ..models import CGRMPNNConfig, apply, init_params
    from ..ops.fused_conv import fused_conv_layer
    from ..ops.onehot_spmm import spmm
    from ..ops.segment import dmpnn_messages
    from ..utils.device import resolve_device

    dev = resolve_device("cpu" if args.cpu else "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    H = args.hidden
    spec, batch, n_real = bench_batch(args.graphs, dev)
    ET = spec.total_edges
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={kind} packs={spec.p} ET={ET} real_edges={n_real} "
          f"dtypes: {', '.join(f'{k}={v}' for k, v in DTYPES.items())}",
          file=sys.stderr)

    (h, h0), (w, b, one) = conv_inputs(spec, H, dev)
    norm = torch.ones(ET, device=dev)
    D = batch.edge_nbr.shape[1]
    msg = (batch.edge_nbr, batch.rev)
    conv = dict(p=spec.p, mat_dtype=DTYPES["fused_conv_fwd"])

    def timed(fn):
        return _time(fn, dev, repeats)

    results = {}
    with torch.no_grad():
        # library anchor: a dense product of the size of one conv layer
        w16 = w.bfloat16()
        t = timed(lambda: torch.matmul(h, w16))
        results["dense_matmul[ET,H]x[H,H]"] = (t, 2 * ET * H * H / t / 1e12)
        results["xla_gather_messages"] = (
            timed(lambda: dmpnn_messages(h.float(), *msg, norm)), None)
        results["pallas_onehot_messages"] = (
            timed(lambda: spmm(h, batch.edge_nbr, batch.edge_nbr_rev,
                               batch.rev, batch.rev, p=spec.p,
                               mat_dtype=DTYPES["pallas_onehot_messages"])),
            None)
        t = timed(lambda: fused_conv_layer(h, h0, *msg, batch.edge_nbr_rev,
                                           w, b, one, **conv))
        work = 2 * n_real * H * H + n_real * (D + 1) * H
        results["fused_conv_fwd"] = (t, work / t / 1e12)

    hg, h0g = h.clone().requires_grad_(), h0.clone().requires_grad_()

    def conv_fwd_bwd():
        out = fused_conv_layer(hg, h0g, *msg, batch.edge_nbr_rev, w, b, one,
                               **conv)
        return torch.autograd.grad(out.float().sum(), (hg, h0g))
    t = timed(conv_fwd_bwd)
    results["fused_conv_fwd+bwd"] = (t, 3 * work / t / 1e12)

    # full-model pieces, bf16 compute as in the JAX module
    cfg = CGRMPNNConfig(**model_kw(H), compute_dtype=DTYPES["model_fwd"])
    model = init_params(cfg, torch.Generator().manual_seed(0), dev)
    with torch.no_grad():
        results["model_fwd"] = (timed(lambda: apply(model, batch, spec).sum()),
                                None)

    def fwd_bwd():
        model.zero_grad(set_to_none=True)
        apply(model, batch, spec).sum().backward()
    results["model_fwd+bwd"] = (timed(fwd_bwd), None)

    fwd_bwd()
    opt = torch.optim.Adam(model.parameters(), lr=1e-4, weight_decay=0.0,
                           amsgrad=True)
    results["optimizer_update"] = (timed(opt.step), None)

    for name, (t, tf) in results.items():
        extra = f"  {tf:.1f} TF/s" if tf else ""
        host = "  [under 0.1 ms: the host's launch rate]" if t < 1e-4 else ""
        print(f"{name:32s} {t * 1e3:8.3f} ms{extra}  "
              f"({n_real / t / 1e6:8.1f} Medge/s-equiv) {DTYPES[name]}"
              f"{host}")
    return results


if __name__ == "__main__":
    main()
