"""Where the conv layer's cooperative grid (``csrc/conv_grid.cuh``, run by
K6 and K8/K9 in ``csrc/fused_conv.cu``) spends its time, phase by phase.

The tool builds ``csrc/fused_conv.cu`` under ``build/k2_phases/`` with the
define ``CGR_PHASE_CLOCK``: thread 0 of block 0 stamps ``%globaltimer``
after each grid barrier (k2_phases.py's clock), so a phase's time is the
card's, every block included.  The phases (``PHASES``, by the id the
source stamps):

    messages          t = messages(h) [+ r at the senders], the rows' scales
                      (and, at bf16, W rounded to bf16)
    pre-activations   backward, SiLU and GELU: the recomputed pre tiles
    dpre              backward: dpre, dh0 and the 264 dskip partials
    products          backward: dW's split-K partial tiles, dt = dpre·Wᵀ,
                      db's column partials
    product           forward: t·W + b (+ skip·h0), act, dropout
    sums + adjoint    backward: dW, db, dskip in partial order; dh (and
                      K8/K9's dr) by the adjoint gathers

It times K6 (ReLU, train mode, dropout 0.1, width 400) on ``--small``
synthetic graphs (p = 4 packs) and ``--graphs`` graphs (436 packs) of the
README model's layout, and K8 on the most wired shard of the wired batch
(a 9,600-atom chain and 200 graphs at n_ep 2) and of the wired training
runs' layout (a 480-atom chain and 7 graphs), forward and backward, at
f32 and bf16.  The stamped build's outputs must equal the shipped build's
bit for bit.  It prints, per case, the median over ``--repeats`` calls of
each phase's ms and of the whole stamped span.

``--probe`` times, at p = 4, the forward's product phase as block 0 sees
it (its own tiles, before the barrier) through the stamped build and two
probe builds of the tile: without its copies (``CGR_TILE_NO_LOAD``) and
without its products (``CGR_TILE_NO_FMA``).  Their results are wrong by
design; only their times are read.

  python -m cgr_mpnn_3d_tpu_torch.tools.conv_phases [--small 20]
      [--graphs 2500] [--repeats 5] [--probe]

Needs the card and nvcc.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess

import numpy as np
import torch

from .k2_phases import DEFINE, read_stamps, variant

__all__ = ["main", "PHASES"]

# the stamp ids of csrc/conv_grid.cuh (the stamp's layer field)
PHASES = {1: "messages", 2: "pre-activations", 3: "bf16 copies", 4: "dpre",
          5: "products", 9: "end"}
_BLOCK0 = 8   # block 0's own product tiles done (forward)
H = 400


def _rand(gen, dev, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen) * scale).to(dev).to(dtype)


def _conv_case(n_graphs: int, seed: int, dev, mat_dtype: str):
    """(label, forward, backward) of K6 on a synthetic batch."""
    from ..data import (pack_graphs, packs_needed, place_graphs, plan_spec,
                        to_device)
    from ..data.synthetic import synthetic_graphs
    from ..ops import fused_conv as fc
    graphs = synthetic_graphs(n_graphs, np.random.default_rng(seed),
                              node_feat_dim=270, edge_feat_dim=14)
    spec = plan_spec(graphs, te=256, tn=128, tb=16)
    p = packs_needed(graphs, spec)
    while not place_graphs(graphs, spec.with_packs(p)):
        p += max(1, p // 20)
    spec = spec.with_packs(p)
    b = to_device(pack_graphs(graphs, [0.0] * n_graphs, spec), dev)
    gen = torch.Generator().manual_seed(seed)
    sd = torch.bfloat16 if mat_dtype == "bfloat16" else torch.float32
    ET = b.edge_nbr.shape[0]
    h = _rand(gen, dev, ET, H).relu().to(sd)
    h0 = _rand(gen, dev, ET, H, dtype=sd)
    w, bias = _rand(gen, dev, H, H, scale=H ** -0.5), _rand(gen, dev, H)
    skip = torch.tensor(0.7, device=dev)
    g = _rand(gen, dev, ET, H, dtype=sd)
    kw = dict(p=p, act="relu", train=True, seed=5, dropout_p=0.1,
              mat_dtype=mat_dtype)
    ins = (h, h0, b.edge_nbr, b.rev, w, bias, skip)
    with torch.no_grad():
        y = fc.fused_conv_forward(*ins, **kw)
    return (f"K6 {mat_dtype} p={p}",
            lambda: fc.fused_conv_forward(*ins, **kw),
            lambda: fc.fused_conv_backward(h, h0, b.edge_nbr, b.rev,
                                           b.edge_nbr_rev, w, bias, skip, y,
                                           g, **kw))


def _wired_case(chain: int, n_graphs: int, seed: int, dev, mat_dtype: str):
    """(label, forward, backward) of K8 on the most wired shard of a chain
    and synthetic graphs cut at n_ep 2 (te 128 / tn 72, grown to the
    chain's fragment)."""
    from ..data.synthetic import chain_graph, synthetic_graphs
    from ..ops import fused_conv as fc
    from ..parallel import ep_shards, pack_shard_edges
    rng = np.random.default_rng(seed)
    graphs = synthetic_graphs(n_graphs, rng, node_feat_dim=270) + [
        chain_graph(chain, rng, 270)]
    host, spec = pack_shard_edges(graphs, [0.0] * len(graphs), 2, te=128,
                                  tn=72)
    e = max(ep_shards(host, dev), key=lambda s: float(s.halo_mask.sum()))
    gen = torch.Generator().manual_seed(seed)
    sd = torch.bfloat16 if mat_dtype == "bfloat16" else torch.float32
    h = _rand(gen, dev, spec.pe, H).relu().to(sd)
    h0 = _rand(gen, dev, spec.pe, H).relu().to(sd)
    r = _rand(gen, dev, spec.pn, H, scale=0.5)
    w, bias = _rand(gen, dev, H, H, scale=H ** -0.5), _rand(gen, dev, H)
    skip = torch.tensor(1.0, device=dev)
    g = _rand(gen, dev, spec.pe, H, dtype=sd)
    conv = (h, r, h0, e.edge_nbr, e.rev, e.senders, w, bias, skip)
    kw = dict(p=spec.p, tn=spec.tn, train=True, seed=77, dropout_p=0.1,
              mat_dtype=mat_dtype)
    with torch.no_grad():
        y = fc.fused_conv_r_forward(*conv, **kw)
    bwd = (h, r, h0, e.edge_nbr, e.rev, e.senders, e.edge_nbr_rev,
           e.node_out, w, bias, skip, y, g)
    return (f"K8 {mat_dtype} {spec.pe} rows",
            lambda: fc.fused_conv_r_forward(*conv, **kw),
            lambda: fc.fused_conv_r_backward(*bwd, **kw))


def _through(lib, fn, name: str = "fused_conv"):
    """fn() under no_grad with ``lib`` as the library of csrc/<name>.cu."""
    from ..ops import _build
    shipped = _build.load(name)
    _build._libs[name] = lib
    try:
        with torch.no_grad():
            return fn()
    finally:
        _build._libs[name] = shipped


def _equal(a, b) -> bool:
    a = a if isinstance(a, (tuple, list)) else [a]
    b = b if isinstance(b, (tuple, list)) else [b]
    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(a, b))


def _stamps(lib, fn, repeats: int, name: str = "fused_conv") -> list[dict]:
    """{phase id: ms since the launch's start} of ``repeats`` calls."""
    runs = []
    for _ in range(repeats):
        _through(lib, fn, name)
        torch.cuda.synchronize()
        st = read_stamps(lib)
        t0 = st[0][2]
        runs.append({layer: (t - t0) / 1e6 for _, layer, t in st[1:]})
    return runs


def phases_of(lib, fn, repeats: int) -> dict:
    """{phase: median ms} (each from the stamp before it) and "span" of a
    stamped build's call."""
    runs = _stamps(lib, fn, repeats)
    ids = sorted(i for i in runs[0] if i != _BLOCK0)
    per = [{PHASES[i]: r[i] - (r[ids[k - 1]] if k else 0.0)
            for k, i in enumerate(ids)} for r in runs]
    out = {k: statistics.median(p[k] for p in per) for k in per[0]}
    out["span"] = statistics.median(r[9] for r in runs)
    return out


def main(argv=None) -> dict:
    """Time the phases; returns {"<case> fwd|bwd": {phase: ms}} and, with
    ``--probe``, {"probe <dtype> <build>": block 0's product ms}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", type=int, default=20)
    ap.add_argument("--graphs", type=int, default=2500)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--probe", action="store_true")
    args = ap.parse_args(argv)

    from ..ops import _build
    from ..utils.device import resolve_device
    dev = resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    src = _build.CSRC / "fused_conv.cu"
    stamped = variant({DEFINE: None}, src)
    out: dict = {}
    for md in ("float32", "bfloat16"):
        cases = [_conv_case(args.small, args.seed + 1, dev, md),
                 _conv_case(args.graphs, args.seed, dev, md),
                 _wired_case(9600, 200, args.seed, dev, md),
                 _wired_case(480, 7, args.seed + 3, dev, md)]
        for label, fwd, bwd in cases:
            for way, fn in (("fwd", fwd), ("bwd", bwd)):
                with torch.no_grad():
                    want = fn()
                if not _equal(_through(stamped, fn), want):
                    raise RuntimeError(f"{label} {way}: the stamped build "
                                       f"differs from the shipped one")
                res = phases_of(stamped, fn, args.repeats)
                if way == "fwd":
                    res["product"] = res.pop("end")
                else:
                    res["sums + adjoint"] = res.pop("end")
                out[f"{label} {way}"] = res
                print(f"conv_phases {label} {way}: span {res['span']:.4f} ms; "
                      + "; ".join(f"{k} {v:.4f}" for k, v in res.items()
                                  if k != "span"), flush=True)
        del cases
    if args.probe:
        builds = {"shipped": stamped,
                  "no copies": variant({DEFINE: None,
                                        "CGR_TILE_NO_LOAD": None}, src),
                  "no products": variant({DEFINE: None,
                                          "CGR_TILE_NO_FMA": None}, src)}
        for md in ("float32", "bfloat16"):
            label, fwd, _ = _conv_case(args.small, args.seed + 1, dev, md)
            for name, lib in builds.items():
                runs = _stamps(lib, fwd, args.repeats)
                ms = statistics.median(r[_BLOCK0] - r[1] for r in runs)
                out[f"probe {md} {name}"] = ms
                print(f"conv_phases probe {label} fwd, block 0's product "
                      f"tiles through the {name} build: {ms:.4f} ms",
                      flush=True)
    return out


if __name__ == "__main__":
    main()
