"""Where the gather-linear's cooperative grid (``csrc/gather_linear.cu``:
K5, and K10/K11 through the same kernels) spends its time, phase by phase.

The tool builds ``csrc/gather_linear.cu`` under ``build/k2_phases/`` with
the define ``CGR_PHASE_CLOCK``: thread 0 of block 0 stamps
``%globaltimer`` after each grid barrier (k2_phases.py's clock), so a
phase's time is the card's, every block included.  The phases:

    forward   gather          t1 = G·xa (+ xr) at its padded stride, xb's
                              padded copy, at bf16 the weights rounded
              product         the tiles of t1·Wa + xb·Wb, bias, act
              pool partials   K11: the (group, chunk) partial sums
              pool sums       K11 with more than one chunk: their sums
    backward  gather + dpre   t1 and the rows' scales recomputed, xb's
                              copy, the bf16 weights, ReLU's dpre (K11:
                              with the pool's cotangent)
              dpre tiles      SiLU, GELU: dpre from the pre-activation
              products        dxb's and dt's tiles, dWa's and dWb's split-K
                              partial tiles, db's column partials
              sums + adjoint  dWa, dWb, db in partial order; dxa by the
                              adjoint gather

It times K5 (ReLU, width 400, F = 270, Fe = 14: the README model) as
edge_init and as the readout on ``--small`` synthetic graphs (p = 4
packs) and ``--graphs`` graphs (436 packs), and K11 on the most wired
shard of the wired training runs' layout (a 480-atom chain and 7 graphs,
n_ep 2) and on a zero-cut layout like ``--ep 2`` validation's
(``--val`` synthetic graphs, n_ep 2), forward and backward, at f32 and
bf16.  The stamped build's outputs must equal the shipped build's bit
for bit.  It prints, per case, the median over ``--repeats`` calls of each
phase's ms, its share of the stamped span, and the span.

``--probe`` also times, at p = 4, the forward's product phase as block 0
sees it (its own tiles, before the barrier) through the stamped build and
two probe builds of the tile: without its copies (``CGR_TILE_NO_LOAD``)
and without its products (``CGR_TILE_NO_FMA``), whose results are wrong by
design.

  python -m cgr_mpnn_3d_tpu_torch.tools.glin_phases [--small 20]
      [--graphs 2500] [--val 60] [--repeats 5] [--probe]

Needs the card and nvcc.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess

import numpy as np
import torch

from .conv_phases import _BLOCK0, _equal, _rand, _stamps, _through
from .k2_phases import DEFINE, variant

__all__ = ["main", "phases_of", "DEFINES"]

H, F, FE = 400, 270, 14
LIB = "gather_linear"
# the builds the tool swaps in, by name: {define: value or None}
DEFINES = {"stamped": {DEFINE: None},
           "no copies": {DEFINE: None, "CGR_TILE_NO_LOAD": None},
           "no products": {DEFINE: None, "CGR_TILE_NO_FMA": None}}
# the phase that a stamp id ends (csrc/gather_linear.cu)
_FWD = {1: "gather", 6: "product", 7: "pool partials"}
_FWD_LAST = {1: "product", 6: "pool partials", 7: "pool sums"}
_BWD = {1: "gather + dpre", 2: "dpre tiles", 5: "products",
        9: "sums + adjoint"}


def k5_batch(n_graphs: int, seed: int, dev):
    """(p, batch) of ``n_graphs`` synthetic graphs of the README model's
    layout, packed at te 256 / tn 128 / tb 16."""
    from ..data import (pack_graphs, packs_needed, place_graphs, plan_spec,
                        to_device)
    from ..data.synthetic import synthetic_graphs
    graphs = synthetic_graphs(n_graphs, np.random.default_rng(seed),
                              node_feat_dim=F, edge_feat_dim=FE)
    spec = plan_spec(graphs, te=256, tn=128, tb=16)
    p = packs_needed(graphs, spec)
    while not place_graphs(graphs, spec.with_packs(p)):
        p += max(1, p // 20)
    spec = spec.with_packs(p)
    return p, to_device(pack_graphs(graphs, [0.0] * n_graphs, spec), dev)


def k5_inputs(p: int, b, seed: int, dev, mat_dtype: str) -> list:
    """[(stage, forward args, backward args, kwargs)] of K5 as edge_init
    and as the readout on batch ``b`` (ReLU), drawn from ``seed``: e, h,
    the weights and the cotangents random, ``out`` the forward's."""
    from ..ops import gather_linear as gl
    gen = torch.Generator().manual_seed(seed)
    bf16 = mat_dtype == "bfloat16"
    sd = torch.bfloat16 if bf16 else torch.float32
    ET = b.edge_nbr.shape[0]
    x, e = b.node_x.to(sd), _rand(gen, dev, ET, FE, dtype=sd)
    h = _rand(gen, dev, ET, H).relu().to(sd)
    out = []
    for stage, xa, xb, idx, adj, od in (
            ("edge_init", x, e, b.senders[:, None], b.node_out, mat_dtype),
            ("readout", h, x, b.node_inc, b.receivers[:, None], "float32")):
        wa = _rand(gen, dev, xa.shape[1], H, scale=xa.shape[1] ** -0.5)
        wb = _rand(gen, dev, xb.shape[1], H, scale=xb.shape[1] ** -0.5)
        bias = _rand(gen, dev, H, scale=0.1)
        kw = dict(p=p, mat_dtype=mat_dtype, out_dtype=od)
        fa = (xa, xb, idx, wa, wb, bias)
        with torch.no_grad():
            y = gl.gather_linear_forward(*fa, **kw)
        g = _rand(gen, dev, *y.shape, dtype=y.dtype)
        out.append((stage, fa, (xa, xb, idx, adj, wa, wb, bias, y, g), kw))
    return out


def _k5_cases(n_graphs: int, seed: int, dev, mat_dtype: str) -> list:
    """[(label, forward, backward)] of K5 as edge_init and as the readout
    on a synthetic batch of the README model's layout."""
    from ..ops import gather_linear as gl
    p, b = k5_batch(n_graphs, seed, dev)
    return [(f"K5 {stage} {mat_dtype} p={p}",
             lambda fa=fa, kw=kw: gl.gather_linear_forward(*fa, **kw),
             lambda ba=ba, kw=kw: gl.gather_linear_backward(*ba, **kw))
            for stage, fa, ba, kw in k5_inputs(p, b, seed, dev, mat_dtype)]


def _k11_case(label: str, graphs: list, seed: int, dev, mat_dtype: str):
    """(label, forward, backward) of K11 on the most wired shard of
    ``graphs`` cut at n_ep 2 (te 128 / tn 72, grown to a chain's
    fragment)."""
    from ..ops import gather_linear as gl
    from ..parallel import ep_shards, pack_shard_edges
    host, spec = pack_shard_edges(graphs, [0.0] * len(graphs), 2, te=128,
                                  tn=72)
    b = max(ep_shards(host, dev), key=lambda s: float(s.halo_mask.sum()))
    gen = torch.Generator().manual_seed(seed)
    sd = torch.bfloat16 if mat_dtype == "bfloat16" else torch.float32
    h = _rand(gen, dev, spec.pe, H).relu().to(sd)
    xr = _rand(gen, dev, spec.pn, H, scale=0.5)
    wa = _rand(gen, dev, H, H, scale=H ** -0.5)
    wb = _rand(gen, dev, F, H, scale=F ** -0.5)
    bias = _rand(gen, dev, H, scale=0.1)
    kw = dict(p=spec.p, mat_dtype=mat_dtype)
    fa = (h, xr, b.node_x.to(sd), b.node_inc, b.node_group, b.pool_ell, wa,
          wb, bias)
    with torch.no_grad():
        y, pool = gl.gather_linear_pool_forward(*fa, **kw)
    g, gp = _rand(gen, dev, *y.shape), _rand(gen, dev, *pool.shape)
    ba = (h, xr, b.node_x.to(sd), b.node_inc, b.dst[:, None], b.node_group,
          b.pool_ell, wa, wb, bias, y, g, gp)
    return (f"K11 {label} {mat_dtype} p={spec.p} R={spec.tn} pool_ell "
            f"{list(b.pool_ell.shape)}",
            lambda: gl.gather_linear_pool_forward(*fa, **kw),
            lambda: gl.gather_linear_pool_backward(*ba, **kw))


def phases_of(lib, fn, repeats: int, forward: bool) -> dict:
    """{phase: median ms} (each from the stamp before it) and "span" of a
    stamped build's call."""
    runs = _stamps(lib, fn, repeats, LIB)
    ids = sorted(i for i in runs[0] if i != _BLOCK0)
    names = {}
    for k, i in enumerate(ids):
        if not forward:
            names[i] = _BWD[i]
        elif i == 9:
            names[i] = _FWD_LAST[ids[k - 1]]
        else:
            names[i] = _FWD[i]
    per = [{names[i]: r[i] - (r[ids[k - 1]] if k else 0.0)
            for k, i in enumerate(ids)} for r in runs]
    out = {k: statistics.median(p[k] for p in per) for k in per[0]}
    out["span"] = statistics.median(r[9] for r in runs)
    return out


def main(argv=None) -> dict:
    """Time the phases; returns {"<case> fwd|bwd": {phase: ms, "span":
    ms}} and, with ``--probe``, {"probe <case> <build>": block 0's product
    ms}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", type=int, default=20)
    ap.add_argument("--graphs", type=int, default=2500)
    ap.add_argument("--val", type=int, default=60)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--probe", action="store_true")
    args = ap.parse_args(argv)

    from ..data.synthetic import chain_graph, synthetic_graphs
    from ..ops import _build
    from ..utils.device import resolve_device
    dev = resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    src = _build.CSRC / "gather_linear.cu"
    names = list(DEFINES) if args.probe else ["stamped"]
    builds = {n: variant(DEFINES[n], src) for n in names}
    stamped = builds["stamped"]
    out: dict = {}
    for md in ("float32", "bfloat16"):
        rng = np.random.default_rng(args.seed + 3)
        wired = synthetic_graphs(7, rng, node_feat_dim=F) + [
            chain_graph(480, rng, F)]
        val = synthetic_graphs(args.val, np.random.default_rng(args.seed + 4),
                               node_feat_dim=F)
        cases = (_k5_cases(args.small, args.seed + 1, dev, md)
                 + _k5_cases(args.graphs, args.seed, dev, md)
                 + [_k11_case("wired runs", wired, args.seed, dev, md),
                    _k11_case("zero cut", val, args.seed, dev, md)])
        for label, fwd, bwd in cases:
            for way, fn in (("fwd", fwd), ("bwd", bwd)):
                with torch.no_grad():
                    want = fn()
                if not _equal(_through(stamped, fn, LIB), want):
                    raise RuntimeError(f"{label} {way}: the stamped build "
                                       f"differs from the shipped one")
                res = phases_of(stamped, fn, args.repeats, way == "fwd")
                out[f"{label} {way}"] = res
                print(f"glin_phases {label} {way}: span {res['span']:.4f} ms; "
                      + "; ".join(f"{k} {v:.4f} ({v / res['span']:.1%})"
                                  for k, v in res.items() if k != "span"),
                      flush=True)
        if args.probe:
            for label, fwd, _ in cases[:2]:
                for name in ("stamped", "no copies", "no products"):
                    runs = _stamps(builds[name], fwd, args.repeats, LIB)
                    ms = statistics.median(r[_BLOCK0] - r[1] for r in runs)
                    out[f"probe {label} {name}"] = ms
                    print(f"glin_phases probe {label} fwd, block 0's product "
                          f"tiles through the {name} build: {ms:.4f} ms",
                          flush=True)
        del cases
    return out


if __name__ == "__main__":
    main()
