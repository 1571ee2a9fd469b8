"""Register budget of the training kernel (K2), A/B; with ``--forward``
the grid of the forward kernel (K3f).

``csrc/fused_model_bwd.cu`` has two instantiations of each mat_dtype:
``__launch_bounds__(256, 1)`` (one block per SM, registers as ptxas likes,
no spill) and ``__launch_bounds__(256, 2)`` (two blocks per SM, at most 128
registers); a launch takes the first while the batch's largest tile
phases fit the SMs, else the second, and sizes its cooperative grid by the
instantiation's occupancy.  This tool builds the source twice more with
``-DCGR_BLOCKS_PER_SM=1`` and ``=2`` (every launch forced to one of
them; under ``build/k2_phases/``) and times K2 through the shipped build
and both forced ones, at f32 and bf16, on two seeded synthetic batches of
the README model (depth 4, hidden 400, ReLU, dropout 0.1, 270 node
features, te=256/tn=128/tb=16): ``--small`` graphs (p = 4 packs, a
training batch) and ``--graphs`` graphs (436 packs).  The order is
shipped, one, two, two, one, shipped; each time is the mean of
``--repeats`` calls between two CUDA events.  It prints ptxas's register
lines of the shipped build, one line per build and batch, and whether
the builds' outputs are equal (they must be: the result does not depend
on the grid): K2's SSE and gradients and K3b's gradients.

``--forward`` does the same for ``csrc/fused_model_fwd.cu`` (K3f, eval
mode, its predictions compared).  It has one instantiation per mat_dtype
that fits two blocks an SM, so the define sets only the grid: one or two
blocks on each SM.

  python -m cgr_mpnn_3d_tpu_torch.tools.bwd_registers [--forward]
      [--graphs 2500] [--small 20] [--repeats 10]

Needs the card and nvcc.
"""

from __future__ import annotations

import argparse

import torch

__all__ = ["main", "FORCED"]

# build -> the define that forces it
FORCED = {"one block per SM": 1, "two blocks per SM": 2}


def main(argv=None) -> dict:
    """Run the A/B; returns {"p": {case: packs}, "ms": {build: {case:
    [ms, ms]}}, "equal": {case: bool}} with case "<dtype> p=<packs>"."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--forward", action="store_true",
                    help="K3f (fused_model_fwd.cu) instead of K2")
    ap.add_argument("--graphs", type=int, default=2500)
    ap.add_argument("--small", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from ..ops import _build
    from ..utils.device import resolve_device
    from .k2_phases import _case, _ms, variant
    dev = resolve_device("cuda")
    src_name = "fused_model_fwd" if args.forward else "fused_model_bwd"
    what = "K3f" if args.forward else "K2"
    shipped = _build.load(src_name)
    for line in _build.build_logs.get(src_name, "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"shipped: {line.strip()}")
    libs = {"shipped": shipped}
    libs.update({name: variant({"CGR_BLOCKS_PER_SM": n},
                               _build.CSRC / f"{src_name}.cu")
                 for name, n in FORCED.items()})
    cases = {}
    for md in ("float32", "bfloat16"):
        for n_graphs, seed in ((args.small, args.seed + 1),
                               (args.graphs, args.seed)):
            p, call, outputs = _case(n_graphs, seed, dev, md, args.forward)
            cases[f"{md} p={p}"] = (p, call, outputs)
    ms = {name: {key: [] for key in cases} for name in libs}
    outs: dict = {}
    try:
        for name in ("shipped", *FORCED, *reversed(FORCED), "shipped"):
            _build._libs[src_name] = libs[name]
            for key, (_p, call, outputs) in cases.items():
                with torch.no_grad():
                    outs.setdefault(key, {})[name] = outputs()
                    ms[name][key].append(_ms(call, args.repeats))
    finally:
        _build._libs[src_name] = shipped
    equal = {}
    for key in cases:
        want, *rest = outs[key].values()
        equal[key] = all(torch.equal(t, got[n]) for got in rest
                         for n, t in want.items())
        for name in libs:
            print(f"{what} {key}, {name}: "
                  f"{', '.join(f'{t:.4f}' for t in ms[name][key])} ms")
        print(f"{what} {key}: the builds' outputs equal: {equal[key]}")
    return {"p": {k: c[0] for k, c in cases.items()}, "ms": ms,
            "equal": equal}


if __name__ == "__main__":
    main()
