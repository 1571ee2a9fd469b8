"""Register budget of the bf16 backward kernel, A/B.

``csrc/fused_model_bwd.cu`` declares ``__launch_bounds__(256)``.  For its
bf16 instantiation ptxas then keeps 128 registers and spills a little, so
two blocks fit an SM.  This tool builds a second copy of the source with
``__launch_bounds__(256, 1)`` (one block per SM, no spills) and times K2 at
mat_dtype bf16 through both builds on two seeded synthetic batches of the
README model (depth 4, hidden 400, ReLU, dropout 0.1, 270 node features,
te=256/tn=128/tb=16): ``--graphs`` graphs (many packs) and ``--small``
graphs (a few packs, like a training batch).  The order is shipped,
variant, variant, shipped; each time is the mean of ``--repeats`` calls
between two CUDA events.  It prints ptxas's register lines, one line per
build and batch, and whether the two builds' outputs are equal.

  python -m cgr_mpnn_3d_tpu_torch.tools.bwd_registers [--graphs 2500]
      [--small 23] [--repeats 10]

Needs the card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import numpy as np
import torch

__all__ = ["main"]

SHIPPED = "__launch_bounds__(kThreads)\n    fused_model_bwd_kernel"
VARIANT = "__launch_bounds__(kThreads, 1)\n    fused_model_bwd_kernel"


def _build_variant() -> tuple[ctypes.CDLL, str]:
    """The one-block-per-SM copy of fused_model_bwd.cu, built under
    build/bwd_registers/; returns (library, nvcc's output)."""
    from ..ops import _build
    src = (_build.CSRC / "fused_model_bwd.cu").read_text()
    if src.count(SHIPPED) != 1:
        raise RuntimeError("fused_model_bwd.cu no longer declares the launch "
                           "bounds this tool varies")
    out = _build.BUILD_DIR / "bwd_registers"
    out.mkdir(parents=True, exist_ok=True)
    (out / "fused_model_bwd.cu").write_text(src.replace(SHIPPED, VARIANT))
    lib = out / "libfused_model_bwd_one_block.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                          str(_build.CSRC), "-o", str(lib),
                          str(out / "fused_model_bwd.cu")],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for the variant:\n{res.stdout}"
                           f"{res.stderr}")
    return ctypes.CDLL(str(lib)), res.stdout + res.stderr


def _case(n_graphs: int, seed: int, dev):
    """(p, K2's call at bf16) on a seeded synthetic batch."""
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
    adj = adjoint_inputs(batch)
    kw = dict(p=p, act="relu", aggr="add", pooling="add", train=True,
              seeds=kernel_seeds(cfg, gen).tolist(), dropout_ps=(0.1,) * 4,
              mat_dtype="bfloat16")
    return p, lambda: fm.fused_model_train(args, adj, labels,
                                           batch.graph_mask, **kw)


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


def main(argv=None) -> dict:
    """Run the A/B; returns {"p": {batch: packs}, "ms": {build: {batch:
    [ms, ms]}}, "equal": {batch: bool}}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--graphs", type=int, default=2500)
    ap.add_argument("--small", type=int, default=23)
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from ..ops import _build
    from ..utils.device import resolve_device
    dev = resolve_device("cuda")
    shipped = _build.load("fused_model_bwd")
    variant, log = _build_variant()
    for name, text in (("shipped", _build.build_logs.get("fused_model_bwd",
                                                         "")),
                       ("one block per SM", log)):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"{name}: {line.strip()}")

    cases = {"large": _case(args.graphs, args.seed, dev),
             "small": _case(args.small, args.seed + 1, dev)}
    libs = {"shipped": shipped, "one block per SM": variant}
    ms = {name: {key: [] for key in cases} for name in libs}
    outs: dict = {}
    try:
        for name in ("shipped", "one block per SM", "one block per SM",
                     "shipped"):
            _build._libs["fused_model_bwd"] = libs[name]
            for key, (_p, call) in cases.items():
                with torch.no_grad():
                    outs.setdefault(key, {})[name] = call()
                ms[name][key].append(_ms(call, args.repeats))
    finally:
        _build._libs["fused_model_bwd"] = shipped
    equal = {}
    for key, (p, _call) in cases.items():
        (s_sse, s_g), (v_sse, v_g) = outs[key].values()
        equal[key] = bool(torch.equal(s_sse, v_sse) and all(
            torch.equal(a, b) for a, b in zip(s_g, v_g)))
        for name in libs:
            print(f"K2 bf16, {name}, {key} batch ({p} packs): "
                  f"{', '.join(f'{t:.4f}' for t in ms[name][key])} ms")
        print(f"{key} batch: the two builds' outputs equal: {equal[key]}")
    return {"p": {k: c[0] for k, c in cases.items()}, "ms": ms,
            "equal": equal}


if __name__ == "__main__":
    main()
