"""Activation-chain probe (P1): what each activation of the kernels costs
per element on the card, and how much slower a layered training step should
be with GELU than with ReLU.

The counterpart of ``tools/gelu_roofline.py``.  It measures:

1. the time per application of the kernels' own activation chains (relu,
   silu, gelu, gelu_bwd = k_dact of gelu, gelu_bwd_from_out) on an [N, H]
   f32 array: one launch of ``csrc/act_chain.cu`` applies the function k
   times in registers, and the slope (t(1 + K) - t(1)) / K over the chain
   length removes the launch's load and store;
2. given a training step (``main(step=(spec, cfg))``: the caller's pack
   geometry and model config), the step's activation element counts
   (``act_elems_per_step``): forward one activation per edge-state element
   of edge_init and of every conv layer and per node-state element of the
   readout, backward one derivative at each of those sites;
3. then ``pred_gelu_step_ms``, the predicted increase of that layered
   training step's time from ReLU to GELU, from 1 x 2 (``chip_smoke.py``
   passes its full-width synthetic batch, measures the same increase and
   prints both), and ``bwd_from_out_lever_ms``, what taking GELU's
   derivative from the stored output would save.  Run alone, the probe has
   no step and prints these three as null.

The chain functions are the ``__device__`` ``k_act``/``k_dact`` that the
model's kernels inline, which take CUDA's ``erff``; the TPU kernels build
erf from ``exp`` (Abramowitz-Stegun 7.1.26), so this probe times the port's
chain, not the TPU's.  ``--cpu`` runs the plain version
(``ops/act_chain.py::act_chain_ref``).

  python -m cgr_mpnn_3d_tpu_torch.tools.gelu_roofline [--cpu] [--n 101888]
      [--h 512] [--apps 32] [--repeats 5]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

__all__ = ["main", "act_elems_per_step"]


def act_elems_per_step(spec, cfg) -> tuple[int, int]:
    """(forward, backward) activation elements of one training step on a
    batch of ``spec`` (PackSpec) through a model of ``cfg``
    (CGRMPNNConfig): the edge states of edge_init and of every conv layer,
    the node states of the readout; one derivative per element backward."""
    fwd = ((cfg.depth + 1) * spec.total_edges + spec.total_nodes) * cfg.hidden
    return fwd, fwd


def main(argv=None, step=None) -> dict:
    """Run the probe and print its JSON line; ``step`` is an optional
    (PackSpec, CGRMPNNConfig) pair, the training step to predict for."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--n", type=int, default=101888, help="rows")
    ap.add_argument("--h", type=int, default=512, help="columns")
    ap.add_argument("--apps", type=int, default=32,
                    help="added chain length of the slope's long call")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)

    from ..ops.act_chain import FNS, act_chain
    from ..utils.device import resolve_device

    dev = resolve_device("cpu" if args.cpu else "cuda")
    N, H, K = args.n, args.h, args.apps
    x0 = torch.randn((N, H), generator=torch.Generator().manual_seed(0)).to(
        dev)
    # a distinct input per timed call
    xs = [x0 + 0.001 * (i + 1) for i in range(args.repeats)]

    def one_call_s(fn: str, k: int, x) -> float:
        if dev.type == "cpu":
            t0 = time.perf_counter()
            act_chain(x, fn, k)
            return time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        act_chain(x, fn, k)
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / 1e3

    def timed_k(fn: str, k: int) -> float:
        act_chain(x0, fn, k)                    # build + warm up
        return min(one_call_s(fn, k, x) for x in xs)

    k1 = {fn: timed_k(fn, 1) for fn in FNS}
    per_app = {fn: (timed_k(fn, 1 + K) - k1[fn]) / K for fn in FNS}
    elem = {fn: t / (N * H) for fn, t in per_app.items()}
    elems = pred = lever = None
    if step is not None:
        fwd, bwd = act_elems_per_step(*step)
        elems = fwd + bwd
        pred = (fwd * (elem["gelu"] - elem["relu"])
                + bwd * (elem["gelu_bwd"] - elem["relu"])) * 1e3
        lever = bwd * (elem["gelu_bwd"] - elem["gelu_bwd_from_out"]) * 1e3
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out = {
        "device": kind, "n": N, "h": H, "apps": K,
        "gelem_per_s": {fn: N * H / t / 1e9 if t > 0 else None
                        for fn, t in per_app.items()},
        "per_app_ms": {fn: t * 1e3 for fn, t in per_app.items()},
        "k1_ms": {fn: t * 1e3 for fn, t in k1.items()},
        "act_elems_per_step": elems,
        "pred_gelu_step_ms": pred,
        "bwd_from_out_lever_ms": lever,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
