"""ReLU ties in the gather-linear backward (K5, ``csrc/gather_linear.cu``):
its gradients beside the plain version's and a float64 evaluation where
the two take a different ReLU mask.

The kernel's backward takes ReLU's mask from ``out``, the forward kernel's
output.  The plain version (autograd through ``gather_linear_forward_ref``)
recomputes the pre-activation in its own summation order.  Where a
pre-activation lies within rounding of zero the masks can differ, and a
flipped entry moves dpre by the whole cotangent there: one flip moves a
row of dxb by g·Wbᵀ, about 1e-2 of dxb's largest entry at the README
model's width.

For each of ``--seeds`` seeds the tool draws K5's inputs as
``tools/glin_phases.py`` does (the README model's layout, ``--graphs``
synthetic graphs: 436 packs at 2,500), ReLU, f32, edge_init and readout,
and prints: the masks that differ between ``out`` and the plain version's
pre-activation; the largest |kernel − plain| / max |plain| over the
gradients; and the relative L1 of the kernel's and of the plain version's
gradients, each as one vector, to the float64 evaluation (the rule of
``chip_smoke.py``: the kernel at most 3 × the plain version's).  With
``--parent DIR`` (an earlier commit's ``csrc/`` unpacked whole by ``git
archive``, its ``ops/`` beside) it also runs each launch through that
commit's build and wrapper: equal bits or not, and its L1.

  python -m cgr_mpnn_3d_tpu_torch.tools.glin_ties [--graphs 2500]
      [--seeds 8] [--parent DIR] [--device cuda]

On ``--device cpu`` the wrapper takes the plain version, so the kernel's
readings are the plain version's own (a check of the tool).
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

import torch

from .glin_phases import k5_batch, k5_inputs

__all__ = ["main", "ties_of"]


def _l1(got, want) -> float:
    a = torch.cat([t.double().flatten() for t in got])
    b = torch.cat([t.double().flatten() for t in want])
    return float((a - b).abs().sum() / b.abs().sum())


def _f64(v):
    return v.double() if torch.is_tensor(v) and v.is_floating_point() else v


def ties_of(ba: tuple, kw: dict, backward) -> dict:
    """The readings of one K5 backward (``ba``, ``kw``) through
    ``backward`` (a wrapper's ``gather_linear_backward``)."""
    from ..ops import gather_linear as gl
    with torch.no_grad():
        got = backward(*ba, **kw)
    want = gl.gather_linear_backward_ref(*ba, **kw)
    exact = gl.gather_linear_backward_ref(*map(_f64, ba), **kw)
    xa, xb, idx, _, wa, wb, b, out, _ = ba
    pre = gl.gather_linear_forward_ref(xa, xb, idx, wa, wb, b, **kw)
    return dict(
        got=got, flips=int(((pre > 0) != (out > 0)).sum()), n=out.numel(),
        rel=max(float((k - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                for k, w in zip(got, want)),
        l1_kernel=_l1(got, exact), l1_plain=_l1(want, exact), exact=exact)


def _parent_backward(parent: Path):
    """The earlier commit's ``gather_linear_backward`` through its own build
    of ``gather_linear.cu`` (its wrapper loaded inside the shipped ops
    package, so that its relative imports reach the shipped helpers)."""
    from ..ops import _build
    from .k2_phases import variant
    lib = variant({}, parent / "gather_linear.cu")
    name = "cgr_mpnn_3d_tpu_torch.ops._parent_gather_linear"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, parent.parent / "ops" / "gather_linear.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    mod = sys.modules[name]

    def backward(*a, **kw):
        shipped = _build.load("gather_linear")
        _build._libs["gather_linear"] = lib
        try:
            return mod.gather_linear_backward(*a, **kw)
        finally:
            _build._libs["gather_linear"] = shipped
    return backward


def main(argv=None) -> list:
    """Print and return one reading a (seed, stage)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--graphs", type=int, default=2500)
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..ops import gather_linear as gl
    from ..utils.device import resolve_device
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    parent = (_parent_backward(args.parent.resolve())
              if args.parent is not None else None)
    p, b = k5_batch(args.graphs, 0, dev)
    out = []
    for seed in range(args.seeds):
        for stage, _, ba, kw in k5_inputs(p, b, seed, dev, "float32"):
            r = ties_of(ba, dict(kw, act="relu"), gl.gather_linear_backward)
            line = (f"glin_ties K5 {stage} f32 ReLU, {p} packs, seed {seed}:"
                    f" masks of out unlike the plain version's pre "
                    f"{r['flips']} of {r['n']}; max |kernel - plain| / max "
                    f"|plain| {r['rel']:.3e}; L1 vs float64: kernel "
                    f"{r['l1_kernel']:.3e}, plain {r['l1_plain']:.3e}")
            if parent is not None:
                with torch.no_grad():
                    theirs = parent(*ba, **dict(kw, act="relu"))
                r["parent_equal"] = all(torch.equal(x, y)
                                        for x, y in zip(r["got"], theirs))
                r["l1_parent"] = _l1(theirs, r["exact"])
                line += (f", parent {r['l1_parent']:.3e} (its bits equal: "
                         f"{r['parent_equal']})")
            print(line, flush=True)
            del r["got"], r["exact"]
            out.append(dict(r, stage=stage, seed=seed, p=p))
    return out


if __name__ == "__main__":
    main()
