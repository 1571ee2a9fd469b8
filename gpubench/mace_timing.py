"""The library's first window as the MACE kernels see it, for the readers
of their roofline shares: each layer's inputs made once by the program's
own forward, each kernel then timed alone over both layers (CUDA events),
and the window's work (``cost_mace.mace_cost``)."""

from __future__ import annotations

import numpy as np
import torch

from .card import time_ms
from .cost import bound
from .cost_mace import mace_cost

__all__ = ["kernel_share"]

CALLS = 20
_KEY = "gpubench.mace_window"


def _window(ctx) -> dict:
    if _KEY in ctx.program:
        return ctx.program[_KEY]
    from cgr_mpnn_3d_tpu_torch.data.batch import device_tensor
    from cgr_mpnn_3d_tpu_torch.data.loader import PackedLoader
    from cgr_mpnn_3d_tpu_torch.ops import mace as ops
    p, dev = ctx.program, ctx.device
    mace = p["mace"]
    b = next(iter(PackedLoader(p["library"], p["spec"],
                               batch_size=p["batch_size"])))
    lay = p["library"].geometry.window(b.row_ids, b.graph_mask,
                                       b.graph_nodes, b.node_x.shape[0],
                                       mace.cfg.r_max)
    pos, z, sptr, tiles = (device_tensor(a, dev) for a in (
        lay.pos, lay.z, lay.struct_ptr, lay.tiles.numpy()))
    prep = mace.prepared()
    out = torch.empty(len(lay.z), mace.cfg.descriptor_dim, device=dev)
    calls, hup, sc = [], prep["hup0"][z.long()], None
    for t, L in enumerate(prep["layers"]):
        inter = (pos, sptr, hup, L["radial"], mace.cfg.r_max,
                 mace.cfg.num_polynomial_cutoff)
        msg = ops.mace_interaction(*inter)
        prod = (msg, z, tiles, L["m"], L["m_shared"], L["weff"],
                prep["mono"], prep["coef"], prep["ptr"], L["wout"], sc, out,
                t * mace.cfg.num_channels, L["wup_next"], L["wskip_next"])
        calls.append((inter, prod))
        hup, sc = ops.mace_product(*prod)
    cost = mace_cost(ctx.config["mace"], len(lay.z), lay.n_edges,
                     len(lay.struct_ptr) - 1, len(np.unique(lay.z)),
                     len(lay.tiles))
    ctx.program[_KEY] = {"calls": calls, "cost": cost}
    return ctx.program[_KEY]


def kernel_share(ctx, kernel: str) -> float | None:
    """The least time of ``kernel``'s ("interaction" or "product") work on
    the library's first window over both layers, over its device time
    there (mean of CUDA events over CALLS calls of every layer), in %."""
    if ctx.traffic["kind"] != "screen_geometry" or ctx.device.type != "cuda":
        return None
    from cgr_mpnn_3d_tpu_torch.ops import mace as ops
    w = _window(ctx)
    fn = ops.mace_interaction if kernel == "interaction" else ops.mace_product
    k = 0 if kernel == "interaction" else 1

    def run():
        for c in w["calls"]:
            fn(*c[k])
    with torch.no_grad():
        ms = time_ms(run, CALLS)
    return 100 * bound(w["cost"][kernel])[0] / ms
