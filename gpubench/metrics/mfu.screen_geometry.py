"""The FLOPs of MACE and of the head for every prediction in the window
(``cost_mace.mace_cost`` of each window's structures and
``cost.forward_cost`` of each batch a request packs, real rows, at the
head's width: the packed CGR features and the three structures'
descriptors that the card gathers beside them) over the window's seconds
times the float32 peak, in %."""

import numpy as np
import torch

from gpubench.cost import PEAKS, forward_cost
from gpubench.cost_mace import mace_cost


def read(ctx):
    if ctx.traffic["kind"] != "screen_geometry" or ctx.device.type != "cuda":
        return None
    from cgr_mpnn_3d_tpu_torch.data.loader import PackedLoader
    cfg, p = ctx.config, ctx.program
    geo, r_max = p["library"].geometry, p["mace"].cfg.r_max
    per_request = 0.0
    for b in PackedLoader(p["library"], p["spec"],
                          batch_size=p["batch_size"]):
        wide = b._replace(node_x=torch.empty(b.node_x.shape[0],
                                             cfg["node_features"]))
        per_request += sum(forward_cost(wide, cfg["hidden"],
                                        cfg["depth"])[:2])
        lay = geo.window(b.row_ids, b.graph_mask, b.graph_nodes,
                         b.node_x.shape[0], r_max)
        c = mace_cost(cfg["mace"], len(lay.z), lay.n_edges,
                      len(lay.struct_ptr) - 1, len(np.unique(lay.z)),
                      len(lay.tiles))
        per_request += sum(sum(v[:2]) for v in c.values())
    return (100 * per_request * ctx.window["attempted"]
            / (ctx.window["seconds"] * PEAKS["float32"]))
