"""The forward's share of its roofline: the least time of one request
batch's forward work (``cost.bound`` of ``cost.forward_cost``) over the
device time of ``apply`` in eval mode on the library's first batch (CUDA
events over 20 calls), in %."""

import torch

from gpubench.card import time_ms
from gpubench.cost import bound, forward_cost

CALLS = 20


def read(ctx):
    if ctx.traffic["kind"] != "screen" or ctx.device.type != "cuda":
        return None
    from cgr_mpnn_3d_tpu_torch.data.batch import to_device
    from cgr_mpnn_3d_tpu_torch.data.loader import PackedLoader
    from cgr_mpnn_3d_tpu_torch.models import apply
    cfg, p = ctx.config, ctx.program
    loader = PackedLoader(p["library"], p["spec"],
                          batch_size=p["batch_size"])
    b = next(iter(loader))
    db = to_device(b, ctx.device)
    with torch.no_grad():
        ms = time_ms(lambda: apply(p["model"], db, loader.spec), CALLS)
    least = bound(forward_cost(b, cfg["hidden"], cfg["depth"]),
                  cfg["compute_dtype"])[0]
    return 100 * least / ms
