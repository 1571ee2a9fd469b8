"""The model step's share of its roofline: the least time of the step's
model work (``cost.bound`` of ``cost.train_cost``) over the device time of
``fused_train_value_and_grad`` on the cell's first staged batches (CUDA
events over 20 calls each), in %.  It reads the same work whatever kernel
does it."""

import torch

from gpubench.card import time_ms
from gpubench.cost import bound, train_cost
from gpubench.reference.model import step_seeds

BATCHES = 8
CALLS = 20


def read(ctx):
    if ctx.traffic["kind"] != "train_staged" or ctx.device.type != "cuda":
        return None
    from cgr_mpnn_3d_tpu_torch.data.batch import to_device
    from cgr_mpnn_3d_tpu_torch.models import fused_train_value_and_grad
    cfg = ctx.config
    trainer, spec = ctx.program["trainer"], ctx.program["spec"]
    seeds = torch.tensor(step_seeds(ctx.seed, 0, cfg["depth"]),
                         dtype=torch.int32, device=ctx.device)
    least = spent = 0.0
    for b in trainer.train_loader.cached_batches()[:BATCHES]:
        db = to_device(b, ctx.device)
        spent += time_ms(lambda: fused_train_value_and_grad(
            trainer.model, db, spec, seeds), CALLS)
        least += bound(train_cost(b, cfg["hidden"], cfg["depth"]),
                       cfg["compute_dtype"])[0]
    return 100 * least / spent
