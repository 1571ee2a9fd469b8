"""Model FLOPs of every training step in the window (forward and backward
over the real rows, nothing recomputed counted twice: ``cost.train_cost``
of each staged batch) over the window's seconds times the product peak of
the configuration's compute type, in %."""

from gpubench.cost import peak_flops, train_cost


def read(ctx):
    if ctx.traffic["kind"] != "train_staged" or ctx.device.type != "cuda":
        return None
    cfg = ctx.config
    batches = ctx.program["trainer"].train_loader.cached_batches()
    per_epoch = sum(sum(train_cost(b, cfg["hidden"], cfg["depth"])[:2])
                    for b in batches)
    return (100 * per_epoch * ctx.window["epochs"]
            / (ctx.window["seconds"] * peak_flops(cfg["compute_dtype"])))
