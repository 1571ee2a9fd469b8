"""Model FLOPs of every training step of the traced stretch (one
validation period of epochs; ``cost.train_cost`` of each staged batch,
real rows) over the stretch's device busy seconds times the product peak
of the configuration's compute type, in %: the card's work as a share of
its peak while it works, as ``train_graphs_per_device_s`` counts time."""

from gpubench.cost import peak_flops, train_cost


def read(ctx):
    if (ctx.traffic["kind"] != "train_staged" or ctx.device.type != "cuda"
            or ctx.traced is None or ctx.traced.busy_s <= 0):
        return None
    cfg = ctx.config
    batches = ctx.program["trainer"].train_loader.cached_batches()
    per_epoch = sum(sum(train_cost(b, cfg["hidden"], cfg["depth"])[:2])
                    for b in batches)
    return (100 * per_epoch * ctx.traffic["val_frequency"]
            / (ctx.traced.busy_s * peak_flops(cfg["compute_dtype"])))
