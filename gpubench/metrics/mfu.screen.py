"""Forward FLOPs of every prediction in the window (``cost.forward_cost``
of each batch a request packs, real rows) over the window's seconds times
the product peak of the configuration's compute type, in %."""

from gpubench.cost import forward_cost, peak_flops


def read(ctx):
    if ctx.traffic["kind"] != "screen" or ctx.device.type != "cuda":
        return None
    from cgr_mpnn_3d_tpu_torch.data.loader import PackedLoader
    cfg, p = ctx.config, ctx.program
    loader = PackedLoader(p["library"], p["spec"],
                          batch_size=p["batch_size"])
    per_request = sum(sum(forward_cost(b, cfg["hidden"], cfg["depth"])[:2])
                      for b in loader)
    return (100 * per_request * ctx.window["attempted"]
            / (ctx.window["seconds"] * peak_flops(cfg["compute_dtype"])))
