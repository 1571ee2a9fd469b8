"""Host ms to pack one batch of the library with the program's loader, as
a request packs it, timed alone: whole passes over the library that fill
0.3 s, over the batches a pass makes."""

from gpubench.card import host_ms


def read(ctx):
    if ctx.traffic["kind"] != "screen":
        return None
    from cgr_mpnn_3d_tpu_torch.data.loader import PackedLoader
    p = ctx.program
    loader = PackedLoader(p["library"], p["spec"],
                          batch_size=p["batch_size"])
    batches = len(list(loader))
    return host_ms(lambda: list(loader)) / batches
