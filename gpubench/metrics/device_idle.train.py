"""The share of the traced stretch (one validation period of training
epochs) in which no kernel or copy ran on the card, in %."""


def read(ctx):
    if ctx.traffic["kind"] != "train_staged" or ctx.traced is None:
        return None
    return 100 * ctx.traced.idle_share
