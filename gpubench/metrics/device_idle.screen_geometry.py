"""The share of the traced stretch (three geometry-screen requests) in
which no kernel or copy ran on the card, in %."""


def read(ctx):
    if ctx.traffic["kind"] != "screen_geometry" or ctx.traced is None:
        return None
    return 100 * ctx.traced.idle_share
