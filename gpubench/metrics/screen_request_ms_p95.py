"""The 95th percentile (nearest rank) of the duration of every request in
the window, in ms (host clock)."""

import math


def read(ctx):
    if ctx.traffic["kind"] != "screen":
        return None
    ms = sorted(s * 1e3 for s in ctx.window["request_s"])
    return ms[math.ceil(0.95 * len(ms)) - 1]
