"""The 95th percentile (nearest rank) of the duration of every request in
the window, in ms (host clock), in a cell whose runner's window is of
requests."""

import math

from gpubench import spec


def read(ctx):
    if spec.runner(ctx).WINDOW != "requests":
        return None
    ms = sorted(s * 1e3 for s in ctx.window["request_s"])
    return ms[math.ceil(0.95 * len(ms)) - 1]
