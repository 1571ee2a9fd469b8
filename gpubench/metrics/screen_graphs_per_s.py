"""Predictions returned to the host per second: every row of every
request in the window over the window's wall time (host clock)."""


def read(ctx):
    if ctx.traffic["kind"] != "screen":
        return None
    return ctx.window["graphs"] / ctx.window["seconds"]
