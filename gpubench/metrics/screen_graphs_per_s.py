"""Predictions returned to the host per second: every row of every
request in the window over the window's wall time (host clock), in a cell
whose runner's window is of requests."""

from gpubench import spec


def read(ctx):
    if spec.runner(ctx).WINDOW != "requests":
        return None
    return ctx.window["graphs"] / ctx.window["seconds"]
