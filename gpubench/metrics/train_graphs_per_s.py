"""Reactions trained per second: every row of every epoch in the window
(each epoch trains every row once) over the window's wall time, its
validations and checkpoint saves included (host clock), in a cell whose
runner's window is of epochs."""

from gpubench import spec


def read(ctx):
    if spec.runner(ctx).WINDOW != "epochs":
        return None
    return ctx.window["graphs"] / ctx.window["seconds"]
