"""Reactions trained per second: every row of every epoch in the window
(each epoch trains every row once) over the window's wall time, its
validations and checkpoint saves included (host clock)."""


def read(ctx):
    if ctx.traffic["kind"] != "train_staged":
        return None
    return ctx.window["graphs"] / ctx.window["seconds"]
