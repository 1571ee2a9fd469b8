"""Set-up time: the process's start to the window's start (host clock)."""


def read(ctx):
    return ctx.setup_s
