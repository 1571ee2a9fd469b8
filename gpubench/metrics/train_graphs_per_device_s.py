"""Reactions trained per second of the card's busy time: every row of one
validation period of epochs (its steps, validation and checkpoint saves)
over the union of the device's kernel, copy and set intervals in it, from
the profiler's trace of that period run after the window.  The host's
share of a step, which sets the wall-clock rate of a host-paced cell,
does not count: what the card itself spends on the work.  Read in a cell
whose runner's window is of epochs."""

from gpubench import spec
from gpubench.trace import device_busy


def read(ctx):
    runner = spec.runner(ctx)
    if runner.WINDOW != "epochs" or ctx.device.type != "cuda":
        return None
    _, busy_s, _ = device_busy(lambda: runner.stretch(ctx))
    if busy_s <= 0:
        return None
    graphs = ctx.traffic["val_frequency"] * len(ctx.inputs["train"][0])
    return graphs / busy_s
