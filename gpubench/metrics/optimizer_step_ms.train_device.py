"""``optimizer_step_ms.train``'s reading, in a cell whose rate is read on the
device's busy time (``train_graphs_per_device_s``)."""

from gpubench import spec


def read(ctx):
    return spec.reader("optimizer_step_ms.train").read(ctx)
