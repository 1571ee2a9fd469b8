"""``train_graphs_per_s``'s reading (the window's rows over its wall
time), in a cell whose host sets the pace, so that it spreads with the
host's speed and is read per layer."""

from gpubench import spec


def read(ctx):
    return spec.reader("train_graphs_per_s").read(ctx)
