"""The MACE interaction kernel's share of its roofline: the least time of
its work on the library's first window over both layers
(``cost_mace.mace_cost``, ``cost.bound``) over its device time there
(CUDA events over 20 calls), in %."""

from gpubench.mace_timing import kernel_share


def read(ctx):
    return kernel_share(ctx, "interaction")
