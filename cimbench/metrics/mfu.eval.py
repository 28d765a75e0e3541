"""mfu.eval: the call's products at the peak rates over the median call, in %."""

from cimbench import layers


def read(ctx):
    return layers.mfu(ctx, "eval")
