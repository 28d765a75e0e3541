"""macro_roofline.train: the macro's bound over its kernels' device time, in %."""

from cimbench import layers


def read(ctx):
    return layers.macro_roofline(ctx, "train")
