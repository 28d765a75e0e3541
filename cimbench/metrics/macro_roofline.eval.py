"""macro_roofline.eval: the macro's bound over its kernels' device time, in %."""

from cimbench import layers


def read(ctx):
    return layers.macro_roofline(ctx, "eval")
