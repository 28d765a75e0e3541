"""device_kernels_per_call.eval: device kernels a call launches."""

from cimbench import layers


def read(ctx):
    return layers.device_kernels_per_call(ctx, "eval")
