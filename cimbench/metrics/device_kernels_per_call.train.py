"""device_kernels_per_call.train: device kernels a call launches."""

from cimbench import layers


def read(ctx):
    return layers.device_kernels_per_call(ctx, "train")
