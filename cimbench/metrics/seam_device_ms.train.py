"""seam_device_ms.train: device ms a call outside the port's own kernels."""

from cimbench import layers


def read(ctx):
    return layers.seam_device_ms(ctx, "train")
