"""device_idle_share.train: the share of the traced window with the card idle, in %."""

from cimbench import layers


def read(ctx):
    return layers.device_idle_share(ctx, "train")
