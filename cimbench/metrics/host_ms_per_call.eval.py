"""host_ms_per_call.eval: the median host ms of a call, start to return."""

from cimbench import layers


def read(ctx):
    return layers.host_ms_per_call(ctx, "eval")
