"""skipped_block_share.eval: the share of activity tiles the kernel
skipped, in %, from ``forward_silicon``'s ``skipped_block_ratio``."""


def read(ctx):
    if ctx.phase != "eval" or "skipped_block_ratio" not in ctx.telemetry:
        return None
    return 100.0 * float(ctx.telemetry["skipped_block_ratio"][0])
