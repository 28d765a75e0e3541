"""eval_pass_ms_p95: the 95th percentile of every pass in the window,
each from its call to its synchronised result."""

from cimbench import stats


def read(ctx):
    if ctx.phase != "eval":
        return None
    return stats.percentile(ctx.window.call_ms(), 0.95)
