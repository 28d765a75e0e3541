"""eval_streams_per_s: every stream classified in the window over the
window's seconds."""


def read(ctx):
    return ctx.window.units_per_s() if ctx.phase == "eval" else None
