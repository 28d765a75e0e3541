"""train_samples_per_s: every sample stepped in the window over the
window's seconds; each step ends in a synchronise."""


def read(ctx):
    return ctx.window.units_per_s() if ctx.phase == "train" else None
