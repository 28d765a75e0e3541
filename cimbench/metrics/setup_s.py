"""setup_s: seconds from the command's start to the first timed call:
imports, the card's start, kernel builds or loads, weights and inputs
made on the card, and the warm-up."""


def read(ctx):
    return ctx.setup_s
