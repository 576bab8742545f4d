"""The share of the traced window in which no operation ran on the card."""


def read(ctx):
    if not ctx.trace.n_kernels:
        return None
    return 100.0 * ctx.trace.idle_share
