"""The training steps' share of the card's peak: forward and backward
operations of the steps completed in the traced window
(`work.train_flops`) over the window's seconds, over the TF32 dense rate."""

from benchmark import work


def read(ctx):
    if ctx.mix["entry"] != "train" or not ctx.done.get("steps"):
        return None
    flops = ctx.done["steps"] * work.train_flops(ctx.run_config, int(ctx.done["rows"]))
    return 100.0 * flops / ctx.trace.window_s / ctx.peaks[1]
