"""The sampling requests' share of the card's peak: the model operations of
the requests completed in the traced window (encoder, condition
projections, the flow's inverse; `work.sample_flops`) over the window's
seconds, over the TF32 dense rate."""

from benchmark import work


def read(ctx):
    if ctx.mix["entry"] != "sample" or not ctx.done.get("requests"):
        return None
    flops = ctx.done["requests"] * work.sample_flops(ctx.run_config, int(ctx.mix["draws"]),
                                                     int(ctx.mix["conditions"]))
    return 100.0 * flops / ctx.trace.window_s / ctx.peaks[1]
