"""Device milliseconds a step of the optimizer (`ClippedOptimizer.step`:
global-norm clipping, then Adam): the kernels launched inside it in the
traced window over its calls."""

SPANS = {"bench.optimizer": "bcnf_tpu_torch.train.optim:ClippedOptimizer.step"}


def read(ctx):
    seconds, calls = ctx.trace.span_device_s.get("bench.optimizer"), ctx.trace.span_calls.get("bench.optimizer")
    if ctx.mix["entry"] != "train" or not seconds or not calls:
        return None
    return 1e3 * seconds / calls
