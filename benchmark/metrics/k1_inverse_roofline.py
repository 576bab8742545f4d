"""K1's inverse against its roofline: the least time `work.flow_work`'s
operations and bytes take on the card (TF32 dense rate, memory rate), over
the device time of the kernels launched inside `fused_flow`, the port's K1
entry, summed over the calls in the traced window."""

from benchmark import work

SPANS = {"bench.k1": "bcnf_tpu_torch.ops.flow_kernel:fused_flow"}


def read(ctx):
    seconds, calls = ctx.trace.span_device_s.get("bench.k1"), ctx.trace.span_calls.get("bench.k1")
    if ctx.mix["entry"] != "sample" or not seconds or not calls:
        return None
    rows, conds = int(ctx.mix["draws"]) * int(ctx.mix["conditions"]), int(ctx.mix["conditions"])
    bound = work.bound_seconds(work.flow_work(work.flow_shapes(ctx.run_config), rows, conds), ctx.peaks)
    return 100.0 * calls * bound / seconds
