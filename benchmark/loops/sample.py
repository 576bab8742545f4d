"""The `sample` loop: one client in a closed loop, each request
`CondRealNVP.sample` of `draws` draws for `conditions` trajectories of a
pool, z from the request's own seed; its latency from its start until its
samples are synchronised on the device.

The mix's keys: `draws`, `conditions`, `pool` (trajectory sets made in
set-up), `warmup` (requests at least) and `warmup_seconds`, `check` requests
checked among the first `check_among` (and always the window's last), the
reference's `check_rows` a block, and for a traced run `trace_seconds` and
`span_calls`.

The check, once the window has closed: every kept request against the
reference's inverse of the same z, drawn again from the request's seed:
`rel_err` (Frobenius), `row_gap` (the widest row's distance over the median
row's norm) and `nonfinite`.
"""

from __future__ import annotations

import math
import statistics
import time
from typing import Any, Callable

from benchmark.harness import (REQUESTS, WARMUP, Cell, Run, checked_requests, derive, make_weights, memory_peak,
                               read_trace, synchroniser, trajectories, window_profile)

# the end-to-end quantities a run of this loop returns
MEASURES = ("posterior_samples_per_s", "posterior_ms_p95")
SPANS = {"bench.request": "bcnf_tpu_torch.models.cnf:CondRealNVP.sample"}


def run(cell: Cell, model: Any, seed: int, seconds: float, device: Any, traced: bool,
        mark: Callable[[str], None], spans: list[str]) -> Run:
    import torch

    from bcnf_tpu_torch.ops.flow_kernel import fused_flow

    from benchmark.reference.model import Flow, encode, float32_products

    mix = cell.mix
    M, N, pool = int(mix["draws"]), int(mix["conditions"]), int(mix["pool"])
    params = make_weights(model, seed, device)
    conds = trajectories(cell, seed, device, pool, N)
    sync = synchroniser(device)
    sync()
    mark("weights and inputs")
    gen = torch.Generator(device=device)

    def request(i: int, stream: int = REQUESTS) -> Any:
        gen.manual_seed(derive(seed, stream, i))
        return model.sample(params, gen, M, conds[i % pool], device=device)

    with torch.no_grad():
        # warm up for a while, not a count alone: the card's clocks rise
        # under load, and a short request would leave them low in the window
        t_warm, k = time.perf_counter(), 0
        while k < int(mix["warmup"]) or time.perf_counter() - t_warm < float(mix["warmup_seconds"]):
            request(k, WARMUP)
            sync()
            k += 1
        checked = checked_requests(seed, int(mix["check"]), int(mix["check_among"]))
        kept: dict[int, Any] = {}
        latencies: list[float] = []
        launches0 = dict(fused_flow.route_launches)
        mark("window")
        with window_profile(device, traced) as holder:
            t_open = time.perf_counter()
            i = 0
            while True:
                t0 = time.perf_counter()
                out = request(i)
                sync()
                t1 = time.perf_counter()
                latencies.append(t1 - t0)
                if i in checked:
                    kept[i] = out
                i += 1
                if t1 - t_open >= seconds:
                    break
            kept[i - 1] = out
            window = t1 - t_open
        launches = {route: n - launches0.get(route, 0) for route, n in fused_flow.route_launches.items()
                    if n - launches0.get(route, 0)}
        peak = memory_peak(device)
        trace = read_trace(device, holder, window, spans, request, i, int(mix["span_calls"]), sync) if traced else None
        del out
        values = {"posterior_samples_per_s": i * M * N / window,
                  "posterior_ms_p95": 1e3 * statistics.quantiles(latencies, n=20, method="inclusive")[18]
                  if len(latencies) > 1 else 1e3 * latencies[0]}

        size = int(cell.run_config["model"]["kwargs"]["size"])
        flow = Flow(params, size)
        diff2 = ref2 = 0.0
        worst, row_norms, nonfinite = 0.0, [], 0
        block = int(mix["check_rows"])
        with float32_products():
            for j, x_p in sorted(kept.items()):
                gen.manual_seed(derive(seed, REQUESTS, j))
                z = torch.randn((M, N, size), generator=gen, device=gen.device).to(device).reshape(-1, size)
                projs = flow.projections(encode(cell.run_config["feature_networks"], params["features"],
                                                conds[j % pool]))
                x_p = x_p.reshape(-1, size)
                nonfinite += int((~torch.isfinite(x_p)).sum())
                for a in range(0, z.shape[0], block):
                    rows = torch.arange(a, min(a + block, z.shape[0]), device=device)
                    x_r = flow.inverse(z[rows], [p[rows % N] for p in projs])
                    d = torch.nan_to_num(x_p[rows] - x_r, nan=math.inf)
                    diff2 += float(torch.sum(d.double() ** 2))
                    ref2 += float(torch.sum(x_r.double() ** 2))
                    worst = max(worst, float(torch.linalg.vector_norm(d, dim=1).max()))
                    row_norms.append(torch.linalg.vector_norm(x_r, dim=1))
        typical = float(torch.cat(row_norms).median())
        checks = {"rel_err": math.sqrt(diff2 / ref2) if ref2 > 0 else math.inf,
                  "row_gap": worst / typical if typical > 0 else math.inf,
                  "nonfinite": float(nonfinite)}
    return Run(values=values, attempted=i, done={"requests": i},
               checks=checks, trace=trace, memory_peak_bytes=peak, launches=launches)
