"""The `train` loop: `Trainer.train_step` over a pool of batches made from
the seed, the same model, optimizer state and dropout generator from the
first step on.

The mix's keys: `batch`, `pool` (batches made in set-up), `warmup_seconds`,
and for a traced run `trace_seconds` and `span_calls`.

Steps 1-3 run in set-up, through the window's own call and feed, and are
the ones the reference follows: each step's loss (`loss_gap`), the first
step's gradient as the optimizer got it (Adam's first moment over 1 - b1;
`grad_gap`), and each leaf's change after step 3 (`change_gap`), the last
two by the worst leaf's gap of norms. Leaves whose reference gradient is
under a thousandth of the median leaf's (the fixed mixes) move by round-off
alone and are left out.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable

import numpy as np

from benchmark.harness import (DROPOUT, INPUTS, Cell, Run, derive, make_weights, memory_peak, read_trace,
                               synchroniser, trajectories, window_profile)

# the end-to-end quantities a run of this loop returns
MEASURES = ("train_samples_per_s",)
SPANS = {"bench.step": "bcnf_tpu_torch.train.trainer:Trainer.train_step"}


def run(cell: Cell, model: Any, seed: int, seconds: float, device: Any, traced: bool,
        mark: Callable[[str], None], spans: list[str]) -> Run:
    import torch

    from bcnf_tpu_torch.bridge import map_tree, tree_leaves
    from bcnf_tpu_torch.train.optim import make_optimizer
    from bcnf_tpu_torch.train.trainer import Trainer

    from benchmark.reference.train import norm_gap, train_steps

    mix, cfg = cell.mix, cell.run_config
    B, pool = int(mix["batch"]), int(mix["pool"])
    size = int(cfg["model"]["kwargs"]["size"])
    weights = make_weights(model, seed, device)
    traj = trajectories(cell, seed, device, pool, B)
    y = torch.randn((pool, B, size), generator=torch.Generator(device=device).manual_seed(derive(seed, INPUTS, 1)),
                    device=device)
    hybrid = float(cfg["global"].get("hybrid_weight", 0) or 0)
    trainer = Trainer(cfg, data=(np.zeros((1, size), np.float32), [np.zeros((1, 1, 1), np.float32)]),
                      hybrid_weight=hybrid, device=device)
    # float32 outside the model's own precision, as `Trainer.train` sets it
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    params = map_tree(lambda t: t.detach().clone().requires_grad_(True), weights)
    opt_cfg = cfg["optimizer"]
    opt = make_optimizer(opt_cfg.get("type", "Adam"), **dict(opt_cfg.get("kwargs") or {})).init(params)
    gen = torch.Generator(device=device).manual_seed(derive(seed, DROPOUT))
    sync = synchroniser(device)
    sync()
    mark("weights and inputs")

    def step(i: int) -> Any:
        return trainer.train_step(model, [params], opt, y[i % pool], [traj[i % pool]], [gen])

    first = [step(0)]
    b1 = opt.torch_optimizer.param_groups[0]["betas"][0]
    # a leaf the optimizer holds no moment for got no gradient
    state = opt.torch_optimizer.state
    g1 = [float(torch.linalg.vector_norm(state[p]["exp_avg"])) / (1 - b1) if "exp_avg" in state.get(p, {}) else 0.0
          for p in opt.params]
    first += [step(1), step(2)]
    change = torch.stack([torch.linalg.vector_norm(p.detach() - p0)
                          for p, p0 in zip(tree_leaves(params), tree_leaves(weights))]).tolist()
    losses = [float(m[0]) for m in first]
    # more steps until the card has run for a while (its clocks rise under load)
    i, t_warm = 3, time.perf_counter()
    while time.perf_counter() - t_warm < float(mix["warmup_seconds"]):
        step(i)
        i += 1
    sync()
    mark("window")
    with window_profile(device, traced) as holder:
        t_open, i0 = time.perf_counter(), i
        while time.perf_counter() - t_open < seconds:
            step(i)
            i += 1
        sync()
        window = time.perf_counter() - t_open
    steps = i - i0
    peak = memory_peak(device)
    trace = read_trace(device, holder, window, spans, step, i, int(mix["span_calls"]), sync) if traced else None
    del params, opt, trainer
    if device.type == "cuda":
        torch.cuda.empty_cache()

    losses_r, g1_r, change_r = train_steps(cfg, weights, [(y[k], traj[k]) for k in range(3)],
                                           torch.Generator(device=device).manual_seed(derive(seed, DROPOUT)))
    g1_rn = [float(torch.linalg.vector_norm(g)) for g in g1_r]
    change_rn = [float(torch.linalg.vector_norm(c)) for c in change_r]
    med = sorted(g1_rn)[len(g1_rn) // 2]
    counted = [g >= 1e-3 * med for g in g1_rn]
    checks = {"loss_gap": max(abs(a - b) / max(abs(b), 1.0) for a, b in zip(losses, losses_r)),
              "grad_gap": norm_gap(g1, g1_rn, counted),
              "change_gap": norm_gap(change, change_rn, counted)}
    checks = {k: (v if math.isfinite(v) else math.inf) for k, v in checks.items()}
    return Run(values={"train_samples_per_s": steps * B / window}, attempted=steps,
               done={"steps": steps, "rows": B},
               checks=checks, trace=trace, memory_peak_bytes=peak)
