#!/usr/bin/env python3
"""The strict flagship's training step, at batch 4096 unless asked for
another, on one NVIDIA GPU: train samples/s of `Trainer.train_step` for
`CondRealNVP(pallas_strict=True)` (coupling dropout 0, so K2a and K2b run, in
float32 FMA) and the step's peak memory, this checkout's and another
checkout's in turns.

Run from the root of a checkout on a machine with a card:

    python3 tools/strict_step_rate.py [--batch N[,N ...]] [--plain] [OTHER_CHECKOUT]

Each checkout's libraries of the step (the strict K2a and K2b, the LSTM
kernels) are built first (`ops/_build.py`'s `build_all`, one nvcc per
library, both checkouts at once). Then each
checkout's step is timed in a process of its own that imports that
checkout's package, in turns (this, other, other, this; this alone twice
without OTHER_CHECKOUT): the flagship (`configs/runs/trajectory_LSTM_large.yaml`,
random weights from seed 0) on the batch's random rows and trajectories
from seed 0, the fused LSTM kernels on (the card's default), one warm-up
step, then 10 steps under the host clock around synchronised work, beside
K2a's and K2b's launches in them (past the strict backward's chunk limit,
K2b once a row chunk and K2a once more a chunk: `ops/flow_kernel.py`'s
`strict_chunks`), the most memory PyTorch's allocator held during them
(`torch.cuda.max_memory_allocated`, weights and optimizer state included)
and the card's name, power limit and memory. With `--plain`, each batch
also runs once on plain float32 autograd (the training kernels' gate closed
through the model's `fused_train_min_batch`, TF32 off; the encoder's LSTM
kernels stay on), so the two paths' peaks stand side by side. Several
batches, comma-separated, run one after the other. A step that runs out of
memory prints what the allocator held and asked for, and the next run goes
on.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 10


def time_steps(root: str, B: int, plain: bool = False) -> dict:
    """This process: the strict flagship's step rate with `root`'s package
    (`plain`: on plain float32 autograd, the training kernels off); where a
    step runs out of memory, what the allocator held."""
    sys.path.insert(0, root)
    os.environ["BCNF_ROOT"] = root
    import numpy as np
    import torch

    from bcnf_tpu_torch.bridge import map_tree
    from bcnf_tpu_torch.config import load_config
    from bcnf_tpu_torch.models import CondRealNVP
    from bcnf_tpu_torch.ops import flow_kernel as fk
    from bcnf_tpu_torch.train import Trainer, make_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = load_config(os.path.join(root, "configs", "runs", "trajectory_LSTM_large.yaml")).to_dict()
    cfg["model"]["kwargs"]["dropout"] = 0.0
    cfg["training"].update(batch_size=B, n_epochs=1, timeout=None)
    model = CondRealNVP.from_config(cfg)
    model.pallas_strict = True
    if plain:
        model.fused_train_min_batch = B + 1  # the training kernels' gate closed
    rng = np.random.default_rng(0)
    y = rng.normal(size=(B, model.size)).astype(np.float32)
    traj = rng.normal(size=(B, 30, 3)).astype(np.float32)
    trainer = Trainer(cfg, data=(y, [traj]), device=dev, seed=0)
    params = map_tree(lambda t: t.detach().clone().requires_grad_(True),
                      model.init(torch.Generator().manual_seed(0), device=dev))
    opt = make_optimizer("Adam", lr=2e-4).init(params)
    gen = torch.Generator(device=dev).manual_seed(0)
    yb, cb = torch.from_numpy(y).to(dev), [torch.from_numpy(traj).to(dev)]
    try:
        trainer.train_step(model, [params], opt, yb, cb, [gen])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = (fk.fused_flow_train_fwd.launches, fk.fused_flow_train_bwd.launches)  # the warm-up step's
        t0 = time.perf_counter()
        for _ in range(STEPS):
            trainer.train_step(model, [params], opt, yb, cb, [gen])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    except torch.cuda.OutOfMemoryError as e:
        return {"root": root, "oom": str(e).splitlines()[0], "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                "card_gb": torch.cuda.get_device_properties(dev).total_memory / 1e9}
    launches = (fk.fused_flow_train_fwd.launches - before[0], fk.fused_flow_train_bwd.launches - before[1])
    # a step: K2a and K2b once each; where the strict backward runs in row chunks, K2b once a chunk and K2a
    # once more a chunk (the backward runs it again on the chunk's rows)
    chunks = before[1]
    if plain:
        if launches != (0, 0) or before != (0, 0):
            raise SystemExit(f"{root}: the plain step launched K2a/K2b {launches} (the warm-up step {before})")
    elif (launches != (STEPS * before[0], STEPS * chunks) or before[0] != chunks + (chunks > 1)
            or dict(fk.fused_flow_train_bwd.route_launches) != {fk.ROUTE_FMA: (STEPS + 1) * chunks}):
        raise SystemExit(f"{root}: K2a/K2b launched {launches} (the warm-up step {before}), routes "
                         f"{dict(fk.fused_flow_train_bwd.route_launches)}")
    return {"root": root, "plain": plain, "samples_per_s": STEPS * B / seconds, "ms_per_step": 1e3 * seconds / STEPS,
            "launches": launches, "chunks": chunks, "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "card_gb": torch.cuda.get_device_properties(dev).total_memory / 1e9}


def main() -> None:
    if sys.argv[1:2] == ["--time"]:
        print(json.dumps(time_steps(os.path.abspath(sys.argv[2]), int(sys.argv[3]), sys.argv[4:5] == ["plain"])))
        return
    argv, batches, plain = sys.argv[1:], [4096], False
    if argv[:1] == ["--batch"]:
        argv, batches = argv[2:], [int(b) for b in argv[1].split(",")]
    if argv[:1] == ["--plain"]:
        argv, plain = argv[1:], True
    roots = [HERE] + [os.path.abspath(a) for a in argv[:1]]
    builds = [subprocess.Popen([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                                "from bcnf_tpu_torch.ops import _build; "
                                "_build.build_all(['flow_fma', 'flow_train_fma', 'lstm_kernel'])", root])
              for root in roots]
    if any(p.wait() for p in builds):
        raise SystemExit("a checkout's kernels failed to build")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    order = [roots[0], roots[-1], roots[-1], roots[0]] if len(roots) > 1 else roots * (1 if plain else 2)
    for batch in batches:
        for root, on_plain in [(r, False) for r in order] + ([(roots[0], True)] if plain else []):
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--time", root, str(batch)]
                                 + (["plain"] if on_plain else []), capture_output=True, text=True)
            if out.returncode:
                raise SystemExit(f"{root}: the timing failed:\n{out.stdout}\n{out.stderr}")
            r = json.loads(out.stdout.strip().splitlines()[-1])
            what = f"{os.path.relpath(root, HERE) or '.'}{' (plain autograd)' if on_plain else ''}"
            if "oom" in r:
                print(f"{what}: out of memory at batch {batch} (peak {r['peak_gb']:.2f} GB allocated of the card's "
                      f"{r['card_gb']:.1f} GB): {r['oom']}", flush=True)
                continue
            print(f"{what}: {r['samples_per_s']:.0f} train samples/s at batch {batch} "
                  f"({r['ms_per_step']:.2f} ms a step over {STEPS} steps; K2a, K2b launches {r['launches']}, "
                  f"{r['chunks']} row chunk(s) a step; peak "
                  f"{r['peak_gb']:.2f} GB of the card's {r['card_gb']:.1f} GB)", flush=True)

if __name__ == "__main__":
    main()
