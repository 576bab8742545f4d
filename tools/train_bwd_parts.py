#!/usr/bin/env python3
"""Where the training backward K2b's time goes, on one NVIDIA GPU: each of its
routes at the flagship's shape, as built and with its parts alone.

Run from the root of a checkout on a machine with a card:

    python3 tools/train_bwd_parts.py

The flagship's shape: 4096 rows of size 19 (d_a 10), 26 steps of 4 hidden
layers at H 526 (Hp 544), each row with its own condition; random weights and
cotangents from seed 0, the step inputs from K2a's one-pass forward. Each
route of `ops/flow_kernel.py::train_bwd_route` that takes the shape is timed
through `_train_bwd_parts`: the whole call (every part), then its rows
kernels alone (`BWD_ROWS`), its weight-grad passes alone
(`BWD_WEIGHT_GRADS`, on the scratch the rows left) and the rest alone
(`BWD_ACTNORM`). The `wgmma` route's weights are prepared once a call; that
preparation is timed on its own and is inside the whole call's time. The
one-pass row tiles are forced by `TRAIN_WGMMA_MAX_TN = 0`. Times: CUDA
events around one call, median of 5 after a warm-up. Every route's grads are
printed against the one-pass plain version (the largest max |d| over the ten
grads, each over max(1, max |plain|)); the `wgmma` route's layout beside it.
"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    import torch

    sys.path.insert(0, HERE)
    from bcnf_tpu_torch.ops import flow_kernel as fk
    from bcnf_tpu_torch.ops.tf32 import matmul_tf32

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    S, size, d_a, nh, H, B = 26, 19, 10, 4, 526, 4096

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    w = {"an_scale": 1 + 0.1 * randn(S, size), "an_bias": 0.1 * randn(S, size),
         "ortho": torch.linalg.qr(randn(S, size, size))[0].contiguous(),
         "w1y": randn(S, d_a, H, scale=d_a ** -0.5), "b1": randn(S, H, scale=0.1),
         "wm": randn(S, nh, H, H, scale=H ** -0.5), "bm": randn(S, nh, H, scale=0.1),
         "wout": randn(S, H, 2 * (size - d_a), scale=0.1 * H ** -0.5), "bout": randn(S, 2 * (size - d_a), scale=0.1)}
    kargs, h_proj = fk.pad_hidden(w, randn(S, B, H, scale=0.5))
    Hp = h_proj.shape[-1]
    args = [kargs[n] for n in ("an_scale", "an_bias", "ortho", "w1y", "b1", "wm", "bm", "wout", "bout")]
    x = randn(B, size)
    _, _, bound = fk.fused_flow_train_fwd(x, h_proj, *args, mode=fk.MODE_TF32)
    dz, dld = randn(B, size), randn(B)
    plain = fk.fused_flow_train_backward_reference(bound, h_proj, dz, dld, *args, mm=matmul_tf32)

    def timed(fn, reps: int = 5) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]

    parts = {"all": fk.BWD_ROWS | fk.BWD_WEIGHT_GRADS | fk.BWD_ACTNORM, "rows": fk.BWD_ROWS,
             "weight grads": fk.BWD_WEIGHT_GRADS, "rest": fk.BWD_ACTNORM}
    routes = {"one pass, wgmma": (fk.MODE_TF32, None), "one pass, row tiles": (fk.MODE_TF32, 0),
              "3xTF32, row tiles": (fk.MODE_3XTF32, None)}
    max_tn = fk.TRAIN_WGMMA_MAX_TN
    for what, (mode, force) in routes.items():
        fk.TRAIN_WGMMA_MAX_TN = max_tn if force is None else force
        try:
            route = fk.train_bwd_route(Hp, size, d_a, nh, mode)
            if what == "one pass, wgmma" and route != fk.ROUTE_WGMMA_TF32:
                print(f"{what}: not taken at this shape (route {route})")
                continue
            grads = fk.fused_flow_train_bwd(bound, h_proj, dz, dld, *args, mode=mode)
            torch.cuda.synchronize()
            err = max((g - p).abs().max().item() / max(1.0, p.abs().max().item()) for g, p in zip(grads, plain))
            named = dict(zip(("an_scale", "an_bias", "ortho", "w1y", "b1", "wm", "bm", "wout", "bout"), args))
            ms = {part: timed(lambda: fk._train_bwd_parts(bound, h_proj, dz, dld, named, grads, bits, mode))
                  for part, bits in parts.items()}
            line = f"{what} ({route}): " + ", ".join(f"{part} {t:.3f} ms" for part, t in ms.items())
            if route == fk.ROUTE_WGMMA_TF32:
                line += f"; weight preparation {timed(lambda: fk.prepare_train_weights(named['wm'])):.3f} ms"
                line += "; layout (rows blocks, clusters resident, weight-grad blocks a step, their blocks an SM) "
                line += str(fk.train_bwd_wgmma_layout(Hp, size, d_a, nh, B))
            print(line + f"; largest max|d| / max(1, max|plain|) over the grads vs the plain one-pass version "
                  f"{err:.3e}", flush=True)
        finally:
            fk.TRAIN_WGMMA_MAX_TN = max_tn


if __name__ == "__main__":
    main()
