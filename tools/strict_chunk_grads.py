#!/usr/bin/env python3
"""The strict flow's grads in row chunks, this checkout's against another
checkout's, bit for bit, on one NVIDIA GPU.

Run from the root of a checkout on a machine with a card:

    python3 tools/strict_chunk_grads.py OTHER_CHECKOUT

Each checkout runs, in a process of its own that imports its package, the
strict training flow (`fused_flow_train` in float32 FMA, K2a forward and the
chunked K2b backward) at the flagship's shape (`configs/runs/trajectory_LSTM_large.yaml`,
random weights from seed 0, the encoder's condition projections of random
trajectories) on two cases: 4099 rows with the backward forced into chunks
of 1024 rows (1024, 1024, 1024 and 1027), and 65,536 rows in the chunks the
card's memory gives (`strict_chunks`). The cotangents on z and logdet are
standard normal from seed 0. Every grad (x, h_proj and the nine kernel
arguments') is saved under `bcnf_tpu_torch/_build/strict_chunk_grads/` and
compared with the other checkout's: equal to the bit, or the largest difference.
Prints the card's name and power limit, each case's chunks and each
checkout's peak memory.
"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "bcnf_tpu_torch", "_build", "strict_chunk_grads")  # ~8 GB at 65,536 rows
CASES = {"4099 rows, chunks of 1024": (4099, 1024), "65,536 rows, the card's chunks": (65_536, None)}
NAMES = ("x", "h_proj", "an_scale", "an_bias", "ortho", "w1y", "b1", "wm", "bm", "wout", "bout")


def grads(root: str, tag: str) -> None:
    """This process: each case's grads with `root`'s package, saved."""
    sys.path.insert(0, root)
    os.environ["BCNF_ROOT"] = root
    import numpy as np
    import torch

    from bcnf_tpu_torch.config import load_config
    from bcnf_tpu_torch.models import CondRealNVP
    from bcnf_tpu_torch.ops import flow_kernel as fk

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    model = CondRealNVP.from_config(load_config(os.path.join(root, "configs", "runs", "trajectory_LSTM_large.yaml")))
    params = model.init(torch.Generator().manual_seed(0), device=dev)
    for case, (rows, chunk_rows) in CASES.items():
        rng = np.random.default_rng(0)
        with torch.no_grad():
            traj = torch.from_numpy(rng.normal(size=(rows, 30, 3)).astype(np.float32)).to(dev)
            kargs, h_proj = model._fused_flow_args(params, model.encode(params, (traj,)))
            x = torch.from_numpy(rng.normal(size=(rows, model.size)).astype(np.float32)).to(dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        dz, dld = torch.randn(x.shape, generator=gen, device=dev), torch.randn((rows,), generator=gen, device=dev)
        leaves = [t.detach().clone().requires_grad_(True) for t in (x, h_proj, *(kargs[n] for n in NAMES[2:]))]
        del traj, kargs, h_proj
        torch.cuda.reset_peak_memory_stats(dev)
        z, ld = fk.fused_flow_train(*leaves, mode=fk.MODE_FMA, chunk_rows=chunk_rows)
        ((z * dz).sum() + (ld * dld).sum()).backward()
        torch.cuda.synchronize()
        chunks = fk.strict_chunks(dz, leaves[1], leaves[7], model.coupling.d_a, fk.MODE_FMA, chunk_rows)
        torch.save({n: t.grad.cpu() for n, t in zip(NAMES, leaves)}, os.path.join(OUT, f"{tag}-{rows}.pt"))
        print(f"    {case}: {len(chunks or [0])} chunk(s) {[e - f for f, e in chunks or [(0, rows)]]}, peak "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB", flush=True)
        del z, ld, leaves
        torch.cuda.empty_cache()


def main() -> None:
    if sys.argv[1:2] == ["--grads"]:
        grads(os.path.abspath(sys.argv[2]), sys.argv[3])
        return
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    import torch

    roots = {"this": HERE, "other": os.path.abspath(sys.argv[1])}
    os.makedirs(OUT, exist_ok=True)
    builds = [subprocess.Popen([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                                "from bcnf_tpu_torch.ops import _build; "
                                "_build.build_all(['flow_fma', 'flow_train_fma'])", root]) for root in roots.values()]
    if any(p.wait() for p in builds):
        raise SystemExit("a checkout's kernels failed to build")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    for tag, root in roots.items():
        print(f"{tag} ({root}):", flush=True)
        if subprocess.run([sys.executable, os.path.abspath(__file__), "--grads", root, tag]).returncode:
            raise SystemExit(f"{root}: the grads failed")
    failed = False
    for case, (rows, _) in CASES.items():
        a, b = (torch.load(os.path.join(OUT, f"{tag}-{rows}.pt")) for tag in roots)
        diff = {n: (a[n] - b[n]).abs().max().item() for n in NAMES if not torch.equal(a[n], b[n])}
        failed |= bool(diff)
        print(f"{case}: every grad equal to the bit to the other checkout's" if not diff else
              f"{case}: grads that differ (max |d|): {diff}")
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
