#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`bcnf_tpu_torch`) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one line each; any failure exits non-zero and prints no result:

1. device: the card's name and power limit, versions; build every kernel
   from the checkout's sources (`bcnf_tpu_torch/ops/csrc/`).
2. kernels: each kernel against its plain PyTorch version on the card, at
   the flagship widths, on a tiled and on a ragged shape.
3. main path: the flagship `trajectory_LSTM_large` model (48,852,615
   params, random weights from a seed) on the card: posterior sampling of
   10,000 draws for 8 trajectories, then `log_prob` and the round trip on
   4096 of them; the kernel's launch count is read for each; samples/s and
   each kernel's time beside its bound and its plain version's time.
4. entry point: the `sample` CLI on a model directory written here.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX or of `bcnf_tpu`.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = "{{BCNF_ROOT}}/configs/runs/trajectory_LSTM_large.yaml"  # resolves to this checkout
FLAGSHIP_PARAMS = 48_852_615
N_COND, M_DRAWS, LOGPROB_ROWS = 8, 10_000, 4096  # calibration protocol: M = 10,000 (bench.py:187)
SEED = 0
# Kernel vs plain, both float32 on the card: they differ only in the order of
# the sums (526-long dot products, 6 layers x 26 steps), which moves results
# by ~1e-6..1e-5 here; 1e-4 is the JAX package's own kernel-vs-XLA bar
# (tests/test_flow_kernel.py) and still catches a wrong layer or step.
KERNEL_TOL = 1e-4
# inverse then forward through 26 steps: the JAX package's round-trip bar
ROUNDTRIP_TOL = 5e-4
# Published dense peaks (NVIDIA data sheets) by card: float32 outside the
# tensor cores, and device-memory bandwidth.
PEAKS = {  # name fragment: (FLOP/s, bytes/s)
    "H100 PCIe": (51.2e12, 2.0e12),
    "H100 NVL": (60.0e12, 3.9e12),
    "H100": (66.9e12, 3.35e12),  # SXM5
    "H200": (66.9e12, 4.8e12),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def peaks_for(name: str) -> tuple[float, float]:
    for frag, peak in PEAKS.items():
        if frag in name:
            return peak
    fail(f"no published peak rates for {name!r}")
    raise AssertionError


def flow_work(kargs: dict, h_proj, rows: int, H: int) -> tuple[float, float]:
    """Operations and bytes one K1 call needs for `rows` rows at the
    unpadded hidden width H: each input read once, each output written once."""
    S, size = kargs["an_scale"].shape
    d_a, nh = kargs["w1y"].shape[1], kargs["wm"].shape[1]
    n_out = kargs["wout"].shape[-1]
    flops = rows * (S * 2 * (d_a * H + nh * H * H + H * n_out) + (S - 1) * 2 * size * size)
    weights = S * (2 * size + size * size + d_a * H + H + nh * (H * H + H) + H * n_out + n_out)
    nbytes = 4 * (weights + S * h_proj.shape[1] * H + 2 * rows * size + rows)
    return float(flops), float(nbytes)


def cuda_ms(fn, reps: int) -> list[float]:
    """Per-launch times in ms from CUDA events, after one warm-up call."""
    import torch

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
    return times


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, HERE)
    try:
        import bcnf_tpu_torch
    except ImportError as e:
        fail(f"the port's package is not beside this script: {e}")
    if os.path.dirname(os.path.abspath(bcnf_tpu_torch.__file__)) != os.path.join(HERE, "bcnf_tpu_torch"):
        fail(f"imported bcnf_tpu_torch from {bcnf_tpu_torch.__file__}, not from this checkout")
    from bcnf_tpu_torch import CondRealNVP
    from bcnf_tpu_torch.__main__ import main as cli_main
    from bcnf_tpu_torch.bridge import map_tree, params_to_numpy
    from bcnf_tpu_torch.config import load_config
    from bcnf_tpu_torch.models import count_params
    from bcnf_tpu_torch.ops import _build
    from bcnf_tpu_torch.ops.flow_kernel import fused_flow, fused_flow_reference

    # ---- 1. device + build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    peak_flops, peak_bw = peaks_for(kind)
    print(smi)
    t0 = time.perf_counter()
    _build.load_library("flow_kernel")
    ptxas = [ln.strip() for ln in _build.build_logs.get("flow_kernel", "").splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[1 device] {kind} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"kernels built+loaded in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds.get('flow_kernel', 0.0):.1f} s)")
    for ln in ptxas:
        print(f"    ptxas: {ln}")

    dev = torch.device("cuda")
    model = CondRealNVP.from_config(load_config(CONFIG))
    params = model.init(torch.Generator().manual_seed(SEED), device=dev)
    n_params = count_params(params)
    if n_params != FLAGSHIP_PARAMS:
        fail(f"flagship has {n_params:,} params, expected {FLAGSHIP_PARAMS:,}")
    H = model.nested_sizes[0]
    rng = np.random.default_rng(SEED)

    # ---- 2. kernel vs plain at flagship widths (ActNorm perturbed so it is exercised)
    an = params["blocks"]["actnorm"]
    k_params = dict(params, blocks=dict(params["blocks"], actnorm={
        "scale": an["scale"] + 0.1 * torch.from_numpy(rng.normal(size=an["scale"].shape).astype(np.float32)).to(dev),
        "bias": 0.1 * torch.from_numpy(rng.normal(size=an["bias"].shape).astype(np.float32)).to(dev),
    }))
    errs = {"inverse": 0.0, "forward": 0.0}
    before = fused_flow.launches
    for B, N in ((4096, 8), (4099, 7)):
        traj = torch.from_numpy(rng.normal(size=(N, 30, 3)).astype(np.float32)).to(dev)
        with torch.no_grad():
            kargs, h_proj = model._fused_flow_args(k_params, model.encode(k_params, (traj,)))
            x = torch.from_numpy(rng.normal(size=(B, model.size)).astype(np.float32)).to(dev)
            y_k = fused_flow(x, h_proj, **kargs, inverse=True, n_cond=N)
            y_r = fused_flow_reference(x, h_proj, **kargs, inverse=True, n_cond=N)
            z_k, ld_k = fused_flow(x, h_proj, **kargs, inverse=False, n_cond=N)
            z_r, ld_r = fused_flow_reference(x, h_proj, **kargs, inverse=False, n_cond=N)
            torch.cuda.synchronize()
        errs["inverse"] = max(errs["inverse"], (y_k - y_r).abs().max().item())
        errs["forward"] = max(errs["forward"], (z_k - z_r).abs().max().item(), (ld_k - ld_r).abs().max().item())
    if fused_flow.launches <= before:
        fail("fused_flow did not count its launches")
    print(f"[2 kernels] fused_flow vs plain at H={H}, B=4096/N=8 and ragged B=4099/N=7: "
          f"max|dy| inverse {errs['inverse']:.3e}, max|dz|,|dlogdet| forward {errs['forward']:.3e} "
          f"(tolerance {KERNEL_TOL:g})")
    for d, e in errs.items():
        if not e <= KERNEL_TOL:
            fail(f"fused_flow {d} disagrees with its plain version: {e:.3e} > {KERNEL_TOL:g}")

    # ---- 3. main path: posterior sampling, then log_prob + round trip
    traj = torch.from_numpy(rng.normal(size=(N_COND, 30, 3)).astype(np.float32))
    with torch.no_grad():
        model.sample(params, torch.Generator().manual_seed(SEED), 16, traj, device=dev)  # warm-up
        torch.cuda.synchronize()
        fused_flow.launches = 0
        t0 = time.perf_counter()
        samples = model.sample(params, torch.Generator().manual_seed(SEED), M_DRAWS, traj, device=dev)
        torch.cuda.synchronize()
        t_sample = time.perf_counter() - t0
        inv_launches = fused_flow.launches
    if inv_launches < 1:
        fail("posterior sampling did not go through the fused_flow kernel")
    if tuple(samples.shape) != (M_DRAWS, N_COND, model.size) or not torch.isfinite(samples).all():
        fail(f"samples of shape {tuple(samples.shape)} are not all finite / not the expected shape")
    z_all = torch.randn((M_DRAWS, N_COND, model.size), generator=torch.Generator().manual_seed(SEED))

    # the kernel's samples against the plain path on the CPU, for the first 64 draws
    cpu_params = map_tree(lambda t: t.cpu(), params)
    with torch.no_grad():
        ref = model.inverse_given_h(cpu_params, z_all[:64], model.encode(cpu_params, (traj,)))
    cpu_err = (samples[:64].cpu() - ref).abs().max().item()

    d = LOGPROB_ROWS // N_COND
    y_lp = samples[:d].reshape(LOGPROB_ROWS, model.size)
    cond_lp = traj.to(dev).repeat(d, 1, 1)
    with torch.no_grad():
        fused_flow.launches = 0
        lp = model.log_prob(params, y_lp, cond_lp)
        z_rt, _ = model.forward(params, y_lp, cond_lp)
        torch.cuda.synchronize()
        fwd_launches = fused_flow.launches
    if fwd_launches < 1:
        fail("log_prob did not go through the fused_flow kernel")
    rt_err = (z_rt.cpu() - z_all[:d].reshape(LOGPROB_ROWS, model.size)).abs().max().item()
    if not torch.isfinite(lp).all():
        fail("log_prob is not finite")
    print(f"[3 main path] {n_params:,} params; sample {M_DRAWS}x{N_COND} in {t_sample:.3f} s = "
          f"{M_DRAWS * N_COND / t_sample:.0f} samples/s, fused_flow launches {inv_launches}; "
          f"max|d| vs CPU plain path (64 draws) {cpu_err:.3e}; log_prob on {LOGPROB_ROWS} rows "
          f"(launches {fwd_launches}), round trip max|forward(sample) - z| {rt_err:.3e} "
          f"(tolerance {ROUNDTRIP_TOL:g}); mean log_prob {lp.mean().item():.3f}")
    if not cpu_err <= KERNEL_TOL:
        fail(f"samples disagree with the CPU plain path: {cpu_err:.3e} > {KERNEL_TOL:g}")
    if not rt_err <= ROUNDTRIP_TOL:
        fail(f"round trip error {rt_err:.3e} > {ROUNDTRIP_TOL:g}")

    # K1 timed at the main path's shapes: inverse over M*N rows, forward over the log_prob batch
    kernels = []
    with torch.no_grad():
        # where a sample call's time goes: the same steps as CondRealNVP.sample, host clock
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x_inv = torch.randn(z_all.shape, generator=torch.Generator().manual_seed(SEED)).to(dev).reshape(-1, model.size)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        kargs, h_proj = model._fused_flow_args(params, model.encode(params, (traj.to(dev),)))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        fused_flow(x_inv, h_proj, **kargs, inverse=True, n_cond=N_COND)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        print(f"    sample breakdown (host clock): z draw on CPU + copy {1e3 * (t1 - t0):.1f} ms, encode + "
              f"projections + stacked args {1e3 * (t2 - t1):.1f} ms, kernel {1e3 * (t3 - t2):.1f} ms")
        hl = model.encode(params, (cond_lp,))
        kargs_f, h_proj_f = model._fused_flow_args(params, hl)
        shapes = {
            "inverse": (x_inv, kargs, h_proj, N_COND, inv_launches, True),
            "forward": (y_lp.contiguous(), kargs_f, h_proj_f, LOGPROB_ROWS, fwd_launches, False),
        }
        saved = fused_flow.launches
        for direction, (x, ka, hp, n, launches, inv) in shapes.items():
            # the kernel against its plain version at exactly the main path's inputs too
            out_k = fused_flow(x, hp, **ka, inverse=inv, n_cond=n)
            out_p = fused_flow_reference(x, hp, **ka, inverse=inv, n_cond=n)
            err = max((a - b).abs().max().item() for a, b in zip(
                (out_k,) if inv else out_k, (out_p,) if inv else out_p))
            if not err <= KERNEL_TOL:
                fail(f"fused_flow {direction} at the main path's shape disagrees with plain: {err:.3e}")
            errs[direction] = max(errs[direction], err)
            k_times = cuda_ms(lambda: fused_flow(x, hp, **ka, inverse=inv, n_cond=n), reps=5)
            p_times = cuda_ms(lambda: fused_flow_reference(x, hp, **ka, inverse=inv, n_cond=n), reps=3)
            ms, plain_ms = sorted(k_times)[len(k_times) // 2], sorted(p_times)[len(p_times) // 2]
            flops, nbytes = flow_work(ka, hp, x.shape[0], H)
            t_ops, t_bytes = 1e3 * flops / peak_flops, 1e3 * nbytes / peak_bw
            kernels.append({
                "name": f"fused_flow[{direction}]",
                "route": "cuda",
                "source": "bcnf_tpu_torch/ops/csrc/flow_kernel.cu",
                "replaces": "bcnf_tpu/ops/flow_kernel.py:162",
                "launches": launches,
                "max_abs_err": errs[direction],
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": None,
            })
            tile = 64 if hp.shape[-1] <= 32 * 17 else 32  # the kernel's rows per block (csrc/flow_kernel.cu)
            l2_gb = -(-x.shape[0] // tile) * 4 * sum(int(v.numel()) for v in ka.values()) / 1e9
            print(f"    fused_flow[{direction}] rows {x.shape[0]}: {ms:.2f} ms (bound {max(t_ops, t_bytes):.2f} ms, "
                  f"{flops / 1e12:.2f} TFLOP -> {flops / ms / 1e9:.1f} TFLOP/s, median of {len(k_times)}, "
                  f"range {min(k_times):.2f}-{max(k_times):.2f}), plain {plain_ms:.2f} ms "
                  f"(range {min(p_times):.2f}-{max(p_times):.2f}); "
                  f"max|d| vs plain {err:.2e}; weights re-read from L2 per call ~{l2_gb:.0f} GB")
        fused_flow.launches = saved

    # ---- 4. the sample CLI on a model directory as `bcnf-tpu train` writes it
    build_dir = os.path.join(HERE, "bcnf_tpu_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        with open(os.path.join(tmp, "params.pkl"), "wb") as f:
            pickle.dump(params_to_numpy(params), f)
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump({"config_path": CONFIG}, f)
        names = list(model.parameter_index_mapping.parameters)
        data = {"trajectories": rng.normal(size=(4, 30, 3)).astype(np.float32)}
        data.update({p: rng.normal(size=4).astype(np.float32) for p in names})
        with open(os.path.join(tmp, "data.pkl"), "wb") as f:
            pickle.dump(data, f)
        out = os.path.join(tmp, "samples.npy")
        fused_flow.launches = 0
        cli_main(["sample", "-m", tmp, "-d", os.path.join(tmp, "data.pkl"), "-n", "100", "-o", out, "--seed", "1"])
        cli = np.load(out)
        cli_launches = fused_flow.launches
    if cli.shape != (100, 4, model.size) or not np.isfinite(cli).all() or cli_launches < 1:
        fail(f"sample CLI gave shape {cli.shape}, finite={np.isfinite(cli).all()}, launches={cli_launches}")
    print(f"[4 entry point] bcnf_tpu_torch sample: {cli.shape} finite, fused_flow launches {cli_launches}")

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
