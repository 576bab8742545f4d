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
5. training kernels: K2a (the whole-flow training forward) and K2b (its
   backward) against their plain PyTorch versions at the flagship widths,
   B = 4096 and a ragged B = 4099, every output and every grad (pulled
   back from standard-normal cotangents; each grad's largest value printed
   beside its error).
6. training main path: `Trainer.train` on the full flagship (coupling
   dropout 0, as bench.py's flagship) at batch 4096 (2 epochs of 3 batches)
   and at batch 256 (1 epoch of 3 batches), on random y and trajectories
   from a seed, launches counted; one step through the kernels against the
   plain autograd step on the same batch; train samples/s through the
   kernels and with the gate closed, a CUDA-event split of one step, and
   K2a/K2b's times beside their bounds and their plain versions' times.
7. entry point: the `train` CLI on a written dataset with a copy of the
   flagship config (`model.kwargs.dropout: 0`, 2 epochs), then `sample` from
   the model directory it wrote.

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
# grads, kernel against plain: the JAX package's grad bar
# (tests/test_flow_kernel.py:313), |d| <= atol + rtol * |plain|, with the
# atol capped at GRAD_REL of the grad's largest value, so that the bar stays
# well below the values of a grad at any scale (an absolute atol set at
# B = 16 sits above the values of small grads at B = 4096). The grads are
# pulled back from standard-normal cotangents on z and logdet (as the `gpu`
# tests do): no sum cancels, as the summed NLL's constant logdet cotangent
# makes the ActNorm scale grad's do, past what float32 resolves.
GRAD_ATOL, GRAD_RTOL, GRAD_REL = 5e-4, 1e-3, 1e-4
TRAIN_ARGS = ("an_scale", "an_bias", "ortho", "w1y", "b1", "wm", "bm", "wout", "bout")
GRAD_NAMES = ("dx", "dh_proj", "dan_scale", "dan_bias", "dw1y", "db1", "dwm", "dbm", "dwout", "dbout")
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


def train_work(kargs: dict, h_proj, rows: int, H: int) -> tuple[tuple[float, float], tuple[float, float]]:
    """(operations, bytes) of one K2a call and of one K2b call for `rows`
    rows with their own conditions, at the unpadded hidden width H. K2a is
    K1's forward plus the (S, rows, size) step inputs it writes. K2b, from
    those inputs, recomputes each step's MLP, multiplies the cotangents back
    through the transposed weights, and forms the weight products: three
    times the forward's matmul work, plus the mixes' transposes; it reads the
    step inputs, h_proj, dz, dld and the weights once and writes dx, dh_proj
    and the weight grads once."""
    S, size = kargs["an_scale"].shape
    d_a, nh = kargs["w1y"].shape[1], kargs["wm"].shape[1]
    n_out = kargs["wout"].shape[-1]
    f_ops, f_bytes = flow_work(kargs, h_proj, rows, H)
    mlp = rows * S * 2 * (d_a * H + nh * H * H + H * n_out)
    mixes = rows * (S - 1) * 2 * size * size
    weights = S * (2 * size + size * size + d_a * H + H + nh * (H * H + H) + H * n_out + n_out)
    b_bytes = 4 * (2 * weights + 2 * S * rows * H + S * rows * size + 2 * rows * size + rows)
    return (f_ops, f_bytes + 4.0 * S * rows * size), (float(3 * mlp + mixes), float(b_bytes))


def grad_excess(got, ref) -> tuple[float, float, float]:
    """(max |got - ref|, max of |got - ref| - (atol + GRAD_RTOL |ref|),
    max |ref|), with atol = min(GRAD_ATOL, GRAD_REL max |ref|): the second is
    <= 0 when every element is inside the grad bar."""
    d, mag = (got - ref).abs(), ref.abs().max().item()
    atol = min(GRAD_ATOL, GRAD_REL * mag)
    return d.max().item(), (d - atol - GRAD_RTOL * ref.abs()).max().item(), mag


def randn_cotangents(z):
    """Standard-normal cotangents (dz, dlogdet) for z's rows, from the seed."""
    import torch

    gen = torch.Generator(device=z.device).manual_seed(SEED)
    return (torch.randn(z.shape, generator=gen, device=z.device),
            torch.randn((z.shape[0],), generator=gen, device=z.device))


def check_grads(what: str, names, got, ref) -> float:
    """Hold each grad against its plain version at the grad bar. Prints
    max |plain| and max |d| for every grad, then fails where one is outside
    the bar. Returns the largest max |d|."""
    worst, faults = 0.0, []
    for name, a, b in zip(names, got, ref):
        d, excess, mag = grad_excess(a, b)
        worst = max(worst, d)
        print(f"      {what} {name}: max|plain| {mag:.3e}, max|d| {d:.3e}")
        if excess > 0:
            faults.append(f"{name} is {excess:.3e} past the grad bar")
    if faults:
        fail(f"{what}: " + "; ".join(faults))
    return worst


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
    _build.build_all()  # one nvcc per source, all started together
    for name in _build.SOURCES:
        _build.load_library(name)
    nvcc_s = ", ".join(f"{name} {sec:.1f} s" for name, sec in _build.build_seconds.items())
    print(f"[1 device] {kind} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"kernels built+loaded in {time.perf_counter() - t0:.1f} s (nvcc: {nvcc_s or 'cached'})")
    for name, log in _build.build_logs.items():
        for ln in log.splitlines():
            if "registers" in ln or ("spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln):
                print(f"    ptxas {name}: {ln.strip()}")

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

    check_train_kernels(model, k_params, rng, dev)
    kernels += train_main_path(rng, dev, peak_flops, peak_bw)
    train_cli(rng, build_dir)

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


def check_train_kernels(model, k_params: dict, rng, dev) -> None:
    """Phase 5: K2a and K2b against their plain versions at the flagship
    widths, on B = 4096 and a ragged B = 4099 (rows with their own
    conditions), fed standard-normal cotangents. Launches here do not count."""
    import numpy as np
    import torch

    from bcnf_tpu_torch.ops.flow_kernel import (
        fused_flow_train_backward_reference,
        fused_flow_train_bwd,
        fused_flow_train_fwd,
        fused_flow_train_reference,
    )

    saved = fused_flow_train_fwd.launches, fused_flow_train_bwd.launches
    print(f"[5 training kernels] K2a vs plain at the flagship widths, B=4096 and ragged B=4099; K2b vs plain, "
          f"10 grads from standard-normal cotangents (bar |d| <= min({GRAD_ATOL:g}, "
          f"{GRAD_REL:g} max|plain|) + {GRAD_RTOL:g}|plain|):")
    fwd_err, bwd_err = 0.0, 0.0
    for B in (4096, 4099):
        traj = torch.from_numpy(rng.normal(size=(B, 30, 3)).astype(np.float32)).to(dev)
        with torch.no_grad():
            kargs, h_proj = model._fused_flow_args(k_params, model.encode(k_params, (traj,)))
            args = [kargs[n] for n in TRAIN_ARGS]
            x = torch.from_numpy(rng.normal(size=(B, model.size)).astype(np.float32)).to(dev)
            out_k = fused_flow_train_fwd(x, h_proj, *args)
            z, ld, bound = fused_flow_train_reference(x, h_proj, *args)
            fwd_err = max([fwd_err] + [(a - b).abs().max().item() for a, b in zip(out_k, (z, ld, bound))])
            dz, dld = randn_cotangents(z)
            grads_k = fused_flow_train_bwd(bound, h_proj, dz, dld, *args)
            grads_p = fused_flow_train_backward_reference(bound, h_proj, dz, dld, *args)
            torch.cuda.synchronize()
        bwd_err = max(bwd_err, check_grads(f"K2b B={B}", GRAD_NAMES, grads_k, grads_p))
    if fused_flow_train_fwd.launches != saved[0] + 2 or fused_flow_train_bwd.launches != saved[1] + 2:
        fail("the training kernels did not count their launches")
    fused_flow_train_fwd.launches, fused_flow_train_bwd.launches = saved
    print(f"    K2a max|d| over z, logdet, step inputs {fwd_err:.3e} (tolerance {KERNEL_TOL:g}); "
          f"K2b max|d| over the 10 grads {bwd_err:.3e}")
    if not fwd_err <= KERNEL_TOL:
        fail(f"K2a disagrees with its plain version: {fwd_err:.3e} > {KERNEL_TOL:g}")


def _flagship_train_config(batch_size: int, n_epochs: int) -> dict:
    """The flagship's run config with coupling dropout 0 (so the training
    kernels' gate is open, as bench.py's flagship has it)."""
    from bcnf_tpu_torch.config import load_config

    cfg = load_config(CONFIG).to_dict()
    cfg["model"]["kwargs"]["dropout"] = 0.0
    cfg["training"].update(batch_size=batch_size, n_epochs=n_epochs, timeout=None)
    return cfg


def train_main_path(rng, dev, peak_flops: float, peak_bw: float) -> list[dict]:
    """Phase 6: the training main path on the full flagship; returns the
    K2a/K2b rows of the kernel table."""
    import numpy as np
    import torch

    from bcnf_tpu_torch.bridge import map_tree, tree_leaves
    from bcnf_tpu_torch.models import CondRealNVP
    from bcnf_tpu_torch.ops.flow_kernel import (
        fused_flow,
        fused_flow_train,
        fused_flow_train_backward_reference,
        fused_flow_train_bwd,
        fused_flow_train_fwd,
        fused_flow_train_reference,
    )
    from bcnf_tpu_torch.train import Trainer, make_optimizer
    from bcnf_tpu_torch.utils.misc import inn_nll_loss

    def trainable(p):
        return map_tree(lambda t: t.detach().clone().requires_grad_(True), p)

    launches = {"K2a": 0, "K2b": 0}
    rates, plain_rates, shapes = {}, {}, None
    for B, n_epochs in ((4096, 2), (256, 1)):
        cfg = _flagship_train_config(B, n_epochs)
        model = CondRealNVP.from_config(cfg)
        n = int(round(3 * B / (1 - cfg["training"]["validation_split"])))  # 3 training batches an epoch
        y = rng.normal(size=(n, model.size)).astype(np.float32)  # random y and trajectories, as bench.py
        traj = rng.normal(size=(n, 30, 3)).astype(np.float32)
        params0 = model.init(torch.Generator().manual_seed(SEED), device=dev)
        trainer = Trainer(cfg, data=(y, [traj]), device=dev, seed=SEED)
        torch.cuda.synchronize()
        fused_flow_train_fwd.launches = fused_flow_train_bwd.launches = fused_flow.launches = 0
        t0 = time.perf_counter()
        trained = trainer.train(model, params0)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        k2a, k2b, k1 = fused_flow_train_fwd.launches, fused_flow_train_bwd.launches, fused_flow.launches
        launches["K2a"] += k2a
        launches["K2b"] += k2b
        hist = trainer.meta_scheduler.parameter_history
        losses = [v for _, v in hist["train_loss"]] + [v for _, v in hist["val_loss"]]
        steps = 3 * n_epochs
        if k2a != steps or k2b != steps:
            fail(f"Trainer.train at batch {B} launched K2a {k2a} and K2b {k2b} times for {steps} steps")
        if not (np.all(np.isfinite(losses)) and all(torch.isfinite(t).all() for t in tree_leaves(trained))):
            fail(f"Trainer.train at batch {B} gave non-finite losses or params: {losses}")

        # train samples/s: training steps alone, host clock around synchronised work
        params = trainable(trained)
        opt = make_optimizer("Adam", lr=2e-4).init(params)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        yb = torch.from_numpy(y[:B]).to(dev)
        cb = [torch.from_numpy(traj[:B]).to(dev)]
        saved = fused_flow_train_fwd.launches, fused_flow_train_bwd.launches
        trainer.train_step(model, params, opt, yb, cb, gen)
        torch.cuda.synchronize()
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            metrics = trainer.train_step(model, params, opt, yb, cb, gen)
        torch.cuda.synchronize()
        rates[B] = reps * B / (time.perf_counter() - t0)
        # the same steps with the kernel gate closed: the plain autograd composition
        model.use_pallas = False
        trainer.train_step(model, params, opt, yb, cb, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            trainer.train_step(model, params, opt, yb, cb, gen)
        torch.cuda.synchronize()
        plain_rates[B] = reps * B / (time.perf_counter() - t0)
        model.use_pallas = True
        print(f"[6 training, batch {B}] Trainer.train: {n_epochs} epoch(s) x 3 steps + validation in "
              f"{t_train:.2f} s; launches K2a {k2a}, K2b {k2b}, K1 (validation) {k1}; losses "
              f"{', '.join(f'{v:.3f}' for v in losses)}; {rates[B]:.0f} train samples/s through the kernels, "
              f"{plain_rates[B]:.0f} with the gate closed (plain autograd) (last step loss {metrics[0].item():.3f})")
        if B != 4096:
            fused_flow_train_fwd.launches, fused_flow_train_bwd.launches = saved
            continue

        # one step's forward and backward through the kernels against the
        # plain autograd ones on the same batch: the NLL's value, and the
        # grads of every param pulled back from standard-normal cotangents
        losses, grads, used = [], [], []
        for use_kernels in (True, False):
            model.use_pallas = use_kernels
            p = trainable(trained)
            before = fused_flow_train_fwd.launches + fused_flow_train_bwd.launches
            z, ld = model.forward(p, yb, *cb, train=True)
            dz, dld = randn_cotangents(z)
            ((z * dz).sum() + (ld * dld).sum()).backward()
            used.append(fused_flow_train_fwd.launches + fused_flow_train_bwd.launches - before)
            losses.append(inn_nll_loss(z, ld).item())
            grads.append([t.grad for t in tree_leaves(p)])
        model.use_pallas = True
        if used != [2, 0]:
            fail(f"the step check launched the training kernels {used} times (kernel side, plain side)")
        loss_k, loss_p = losses
        worst, max_d, mags = -1.0, 0.0, []
        for a, b in zip(*grads):
            if a is not None and b is not None:
                d, excess, mag = grad_excess(a, b)
                worst, max_d = max(worst, excess), max(max_d, d)
                mags.append(mag)
        loss_d = abs(loss_k - loss_p)
        print(f"    step through K2a/K2b vs plain autograd step (batch {B}): loss {loss_k:.5f} vs {loss_p:.5f}; "
              f"{len(mags)} param grads from standard-normal cotangents, max|d| {max_d:.3e} (bar |d| <= "
              f"min({GRAD_ATOL:g}, {GRAD_REL:g} max|plain|) + {GRAD_RTOL:g}|plain|), max|plain| per grad from {min(mags):.3e} to {max(mags):.3e}")
        if not loss_d <= KERNEL_TOL * max(1.0, abs(loss_p)) or worst > 0:
            fail(f"the kernels' training step disagrees with the plain one: loss |d| {loss_d:.3e}, "
                 f"grads {worst:.3e} past the bar")

        # CUDA-event split of one step: the same calls as Trainer.train_step
        splits = []
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
            opt.zero_grad()
            ev[0].record()
            h = model.encode(params, cb, gen, train=True)
            ev[1].record()
            kargs, h_proj = model._fused_flow_args(params, h)
            ev[2].record()
            z, ld = fused_flow_train(yb, h_proj, *[kargs[k] for k in TRAIN_ARGS])
            ev[3].record()
            loss = inn_nll_loss(z, ld)
            ev[4].record()
            loss.backward()
            ev[5].record()
            opt.step()
            ev[6].record()
            torch.cuda.synchronize()
            splits.append([ev[i].elapsed_time(ev[i + 1]) for i in range(6)])
        split = [sorted(c)[1] for c in zip(*splits)]
        shapes = (yb.detach(), h_proj.detach(), [kargs[k].detach() for k in TRAIN_ARGS], model)
        copies = weight_copies_ms(model, params, dev)
        device_profile(lambda: trainer.train_step(model, params, opt, yb, cb, gen))
        fused_flow_train_fwd.launches, fused_flow_train_bwd.launches = saved

    # K2a/K2b at the main path's batch-4096 inputs: kernel, plain, bound
    x, h_proj, args, model = shapes
    H = model.nested_sizes[0]
    saved = fused_flow_train_fwd.launches, fused_flow_train_bwd.launches
    with torch.no_grad():
        z, ld, bound = fused_flow_train_fwd(x, h_proj, *args)
        z_r, ld_r, bound_r = fused_flow_train_reference(x, h_proj, *args)
        fwd_err = max((a - b).abs().max().item() for a, b in zip((z, ld, bound), (z_r, ld_r, bound_r)))
        B = x.shape[0]
        dz, dld = randn_cotangents(z)
        grads_k = fused_flow_train_bwd(bound, h_proj, dz, dld, *args)
        grads_p = fused_flow_train_backward_reference(bound, h_proj, dz, dld, *args)
        if not fwd_err <= KERNEL_TOL:
            fail(f"K2a at the main path's inputs disagrees with plain: {fwd_err:.3e} > {KERNEL_TOL:g}")
        print(f"    K2a/K2b at the main path's batch-{B} inputs: K2a max|d| {fwd_err:.3e}; K2b:")
        bwd_err = check_grads("K2b main path", GRAD_NAMES, grads_k, grads_p)
        times = {
            "K2a": (cuda_ms(lambda: fused_flow_train_fwd(x, h_proj, *args), reps=5),
                    cuda_ms(lambda: fused_flow_train_reference(x, h_proj, *args), reps=3)),
            "K2b": (cuda_ms(lambda: fused_flow_train_bwd(bound, h_proj, dz, dld, *args), reps=5),
                    cuda_ms(lambda: fused_flow_train_backward_reference(bound, h_proj, dz, dld, *args), reps=3)),
        }
    fused_flow_train_fwd.launches, fused_flow_train_bwd.launches = saved
    work = dict(zip(("K2a", "K2b"), train_work({k: v for k, v in zip(TRAIN_ARGS, args)}, h_proj, B, H)))
    rows = []
    for name, err, src, replaces, fn in (
        ("K2a", fwd_err, "bcnf_tpu_torch/ops/csrc/flow_kernel.cu", "bcnf_tpu/ops/flow_kernel.py:558",
         "fused_flow_train_fwd"),
        ("K2b", bwd_err, "bcnf_tpu_torch/ops/csrc/flow_train_kernel.cu", "bcnf_tpu/ops/flow_kernel.py:600",
         "fused_flow_train_bwd"),
    ):
        k_times, p_times = times[name]
        ms, plain_ms = sorted(k_times)[len(k_times) // 2], sorted(p_times)[len(p_times) // 2]
        flops, nbytes = work[name]
        t_ops, t_bytes = 1e3 * flops / peak_flops, 1e3 * nbytes / peak_bw
        rows.append({
            "name": f"{name} {fn}", "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
        })
        print(f"    {name} rows {B}: {ms:.2f} ms (bound {max(t_ops, t_bytes):.2f} ms, {flops / 1e12:.3f} TFLOP -> "
              f"{flops / ms / 1e9:.1f} TFLOP/s, median of {len(k_times)}, range {min(k_times):.2f}-"
              f"{max(k_times):.2f}), plain {plain_ms:.2f} ms (range {min(p_times):.2f}-{max(p_times):.2f}); "
              f"max|d| vs plain {err:.2e}")
    k2b_ms = rows[1]["ms"]
    print(f"    step split at batch 4096 (CUDA events, median of 3, ms): encoder forward {split[0]:.2f}, "
          f"condition projections + stacking {split[1]:.2f}, K2a {split[2]:.2f}, loss {split[3]:.2f}, "
          f"backward {split[4]:.2f} (K2b alone {k2b_ms:.2f}, so the rest of autograd ~{split[4] - k2b_ms:.2f}), "
          f"clip + Adam {split[5]:.2f}; step {sum(split):.2f} = {4096 / sum(split) * 1e3:.0f} samples/s")
    print(f"    per-step weight copies (stack_flow_params + pad_hidden, {copies[2] / 1e6:.0f} MB of kernel "
          f"arguments; CUDA events, median of 5): forward {copies[0]:.2f} ms, its backward (grads sliced back "
          f"to the param tree) {copies[1]:.2f} ms")
    print(f"    train samples/s: {rates[4096]:.0f} at batch 4096, {rates[256]:.0f} at batch 256; with the gate "
          f"closed (plain autograd): {plain_rates[4096]:.0f} and {plain_rates[256]:.0f}")
    return rows


def weight_copies_ms(model, params: dict, dev) -> tuple[float, float, int]:
    """Time the stacking and padding of the flow's weights into the kernels'
    arguments, forward and backward, alone: (forward ms, backward ms, bytes)."""
    import torch

    from bcnf_tpu_torch.ops.flow_kernel import pad_hidden, stack_flow_params

    h_proj = torch.zeros((1, 1, model.nested_sizes[0]), device=dev)
    fwd, bwd = [], []
    for _ in range(6):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        kargs, _ = pad_hidden(stack_flow_params(model, params), h_proj)
        ev[1].record()
        outs = [v for v in kargs.values() if v.requires_grad]
        torch.autograd.backward(outs, [torch.ones_like(v) for v in outs])
        ev[2].record()
        torch.cuda.synchronize()
        fwd.append(ev[0].elapsed_time(ev[1]))
        bwd.append(ev[1].elapsed_time(ev[2]))
    nbytes = sum(4 * v.numel() for v in kargs.values())
    return sorted(fwd[1:])[2], sorted(bwd[1:])[2], nbytes


def device_profile(step) -> None:
    """One training step under `torch.profiler`: the device's busy share and
    the kernels that take most of its time. Prints what the profiler saw;
    a profiler that records no device time is reported, not a failure."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # kernels only: the host-side ops' entries repeat their kernels' device time
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    if not kernels:
        print("    profiler: no device time recorded; the CUDA-event split stands alone")
        return
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"    profiler, one step at batch 4096: kernels busy {busy_ms:.1f} ms of {wall_ms:.1f} ms wall "
          f"(device idle share {max(0.0, 1 - busy_ms / wall_ms):.1%}, profiler on); top kernels by device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"      {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:90]}")


def train_cli(rng, build_dir: str) -> None:
    """Phase 7: `python -m bcnf_tpu_torch train` on a written dataset with a
    copy of the flagship config (coupling dropout 0, 2 epochs of 2 batches of
    256), then `sample` from the model directory it wrote."""
    import numpy as np
    import yaml

    from bcnf_tpu_torch.__main__ import main as cli_main
    from bcnf_tpu_torch.ops.flow_kernel import fused_flow, fused_flow_train_bwd, fused_flow_train_fwd

    cfg = _flagship_train_config(256, 2)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        cfg_path, data_path = os.path.join(tmp, "run.yaml"), os.path.join(tmp, "data.pkl")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f)
        n = 640  # 512 training rows (2 batches) + 128 validation rows
        data = {"trajectories": rng.normal(size=(n, 30, 3)).astype(np.float32)}
        data.update({p: rng.normal(size=n).astype(np.float32) for p in cfg["global"]["parameter_selection"]})
        with open(data_path, "wb") as f:
            pickle.dump(data, f)
        model_dir, out = os.path.join(tmp, "model"), os.path.join(tmp, "samples.npy")
        fused_flow_train_fwd.launches = fused_flow_train_bwd.launches = 0
        cli_main(["train", "-c", cfg_path, "-d", data_path, "-o", model_dir, "--seed", "1"])
        k2a, k2b = fused_flow_train_fwd.launches, fused_flow_train_bwd.launches
        fused_flow.launches = 0
        cli_main(["sample", "-m", model_dir, "-d", data_path, "-n", "20", "-o", out, "--seed", "2"])
        samples, k1 = np.load(out), fused_flow.launches
    if k2a != 4 or k2b != 4:
        fail(f"the train CLI launched K2a {k2a} and K2b {k2b} times for 4 steps")
    if samples.shape != (20, n, 19) or not np.isfinite(samples).all() or k1 != 1:
        fail(f"sample after train gave shape {samples.shape}, finite={np.isfinite(samples).all()}, K1 launches {k1}")
    print(f"[7 entry point] bcnf_tpu_torch train (2 epochs x 2 steps of 256): K2a {k2a}, K2b {k2b} launches; "
          f"then sample from its model directory: {samples.shape} finite, K1 launches {k1}")


if __name__ == "__main__":
    main()
