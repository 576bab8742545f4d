#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`bcnf_tpu_torch`) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one line each; any failure exits non-zero and prints no result:

1. device: the card's name and power limit, versions; build every kernel
   from the checkout's sources (`bcnf_tpu_torch/ops/csrc/`).
2. kernels: each kernel against its plain PyTorch version on the card, at
   the flagship widths, on a tiled and on a ragged shape: K1 in its default
   mode (3xTF32: the inverse on `wgmma`, the forward on the row tiles) and in
   strict mode (float32 FMA).
3. main path: the flagship `trajectory_LSTM_large` model (48,852,615
   params, random weights from a seed) on the card: posterior sampling of
   10,000 draws for 8 trajectories, then `log_prob` and the round trip on
   4096 of them, first in the default mode and then with `pallas_strict`;
   K1's launches by route are read for each; samples/s, the split of a
   `sample` call (with the `wgmma` weight preparation), the `wgmma`
   inverse's blocks and waves, and each K1 kernel's time beside its bound
   and its plain version's time.
4. entry point: the `sample` CLI on a model directory written here.
5. training kernels: K2a (the whole-flow training forward) and K2b (its
   backward), both on tensor cores in 3xTF32, against their plain PyTorch versions
   at the flagship widths, B = 4096 and a ragged B = 4099, every output and
   every grad (pulled back from standard-normal cotangents; each grad's
   largest value printed beside its error).
6. training main path: `Trainer.train` on the full flagship (coupling
   dropout 0, as bench.py's flagship) at batch 4096 (2 epochs of 3 batches)
   and at batch 256 (1 epoch of 3 batches), on random y and trajectories
   from a seed, launches counted; one step through the kernels against the
   plain autograd step on the same batch; train samples/s through the
   kernels and with the gate closed, a CUDA-event split of one step, and
   K2a/K2b's times beside their bounds and their plain versions' times;
   K2b's parts alone: its 26 rows kernels, its 26 weight-grad passes.
7. entry point: the `train` CLI on a written dataset with a copy of the
   flagship config (`model.kwargs.dropout: 0`, 2 epochs), then `sample` from
   the model directory it wrote.
8. LSTM kernels: K3a (one direction's recurrence) and K3b (its backward),
   both on tensor cores in 3xTF32, against their plain PyTorch versions at
   the flagship encoder's shapes
   (B = 4096 and a ragged 4099, T = 30, H = 140, layers of 3 and 280
   inputs) and t_DLSTM_large's (H = 128, T = 30 and 16), both directions;
   their times beside cuDNN's one-layer LSTM (`torch.nn.LSTM`, timed as a
   yardstick only, never on the port's path); K3a's cluster rows and wave
   count at batch 4096; K3b's parts alone: the cluster recurrence and the
   dW_hh pass.
9. path A: the flagship with BCNF_FUSED_LSTM=1: sampling 10,000 x 8 (K3a
   4, K1 1) against phase 3's samples; `Trainer.train` at batch 4096 and
   256 (K3a/K3b 4 a step, K2a/K2b); a training step through K3a/K3b against
   the time-loop encoder's; train samples/s both ways; the `train` CLI.
10. path B: `configs/runs/nll/t_DLSTM_large.yaml` at its published widths
   (DualDomainLSTM, 37,053,181 params, random weights from the seed) with
   BCNF_FUSED_LSTM=1: sampling (K3a 16, K1 1) against the time loop's,
   `Trainer.train` at batch 256 and 4096 (K3a/K3b 16 a step; the flow on
   plain autograd, its coupling dropout 0.5 closing the training-kernel
   gate), a step against the time loop's, then `train` -> `sample` CLI.
11. path C: K4 (the per-coupling kernel: K1's kernels at one step, 3xTF32)
   against its plain version at the flagship widths, 4096 and 4099 rows,
   forward and inverse; the flagship with `use_pallas_coupling`: the inverse
   of phase 3's 80,000 sampling rows through 26 K4 launches against K1's
   samples, and the no-grad forward against K1's; K4's times with the cost
   of the weights' preparation it does each launch.

The line before the last is the kernel table as JSON (each row with its
arithmetic, `arith`: float32 FMA, or 3xTF32 on the tensor cores, and its
bound at that arithmetic's peak); the last line is
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
# the LSTM kernels against their plain versions: the JAX package's bars for
# its LSTM kernel (tests/test_lstm_kernel.py:30, 48), hs and cs 1e-5, grads
# atol 1e-4 (capped at GRAD_REL of the grad's largest value) and rtol 1e-4
LSTM_TOL, LSTM_GRAD_ATOL, LSTM_GRAD_RTOL = 1e-5, 1e-4, 1e-4
DLSTM_CONFIG = "{{BCNF_ROOT}}/configs/runs/nll/t_DLSTM_large.yaml"
DLSTM_PARAMS = 37_053_181
TRAIN_ARGS = ("an_scale", "an_bias", "ortho", "w1y", "b1", "wm", "bm", "wout", "bout")
GRAD_NAMES = ("dx", "dh_proj", "dan_scale", "dan_bias", "dw1y", "db1", "dwm", "dbm", "dwout", "dbout")
# Published dense peaks (NVIDIA data sheets) by card: float32 outside the
# tensor cores, TF32 on the tensor cores, and device-memory bandwidth.
PEAKS = {  # name fragment: (float32 FLOP/s, TF32 FLOP/s, bytes/s)
    "H100 PCIe": (51.2e12, 378e12, 2.0e12),
    "H100 NVL": (60.0e12, 417.5e12, 3.9e12),
    "H100": (66.9e12, 494.7e12, 3.35e12),  # SXM5
    "H200": (66.9e12, 494.7e12, 4.8e12),
}
# A kernel's arithmetic, and the rate its operations are bounded by: float32
# FMA at the float32 peak; 3xTF32 (three tensor-core products a product,
# csrc/mma_tf32.cuh) at a third of the TF32 peak.
ARITH_FMA, ARITH_3XTF32 = "fp32-fma", "3xtf32"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def peaks_for(name: str) -> tuple[float, float, float]:
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


def grad_excess(got, ref, atol: float = GRAD_ATOL, rtol: float = GRAD_RTOL) -> tuple[float, float, float]:
    """(max |got - ref|, max of |got - ref| - (atol' + rtol |ref|),
    max |ref|), with atol' = min(atol, GRAD_REL max |ref|): the second is
    <= 0 when every element is inside the grad bar."""
    d, mag = (got - ref).abs(), ref.abs().max().item()
    cap = min(atol, GRAD_REL * mag)
    return d.max().item(), (d - cap - rtol * ref.abs()).max().item(), mag


def randn_cotangents(z):
    """Standard-normal cotangents (dz, dlogdet) for z's rows, from the seed."""
    import torch

    gen = torch.Generator(device=z.device).manual_seed(SEED)
    return (torch.randn(z.shape, generator=gen, device=z.device),
            torch.randn((z.shape[0],), generator=gen, device=z.device))


def check_grads(what: str, names, got, ref, atol: float = GRAD_ATOL, rtol: float = GRAD_RTOL) -> float:
    """Hold each grad against its plain version at the grad bar. Prints
    max |plain| and max |d| for every grad, then fails where one is outside
    the bar. Returns the largest max |d|."""
    worst, faults = 0.0, []
    for name, a, b in zip(names, got, ref):
        d, excess, mag = grad_excess(a, b, atol, rtol)
        worst = max(worst, d)
        print(f"      {what} {name}: max|plain| {mag:.3e}, max|d| {d:.3e}")
        if excess > 0:
            faults.append(f"{name} is {excess:.3e} past the grad bar")
    if faults:
        fail(f"{what}: " + "; ".join(faults))
    return worst


def kernel_label(ptxas_line: str) -> str:
    """`name<template args>` of the kernel a ptxas "Compiling entry
    function '<mangled name>'" line names (its last name component)."""
    import re

    mangled = ptxas_line.split("'")[1] if "'" in ptxas_line else ""
    pos, name = (3, "") if mangled.startswith("_ZN") else (2, "")
    while pos < len(mangled) and mangled[pos].isdigit():  # <length><name> components
        m = re.match(r"\d+", mangled[pos:])
        n = int(m.group(0))
        pos += len(m.group(0))
        name, pos = mangled[pos: pos + n], pos + n
    m = re.match(r"I((?:L[ib]\d+E)+)E", mangled[pos:])
    args = re.findall(r"L[ib](\d+)E", m.group(1)) if m else []
    return (name or "?") + (f"<{','.join(args)}>" if args else "")


def zero_flow_counts() -> None:
    """K1's launch counts to 0: in all, and by route."""
    from bcnf_tpu_torch.ops.flow_kernel import fused_flow

    fused_flow.launches = 0
    fused_flow.route_launches.clear()


def route_rows(route: str, Hp: int) -> int:
    """Rows a block of K1's kernel on `route` owns at the padded width Hp
    (csrc/flow_wgmma.cu: 64; csrc/flow_rows.cuh: 32, 16 from Hp 768;
    csrc/flow_kernel.cu's strict kernel: 64, 32 from Hp 768)."""
    if route == "rows":
        return 32 if Hp <= 32 * 17 else 16
    return 64 if Hp <= 32 * 17 else 32


def median(xs: list[float]) -> float:
    return sorted(xs)[len(xs) // 2]


def bound_ms(work: tuple[float, float], peaks: tuple[float, float, float], arith: str) -> tuple[float, str]:
    """The least time for the work on this card in the given arithmetic: the
    larger of its operations over that arithmetic's rate and its bytes over
    the memory rate; and which of the two it is."""
    rate = peaks[1] / 3 if arith == ARITH_3XTF32 else peaks[0]
    t_ops, t_bytes = 1e3 * work[0] / rate, 1e3 * work[1] / peaks[2]
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def kernel_row(name: str, source: str, replaces: str, launches: int, err: float, k_times: list[float],
               p_times: list[float], work: tuple[float, float], peaks: tuple[float, float, float],
               library_ms: float | None, arith: str = ARITH_FMA) -> dict:
    """One entry of the kernel table: median times, and the bound from the
    work's operations and bytes over the card's peaks for the kernel's
    arithmetic (`arith`)."""
    bound, by = bound_ms(work, peaks, arith)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": median(k_times), "plain_ms": median(p_times),
            "bound_ms": bound, "bound_by": by, "library_ms": library_ms, "arith": arith}


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
    from bcnf_tpu_torch.ops.flow_kernel import (
        ROUTE_FMA,
        ROUTE_ROWS,
        ROUTE_WGMMA,
        WG_COPIES,
        WG_PRODUCTS,
        _launch_flow,
        flow_route,
        fused_flow,
        fused_flow_reference,
        prepare_weights,
    )

    # ---- 1. device + build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    peaks = peaks_for(kind)
    print(smi)
    t0 = time.perf_counter()
    _build.build_all()  # one nvcc per source, all started together
    for name in _build.SOURCES:
        _build.load_library(name)
    nvcc_s = ", ".join(f"{name} {sec:.1f} s" for name, sec in _build.build_seconds.items())
    print(f"[1 device] {kind} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"kernels built+loaded in {time.perf_counter() - t0:.1f} s (nvcc: {nvcc_s or 'cached'})")
    for name, log in _build.build_logs.items():
        kernel = "?"
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                kernel = kernel_label(ln)
            elif "registers" in ln or ("spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln):
                print(f"    ptxas {name} {kernel}: {ln.strip().removeprefix('ptxas info    : ')}")

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
    # K1 in both modes: the default 3xTF32 (the inverse on wgmma, the forward
    # on the row tiles) and strict (float32 FMA), each against the plain version
    modes = {"": False, " strict": True}
    errs = {f"{d}{m}": 0.0 for m in modes for d in ("inverse", "forward")}
    before = fused_flow.launches
    for B, N in ((4096, 8), (4099, 7)):
        traj = torch.from_numpy(rng.normal(size=(N, 30, 3)).astype(np.float32)).to(dev)
        with torch.no_grad():
            kargs, h_proj = model._fused_flow_args(k_params, model.encode(k_params, (traj,)))
            x = torch.from_numpy(rng.normal(size=(B, model.size)).astype(np.float32)).to(dev)
            y_r = fused_flow_reference(x, h_proj, **kargs, inverse=True, n_cond=N)
            z_r, ld_r = fused_flow_reference(x, h_proj, **kargs, inverse=False, n_cond=N)
            for m, strict in modes.items():
                y_k = fused_flow(x, h_proj, **kargs, inverse=True, n_cond=N, strict=strict)
                z_k, ld_k = fused_flow(x, h_proj, **kargs, inverse=False, n_cond=N, strict=strict)
                torch.cuda.synchronize()
                errs[f"inverse{m}"] = max(errs[f"inverse{m}"], (y_k - y_r).abs().max().item())
                errs[f"forward{m}"] = max(errs[f"forward{m}"], (z_k - z_r).abs().max().item(),
                                          (ld_k - ld_r).abs().max().item())
    if fused_flow.launches != before + 8:
        fail("fused_flow did not count its launches")
    print(f"[2 kernels] fused_flow vs plain at H={H}, B=4096/N=8 and ragged B=4099/N=7: 3xTF32 max|dy| inverse "
          f"(wgmma) {errs['inverse']:.3e}, max|dz|,|dlogdet| forward (row tiles) {errs['forward']:.3e}; strict "
          f"(FMA) inverse {errs['inverse strict']:.3e}, forward {errs['forward strict']:.3e} "
          f"(tolerance {KERNEL_TOL:g})")
    for d, e in errs.items():
        if not e <= KERNEL_TOL:
            fail(f"fused_flow {d} disagrees with its plain version: {e:.3e} > {KERNEL_TOL:g}")

    # ---- 3. main path: posterior sampling, then log_prob + round trip, in
    # the default mode (3xTF32) and then in strict mode (float32 FMA)
    traj = torch.from_numpy(rng.normal(size=(N_COND, 30, 3)).astype(np.float32))
    z_all = torch.randn((M_DRAWS, N_COND, model.size), generator=torch.Generator().manual_seed(SEED))
    cpu_params = map_tree(lambda t: t.cpu(), params)
    with torch.no_grad():
        ref = model.inverse_given_h(cpu_params, z_all[:64], model.encode(cpu_params, (traj,)))
    d = LOGPROB_ROWS // N_COND
    cond_lp = traj.to(dev).repeat(d, 1, 1)
    launches, run = {}, {}
    for mode, strict in (("3xtf32", False), ("strict", True)):
        model.pallas_strict = strict
        inv_route, fwd_route = (ROUTE_FMA, ROUTE_FMA) if strict else (ROUTE_WGMMA, ROUTE_ROWS)
        with torch.no_grad():
            model.sample(params, torch.Generator().manual_seed(SEED), 16, traj, device=dev)  # warm-up
            torch.cuda.synchronize()
            zero_flow_counts()
            t0 = time.perf_counter()
            out = model.sample(params, torch.Generator().manual_seed(SEED), M_DRAWS, traj, device=dev)
            torch.cuda.synchronize()
            t_sample = time.perf_counter() - t0
            inv_launches = dict(fused_flow.route_launches)
        if inv_launches != {inv_route: 1}:
            fail(f"posterior sampling ({mode}) launched K1 {inv_launches}, not once on {inv_route}")
        if tuple(out.shape) != (M_DRAWS, N_COND, model.size) or not torch.isfinite(out).all():
            fail(f"samples ({mode}) of shape {tuple(out.shape)} are not all finite / not the expected shape")
        # the kernel's samples against the plain path on the CPU, for the first 64 draws
        cpu_err = (out[:64].cpu() - ref).abs().max().item()
        y_lp = out[:d].reshape(LOGPROB_ROWS, model.size)
        with torch.no_grad():
            zero_flow_counts()
            lp = model.log_prob(params, y_lp, cond_lp)
            z_rt, _ = model.forward(params, y_lp, cond_lp)
            torch.cuda.synchronize()
            fwd_launches = dict(fused_flow.route_launches)
        if fwd_launches != {fwd_route: 2}:
            fail(f"log_prob and the round trip ({mode}) launched K1 {fwd_launches}, not twice on {fwd_route}")
        rt_err = (z_rt.cpu() - z_all[:d].reshape(LOGPROB_ROWS, model.size)).abs().max().item()
        if not torch.isfinite(lp).all():
            fail(f"log_prob ({mode}) is not finite")
        print(f"[3 main path, {mode}] {n_params:,} params; sample {M_DRAWS}x{N_COND} in {t_sample:.3f} s = "
              f"{M_DRAWS * N_COND / t_sample:.0f} samples/s, K1 launches {inv_launches}; "
              f"max|d| vs CPU plain path (64 draws) {cpu_err:.3e}; log_prob on {LOGPROB_ROWS} rows "
              f"(K1 launches {fwd_launches}), round trip max|forward(sample) - z| {rt_err:.3e} "
              f"(tolerance {ROUNDTRIP_TOL:g}); mean log_prob {lp.mean().item():.3f}")
        if not cpu_err <= KERNEL_TOL:
            fail(f"samples ({mode}) disagree with the CPU plain path: {cpu_err:.3e} > {KERNEL_TOL:g}")
        if not rt_err <= ROUNDTRIP_TOL:
            fail(f"round trip error ({mode}) {rt_err:.3e} > {ROUNDTRIP_TOL:g}")
        launches[mode] = (inv_launches[inv_route], fwd_launches[fwd_route])
        run[mode] = (out, y_lp)
    model.pallas_strict = False
    samples, y_lp = run["3xtf32"]

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
        prep_ms = median(cuda_ms(lambda: prepare_weights(kargs["wm"]), reps=5))
        wm_mb = 4 * kargs["wm"].numel() / 1e6
        print(f"    sample breakdown (host clock): z draw on CPU + copy {1e3 * (t1 - t0):.1f} ms, encode + "
              f"projections + stacked args {1e3 * (t2 - t1):.1f} ms, K1 call {1e3 * (t3 - t2):.1f} ms, of which "
              f"the wgmma weight preparation {prep_ms:.2f} ms (CUDA events, median of 5; {wm_mb:.0f} MB in, "
              f"{2 * wm_mb:.0f} MB out)")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        per_sm = _build.load_library("flow_wgmma").bcnf_flow_wgmma_occupancy(h_proj.shape[-1], model.size,
                                                                              model.coupling.d_a)
        blocks = -(-x_inv.shape[0] // 64)
        if per_sm < 1:
            fail(f"the wgmma inverse fits no block on an SM ({per_sm})")
        print(f"    wgmma inverse layout: {blocks} blocks of 64 rows, {per_sm} an SM on {sms} SMs: "
              f"{blocks / (per_sm * sms):.2f} waves")
        hl = model.encode(params, (cond_lp,))
        kargs_f, h_proj_f = model._fused_flow_args(params, hl)
        shapes = {
            "inverse": (x_inv, kargs, h_proj, N_COND, launches["3xtf32"][0], True, False),
            "forward": (y_lp.contiguous(), kargs_f, h_proj_f, LOGPROB_ROWS, launches["3xtf32"][1], False, False),
            "inverse, strict": (x_inv, kargs, h_proj, N_COND, launches["strict"][0], True, True),
            "forward, strict": (y_lp.contiguous(), kargs_f, h_proj_f, LOGPROB_ROWS, launches["strict"][1], False, True),
        }
        saved = fused_flow.launches
        for direction, (x, ka, hp, n, n_launches, inv, strict) in shapes.items():
            # the kernel against its plain version at exactly the main path's inputs too
            out_k = fused_flow(x, hp, **ka, inverse=inv, n_cond=n, strict=strict)
            out_p = fused_flow_reference(x, hp, **ka, inverse=inv, n_cond=n)
            err = max((a - b).abs().max().item() for a, b in zip(
                (out_k,) if inv else out_k, (out_p,) if inv else out_p))
            if not err <= KERNEL_TOL:
                fail(f"fused_flow {direction} at the main path's shape disagrees with plain: {err:.3e}")
            key = direction.replace(",", "")
            errs[key] = max(errs[key], err)
            route = flow_route(hp.shape[-1], model.size, ka["w1y"].shape[1], inv, strict)
            k_times = cuda_ms(lambda: fused_flow(x, hp, **ka, inverse=inv, n_cond=n, strict=strict), reps=5)
            p_times = cuda_ms(lambda: fused_flow_reference(x, hp, **ka, inverse=inv, n_cond=n), reps=3)
            flops, nbytes = flow_work(ka, hp, x.shape[0], H)
            arith = ARITH_FMA if strict else ARITH_3XTF32
            src = "bcnf_tpu_torch/ops/csrc/" + ("flow_wgmma.cu" if route == ROUTE_WGMMA else "flow_kernel.cu")
            kernels.append(kernel_row(f"fused_flow[{direction}]", src, "bcnf_tpu/ops/flow_kernel.py:162", n_launches,
                                      errs[key], k_times, p_times, (flops, nbytes), peaks, None, arith))
            ms, plain_ms, bound = kernels[-1]["ms"], kernels[-1]["plain_ms"], kernels[-1]["bound_ms"]
            fma_bound = bound_ms((flops, nbytes), peaks, ARITH_FMA)[0]
            tile = route_rows(route, hp.shape[-1])
            l2_gb = -(-x.shape[0] // tile) * 4 * sum(int(v.numel()) for v in ka.values()) / 1e9
            if route == ROUTE_WGMMA:
                l2_gb += -(-x.shape[0] // tile) * 4 * int(ka["wm"].numel()) / 1e9  # hi and lo of the hidden weights
            print(f"    fused_flow[{direction}] ({route}, {arith}) rows {x.shape[0]}: {ms:.2f} ms (bound {bound:.2f} ms, "
                  f"float32-FMA bound {fma_bound:.2f} ms, {flops / 1e12:.2f} TFLOP -> {flops / ms / 1e9:.1f} TFLOP/s, "
                  f"median of {len(k_times)}, range {min(k_times):.2f}-{max(k_times):.2f}), plain {plain_ms:.2f} ms "
                  f"(range {min(p_times):.2f}-{max(p_times):.2f}); max|d| vs plain {err:.2e}; weights read from L2 "
                  f"per call ~{l2_gb:.0f} GB ({tile}-row blocks) -> {l2_gb / ms:.2f} TB/s")
        fused_flow.launches = saved
        # the wgmma inverse's parts alone (uncounted launches): its products on
        # stale weight stages, and the weights' stream from L2 without the products
        staged, wg_args = prepare_weights(kargs["wm"]), dict(kargs, h_proj=h_proj)
        part_ms = {name: median(cuda_ms(lambda: _launch_flow(x_inv, wg_args, inverse=True, n_cond=N_COND, strict=False,
                                                             wstages=staged, parts=parts), reps=3))
                   for name, parts in (("both", WG_PRODUCTS | WG_COPIES), ("products", WG_PRODUCTS),
                                       ("stream", WG_COPIES))}
        stream_gb = -(-x_inv.shape[0] // 64) * 4 * int(staged.numel()) / 1e9
        print(f"    wgmma inverse parts (CUDA events, median of 3, ms): as built {part_ms['both']:.2f}; its products "
              f"alone (stale stages) {part_ms['products']:.2f} ({flow_work(kargs, h_proj, x_inv.shape[0], H)[0] / part_ms['products'] / 1e9:.1f} "
              f"TFLOP/s); the hidden weights' stream alone {part_ms['stream']:.2f} ({stream_gb:.0f} GB of hi and lo from "
              f"L2 -> {stream_gb / part_ms['stream']:.2f} TB/s)")

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
    kernels += train_main_path(rng, dev, peaks)
    train_cli(rng, build_dir)
    lstm_times = check_lstm_kernels(rng, dev)
    k2b_ms = next(row["ms"] for row in kernels if row["name"].startswith("K2b"))
    lstm_launches = lstm_path_a(model, params, traj, samples, rng, dev, build_dir, lstm_times, k2b_ms)
    kernels += lstm_rows(lstm_times, lstm_launches, peaks)
    dlstm_path_b(rng, dev, build_dir)
    kernels += coupling_path_c(model, params, traj, samples, z_all, y_lp, cond_lp, rng, dev, peaks)

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


def train_main_path(rng, dev, peaks: tuple[float, float, float]) -> list[dict]:
    """Phase 6: the training main path on the full flagship; returns the
    K2a/K2b rows of the kernel table."""
    import numpy as np
    import torch

    from bcnf_tpu_torch.bridge import map_tree, tree_leaves
    from bcnf_tpu_torch.models import CondRealNVP
    from bcnf_tpu_torch.ops.flow_kernel import (
        BWD_ROWS,
        BWD_WEIGHT_GRADS,
        _train_bwd_parts,
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
        # K2b's parts alone, on the same inputs: the 26 rows kernels, then the 26 weight-grad passes
        outs = tuple(torch.empty_like(t) for t in grads_k)
        part_ms = {name: median(cuda_ms(lambda: _train_bwd_parts(bound, h_proj, dz, dld, dict(zip(TRAIN_ARGS, args)),
                                                                 outs, part), reps=5))
                   for name, part in (("rows", BWD_ROWS), ("weight grads", BWD_WEIGHT_GRADS))}
    fused_flow_train_fwd.launches, fused_flow_train_bwd.launches = saved
    work = dict(zip(("K2a", "K2b"), train_work({k: v for k, v in zip(TRAIN_ARGS, args)}, h_proj, B, H)))
    rows = []
    for name, err, src, replaces, fn, arith in (
        ("K2a", fwd_err, "bcnf_tpu_torch/ops/csrc/flow_kernel.cu", "bcnf_tpu/ops/flow_kernel.py:558",
         "fused_flow_train_fwd", ARITH_3XTF32),
        ("K2b", bwd_err, "bcnf_tpu_torch/ops/csrc/flow_train_kernel.cu", "bcnf_tpu/ops/flow_kernel.py:600",
         "fused_flow_train_bwd", ARITH_3XTF32),
    ):
        k_times, p_times = times[name]
        flops = work[name][0]
        rows.append(kernel_row(f"{name} {fn}", src, replaces, launches[name], err, k_times, p_times, work[name],
                               peaks, None, arith))
        ms, plain_ms, bound = rows[-1]["ms"], rows[-1]["plain_ms"], rows[-1]["bound_ms"]
        fma_bound = bound_ms(work[name], peaks, ARITH_FMA)[0]
        blocks = -(-B // (32 if h_proj.shape[-1] <= 32 * 17 else 16))  # the rows kernels' tiles (csrc/flow_rows.cuh)
        print(f"    {name} rows {B} ({blocks} blocks): {ms:.2f} ms ({arith}; bound {bound:.2f} ms, float32-FMA bound {fma_bound:.2f} ms, "
              f"{flops / 1e12:.3f} TFLOP -> {flops / ms / 1e9:.1f} TFLOP/s, median of {len(k_times)}, range "
              f"{min(k_times):.2f}-{max(k_times):.2f}), plain {plain_ms:.2f} ms (range {min(p_times):.2f}-"
              f"{max(p_times):.2f}); max|d| vs plain {err:.2e}")
    k2b_ms = rows[1]["ms"]
    print(f"    K2b parts (CUDA events, median of 5, ms): 26 rows kernels {part_ms['rows']:.2f}, 26 weight-grad "
          f"passes {part_ms['weight grads']:.2f}, the rest (dz copy, ActNorm grads, scratch, gaps) "
          f"{k2b_ms - part_ms['rows'] - part_ms['weight grads']:.2f}")
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


# ---------------------------------------------------------------------------
# phases 8-11: the LSTM recurrence kernels (K3a/K3b) and the per-coupling
# kernel (K4)
# ---------------------------------------------------------------------------

LSTM_GRADS = ("dxp", "dW_hh")


def lstm_work(T: int, B: int, H: int) -> tuple[tuple[float, float], tuple[float, float]]:
    """(operations, bytes) of one K3a and of one K3b call for one direction
    of B rows and T steps at hidden size H: K3a does the step products
    h W_hh (8 H^2 FLOP a row and step), reads xp and W_hh once and writes hs
    and cs; K3b recomputes those products, multiplies dgates back through
    W_hh^T and forms dW_hh over the (T - 1) B rows that have an h_prev, reads
    xp, W_hh, hs, cs and dhs and writes dxp and dW_hh."""
    step = 2.0 * B * H * 4 * H
    seq, gates, w = T * B * H, T * B * 4 * H, H * 4 * H
    fwd = (T * step, 4.0 * (gates + w + 2 * seq))
    bwd = ((2 * T + T - 1) * step, 4.0 * (gates + w + 3 * seq + gates + w))
    return fwd, bwd


def cudnn_lstm(p: dict, F: int, H: int, reverse: bool, dev):
    """cuDNN's one-layer, one-direction LSTM carrying the same weights
    (`weight_ih_l0 = w_ih^T`, ...; gate order i, f, g, o as the port's): the
    library yardstick, run on the time-reversed input for the reverse
    direction. Never on the port's path."""
    import torch

    lstm = torch.nn.LSTM(F, H, num_layers=1, batch_first=True).to(dev)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(p["w_ih"].T)
        lstm.weight_hh_l0.copy_(p["w_hh"].T)
        lstm.bias_ih_l0.copy_(p["b_ih"])
        lstm.bias_hh_l0.copy_(p["b_hh"])

    def run(x):
        out = lstm(x.flip(1) if reverse else x)[0]
        return out.flip(1) if reverse else out

    return run


def check_lstm_kernels(rng, dev) -> dict:
    """Phase 8: K3a and K3b against their plain versions at the encoders'
    shapes, then their times at the flagship encoder's batch-4096 shape
    beside the plain versions and cuDNN. Launches here do not count."""
    import numpy as np
    import torch

    from bcnf_tpu_torch.ops.lstm import lstm_cell_init
    from bcnf_tpu_torch.ops.lstm_kernel import (
        BWD_DW,
        BWD_RECURRENCE,
        _bwd_parts,
        fused_direction,
        fwd_layout,
        lstm_direction_bwd,
        lstm_direction_bwd_reference,
        lstm_direction_fwd,
        lstm_direction_fwd_reference,
    )

    saved = lstm_direction_fwd.launches, lstm_direction_bwd.launches
    gen = torch.Generator().manual_seed(SEED)
    print(f"[8 LSTM kernels] K3a vs plain (hs, cs; tolerance {LSTM_TOL:g}) and K3b vs plain (grads from "
          f"standard-normal dhs; bar |d| <= min({LSTM_GRAD_ATOL:g}, {GRAD_REL:g} max|plain|) + "
          f"{LSTM_GRAD_RTOL:g}|plain|), B=4096 and ragged B=4099, both directions:")
    worst = {"K3a": 0.0, "K3b": 0.0}
    cells = {}
    for label, T, F, H in (("flagship layer 1", 30, 3, 140), ("flagship layer 2", 30, 280, 140),
                           ("t_DLSTM_large time layer 1", 30, 3, 128), ("t_DLSTM_large freq layer 1", 16, 6, 128)):
        p = {k: v.to(dev) for k, v in lstm_cell_init(gen, F, H).items()}
        cells[label] = (p, T, F, H)
        for B in (4096, 4099):
            x = torch.from_numpy(rng.normal(size=(B, T, F)).astype(np.float32)).to(dev)
            with torch.no_grad():
                xp = (torch.matmul(x.transpose(0, 1), p["w_ih"]) + p["b_ih"] + p["b_hh"]).contiguous()
                for reverse in (False, True):
                    hs, cs = lstm_direction_fwd(xp, p["w_hh"], reverse)
                    hs_r, cs_r = lstm_direction_fwd_reference(xp, p["w_hh"], reverse)
                    err = max((hs - hs_r).abs().max().item(), (cs - cs_r).abs().max().item())
                    dhs = torch.randn(hs.shape, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
                    got = lstm_direction_bwd(xp, p["w_hh"], hs, cs, dhs, reverse)
                    ref = lstm_direction_bwd_reference(xp, p["w_hh"], hs, cs, dhs, reverse)
                    torch.cuda.synchronize()
                    what = f"K3b {label} B={B} {'reverse' if reverse else 'forward'}"
                    print(f"      K3a {label} B={B} {'reverse' if reverse else 'forward'}: max|d| hs, cs {err:.3e}")
                    if not err <= LSTM_TOL:
                        fail(f"K3a ({label}, B={B}, reverse={reverse}) disagrees with plain: {err:.3e} > {LSTM_TOL:g}")
                    worst["K3a"] = max(worst["K3a"], err)
                    worst["K3b"] = max(worst["K3b"], check_grads(what, LSTM_GRADS, got, ref, LSTM_GRAD_ATOL,
                                                                 LSTM_GRAD_RTOL))
    if (lstm_direction_fwd.launches - saved[0], lstm_direction_bwd.launches - saved[1]) != (16, 16):
        fail("the LSTM kernels did not count their launches")
    for label, H in (("flagship", 140), ("t_DLSTM_large", 128)):
        lay = fwd_layout(4096, H, dev)
        print(f"    K3a layout, {label} H={H}, B=4096: clusters of 8 blocks own {lay['rows']} rows each; "
              f"{lay['clusters']} clusters, {lay['resident_clusters']} resident at once: {lay['waves']} wave(s)")

    # times at the main path's shapes: the flagship encoder's layer 2 at
    # batch 4096 (the kernels do not depend on the input width), and
    # t_DLSTM_large's time LSTM at its batch 256
    times = {}
    for key, label, B in (("flagship", "flagship layer 2", 4096), ("t_DLSTM_large", "t_DLSTM_large time layer 1", 256)):
        p, T, F, H = cells[label]
        x = torch.from_numpy(rng.normal(size=(B, T, F)).astype(np.float32)).to(dev)
        with torch.no_grad():
            xp = (torch.matmul(x.transpose(0, 1), p["w_ih"]) + p["b_ih"] + p["b_hh"]).contiguous()
            hs, cs = lstm_direction_fwd(xp, p["w_hh"], False)
            dhs = torch.randn(hs.shape, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
            t = {
                "K3a": cuda_ms(lambda: lstm_direction_fwd(xp, p["w_hh"], False), reps=5),
                "K3a plain": cuda_ms(lambda: lstm_direction_fwd_reference(xp, p["w_hh"], False), reps=3),
                "projection + K3a": cuda_ms(lambda: fused_direction(p, x, H, False), reps=5),
                "K3b": cuda_ms(lambda: lstm_direction_bwd(xp, p["w_hh"], hs, cs, dhs, False), reps=5),
                "K3b plain": cuda_ms(lambda: lstm_direction_bwd_reference(xp, p["w_hh"], hs, cs, dhs, False), reps=3),
            }
            # K3b's two parts alone: the cluster recurrence, and the dW_hh pass over its dxp
            dxp_b, dw_b = lstm_direction_bwd(xp, p["w_hh"], hs, cs, dhs, False)
            for part, bit in (("K3b recurrence", BWD_RECURRENCE), ("K3b dW_hh pass", BWD_DW)):
                t[part] = cuda_ms(lambda: _bwd_parts(xp, p["w_hh"], hs, cs, dhs, False, dxp_b, dw_b, bit), reps=5)
            run = cudnn_lstm(p, F, H, False, dev)
            t["cuDNN forward"] = cuda_ms(lambda: run(x), reps=5)
        xg = x.clone().requires_grad_(True)
        dy = dhs.transpose(0, 1).contiguous()
        t["cuDNN forward, autograd on"] = cuda_ms(lambda: run(xg), reps=5)

        def fwd_bwd():
            run(xg).backward(dy)

        t["cuDNN forward + backward"] = cuda_ms(fwd_bwd, reps=5)
        med = {k: median(v) for k, v in t.items()}
        (f_ops, f_bytes), (b_ops, b_bytes) = lstm_work(T, B, H)
        times[key] = dict(med, T=T, B=B, H=H, work=((f_ops, f_bytes), (b_ops, b_bytes)), ranges={
            k: (min(v), max(v)) for k, v in t.items()})
        print(f"    times, {label}, B={B}, T={T}, H={H} (CUDA events, median; ms): K3a {med['K3a']:.3f} "
              f"(range {min(t['K3a']):.3f}-{max(t['K3a']):.3f}; {f_ops / 1e9:.1f} GFLOP -> "
              f"{f_ops / med['K3a'] / 1e9:.1f} TFLOP/s), plain {med['K3a plain']:.3f}; projection + K3a "
              f"{med['projection + K3a']:.3f} vs cuDNN forward {med['cuDNN forward']:.3f} (with autograd on "
              f"{med['cuDNN forward, autograd on']:.3f}); K3b {med['K3b']:.3f} "
              f"(range {min(t['K3b']):.3f}-{max(t['K3b']):.3f}; {b_ops / 1e9:.1f} GFLOP -> "
              f"{b_ops / med['K3b'] / 1e9:.1f} TFLOP/s; recurrence {med['K3b recurrence']:.3f}, dW_hh pass "
              f"{med['K3b dW_hh pass']:.3f}), plain {med['K3b plain']:.3f}; cuDNN backward "
              f"(forward + backward - forward) {med['cuDNN forward + backward'] - med['cuDNN forward']:.3f}")
    lstm_direction_fwd.launches, lstm_direction_bwd.launches = saved
    times["err"] = worst
    return times


def lstm_rows(times: dict, launches: dict, peaks: tuple[float, float, float]) -> list[dict]:
    """The K3a/K3b entries of the kernel table, at the flagship encoder's
    batch-4096 shape; launches are phase 9's (path A's main-path run)."""
    t = times["flagship"]
    (fwd_work, bwd_work) = t["work"]
    src, rep = "bcnf_tpu_torch/ops/csrc/lstm_kernel.cu", "bcnf_tpu/ops/lstm_kernel.py"
    rows = [
        kernel_row("K3a lstm_direction_fwd", src, f"{rep}:129", launches["K3a"], times["err"]["K3a"], [t["K3a"]],
                   [t["K3a plain"]], fwd_work, peaks, t["cuDNN forward"], ARITH_3XTF32),
        kernel_row("K3b lstm_direction_bwd", src, f"{rep}:150", launches["K3b"], times["err"]["K3b"], [t["K3b"]],
                   [t["K3b plain"]], bwd_work, peaks, t["cuDNN forward + backward"] - t["cuDNN forward"],
                   ARITH_3XTF32),
    ]
    for row, work, what in ((rows[0], fwd_work, "forward"), (rows[1], bwd_work, "backward")):
        print(f"    {row['name'].split()[0]} (3xtf32) at B={t['B']}: {row['ms']:.3f} ms against its bound "
              f"{row['bound_ms']:.3f} ms ({row['bound_by']}; float32-FMA bound {bound_ms(work, peaks, ARITH_FMA)[0]:.3f} ms) "
              f"and cuDNN's {what} {row['library_ms']:.3f} ms: "
              f"{'faster' if row['ms'] < row['library_ms'] else 'not faster'} than cuDNN")
    return rows


def lstm_counts() -> dict:
    from bcnf_tpu_torch.ops.flow_kernel import fused_flow, fused_flow_train_bwd, fused_flow_train_fwd
    from bcnf_tpu_torch.ops.lstm_kernel import lstm_direction_bwd, lstm_direction_fwd

    return {"K3a": lstm_direction_fwd.launches, "K3b": lstm_direction_bwd.launches, "K1": fused_flow.launches,
            "K2a": fused_flow_train_fwd.launches, "K2b": fused_flow_train_bwd.launches}


def zero_counts() -> None:
    from bcnf_tpu_torch.ops.flow_kernel import fused_flow, fused_flow_train_bwd, fused_flow_train_fwd
    from bcnf_tpu_torch.ops.lstm_kernel import lstm_direction_bwd, lstm_direction_fwd

    for fn in (lstm_direction_fwd, lstm_direction_bwd, fused_flow, fused_flow_train_fwd, fused_flow_train_bwd):
        fn.launches = 0
    fused_flow.route_launches.clear()


def fused_lstm(on: bool) -> None:
    os.environ["BCNF_FUSED_LSTM"] = "1" if on else "0"


def train_with_counts(cfg: dict, model, rng, dev, dirs: int, what: str) -> tuple[dict, int, dict, list]:
    """`Trainer.train` on random data (3 batches an epoch) with the fused
    LSTM on; checks K3b = dirs a step and K3a = dirs a step, validation
    batch and the ActNorm data init. Returns (counts, steps, trained, data)."""
    import numpy as np
    import torch

    from bcnf_tpu_torch.bridge import tree_leaves
    from bcnf_tpu_torch.train import Trainer

    B, n_epochs = cfg["training"]["batch_size"], cfg["training"]["n_epochs"]
    n = int(round(3 * B / (1 - cfg["training"]["validation_split"])))
    y = rng.normal(size=(n, model.size)).astype(np.float32)
    traj = rng.normal(size=(n, 30, 3)).astype(np.float32)
    params0 = model.init(torch.Generator().manual_seed(SEED), device=dev)
    trainer = Trainer(cfg, data=(y, [traj]), device=dev, seed=SEED)
    fused_lstm(True)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    trained = trainer.train(model, params0)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    c = lstm_counts()
    steps = 3 * n_epochs
    hist = trainer.meta_scheduler.parameter_history
    losses = [v for _, v in hist["train_loss"]] + [v for _, v in hist["val_loss"]]
    if c["K3b"] != dirs * steps or c["K3a"] != dirs * (steps + c["K1"] + 1):
        fail(f"{what}: Trainer.train launched K3a {c['K3a']} and K3b {c['K3b']} times for {steps} steps, "
             f"{c['K1']} validation batches and the ActNorm init ({dirs} directions)")
    if not (np.all(np.isfinite(losses)) and all(torch.isfinite(t).all() for t in tree_leaves(trained))):
        fail(f"{what}: Trainer.train gave non-finite losses or params: {losses}")
    print(f"    {what}: Trainer.train, {n_epochs} epoch(s) x 3 steps of {B} + validation in {t_train:.2f} s; "
          f"launches K3a {c['K3a']}, K3b {c['K3b']}, K2a {c['K2a']}, K2b {c['K2b']}, K1 {c['K1']}; losses "
          f"{', '.join(f'{v:.3f}' for v in losses)}")
    return c, steps, trained, (y, traj, trainer)


def step_against_loop(model, trained, yb, cb, dev, what: str, expect: tuple[int, int]) -> None:
    """One training step's loss and grads (from standard-normal cotangents)
    with the fused LSTM against the same step with the time loop, dropout
    masks from the same seeded generator."""
    import torch

    from bcnf_tpu_torch.bridge import map_tree, tree_leaves
    from bcnf_tpu_torch.utils.misc import inn_nll_loss

    losses, grads = [], []
    for on in (True, False):
        fused_lstm(on)
        p = map_tree(lambda t: t.detach().clone().requires_grad_(True), trained)
        before = lstm_counts()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        z, ld = model.forward(p, yb, *cb, generator=gen, train=True)
        dz, dld = randn_cotangents(z)
        ((z * dz).sum() + (ld * dld).sum()).backward()
        after = lstm_counts()
        used = (after["K3a"] - before["K3a"], after["K3b"] - before["K3b"])
        if used != (expect if on else (0, 0)):
            fail(f"{what}: the step launched K3a/K3b {used} times (fused LSTM {on})")
        losses.append(inn_nll_loss(z, ld).item())
        grads.append([t.grad for t in tree_leaves(p)])
    worst, max_d, mags = -1.0, 0.0, []
    for a, b in zip(*grads):
        if a is not None and b is not None:
            d, excess, mag = grad_excess(a, b)
            worst, max_d = max(worst, excess), max(max_d, d)
            mags.append(mag)
    loss_d = abs(losses[0] - losses[1])
    print(f"    {what}: step through K3a/K3b vs the time-loop encoder's: loss {losses[0]:.5f} vs {losses[1]:.5f}; "
          f"{len(mags)} param grads, max|d| {max_d:.3e} (bar |d| <= min({GRAD_ATOL:g}, {GRAD_REL:g} max|plain|) + "
          f"{GRAD_RTOL:g}|plain|), max|plain| per grad from {min(mags):.3e} to {max(mags):.3e}")
    if not loss_d <= KERNEL_TOL * max(1.0, abs(losses[1])) or worst > 0:
        fail(f"{what}: the fused-LSTM step disagrees with the time loop's: loss |d| {loss_d:.3e}, grads {worst:.3e} "
             f"past the bar")


def train_rates(model, trainer, trained, yb, cb, dev, reps: int = 5) -> tuple[float, float]:
    """Train samples/s of `Trainer.train_step` with the fused LSTM and with
    the time loop (host clock around synchronised work, after a warm-up)."""
    import torch

    from bcnf_tpu_torch.bridge import map_tree
    from bcnf_tpu_torch.train import make_optimizer

    rates = []
    for on in (True, False):
        fused_lstm(on)
        params = map_tree(lambda t: t.detach().clone().requires_grad_(True), trained)
        opt = make_optimizer("Adam", lr=2e-4).init(params)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        trainer.train_step(model, params, opt, yb, cb, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            trainer.train_step(model, params, opt, yb, cb, gen)
        torch.cuda.synchronize()
        rates.append(reps * yb.shape[0] / (time.perf_counter() - t0))
    fused_lstm(True)
    return rates[0], rates[1]


def cli_round_trip(cfg: dict, rng, build_dir: str, dirs: int, what: str) -> dict:
    """`train` (2 epochs of 2 batches) on a written dataset, then `sample`
    from its model directory, with the fused LSTM on; launch counts checked
    and returned."""
    import numpy as np
    import yaml

    from bcnf_tpu_torch.__main__ import main as cli_main

    B = cfg["training"]["batch_size"]
    fused_lstm(True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        cfg_path, data_path = os.path.join(tmp, "run.yaml"), os.path.join(tmp, "data.pkl")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f)
        n = int(round(2 * B / (1 - cfg["training"]["validation_split"])))
        data = {"trajectories": rng.normal(size=(n, 30, 3)).astype(np.float32)}
        data.update({p: rng.normal(size=n).astype(np.float32) for p in cfg["global"]["parameter_selection"]})
        with open(data_path, "wb") as f:
            pickle.dump(data, f)
        model_dir, out = os.path.join(tmp, "model"), os.path.join(tmp, "samples.npy")
        zero_counts()
        cli_main(["train", "-c", cfg_path, "-d", data_path, "-o", model_dir, "--seed", "1"])
        tr = lstm_counts()
        zero_counts()
        cli_main(["sample", "-m", model_dir, "-d", data_path, "-n", "20", "-o", out, "--seed", "2"])
        samples, sa = np.load(out), lstm_counts()
    size = len(cfg["global"]["parameter_selection"])
    if tr["K3b"] != dirs * 4 or tr["K3a"] < dirs * 5:
        fail(f"{what}: the train CLI launched K3a {tr['K3a']} and K3b {tr['K3b']} times for 4 steps")
    if samples.shape != (20, n, size) or not np.isfinite(samples).all() or (sa["K3a"], sa["K1"]) != (dirs, 1):
        fail(f"{what}: sample after train gave shape {samples.shape}, finite={np.isfinite(samples).all()}, "
             f"launches K3a {sa['K3a']}, K1 {sa['K1']}")
    print(f"    {what}: bcnf_tpu_torch train (2 epochs x 2 steps of {B}): K3a {tr['K3a']}, K3b {tr['K3b']}, K2a "
          f"{tr['K2a']}, K2b {tr['K2b']} launches; then sample: {samples.shape} finite, K3a {sa['K3a']}, K1 {sa['K1']}")
    return {k: tr[k] + sa[k] for k in tr}


def lstm_path_a(model, params, traj, samples, rng, dev, build_dir: str, lstm_times: dict, k2b_ms: float) -> dict:
    """Phase 9: the flagship with BCNF_FUSED_LSTM=1. Returns the K3a/K3b
    launches of its sampling call, its two `Trainer.train` runs and its CLI
    round trip (the step checks and the rates time other calls)."""
    import torch

    from bcnf_tpu_torch.models import CondRealNVP
    from bcnf_tpu_torch.bridge import map_tree
    from bcnf_tpu_torch.ops.flow_kernel import fused_flow_train
    from bcnf_tpu_torch.train import make_optimizer
    from bcnf_tpu_torch.utils.misc import inn_nll_loss

    totals = {"K3a": 0, "K3b": 0}

    def add(c):
        totals["K3a"] += c["K3a"]
        totals["K3b"] += c["K3b"]

    fused_lstm(True)
    with torch.no_grad():
        zero_counts()
        t0 = time.perf_counter()
        out = model.sample(params, torch.Generator().manual_seed(SEED), M_DRAWS, traj, device=dev)
        torch.cuda.synchronize()
        t_sample = time.perf_counter() - t0
    c = lstm_counts()
    add(c)
    err = (out - samples).abs().max().item()
    print(f"[9 path A] flagship, BCNF_FUSED_LSTM=1: sample {M_DRAWS}x{N_COND} in {t_sample:.3f} s = "
          f"{M_DRAWS * N_COND / t_sample:.0f} samples/s; launches K3a {c['K3a']}, K1 {c['K1']}; max|d| vs the "
          f"time-loop encoder's samples (phase 3) {err:.3e} (tolerance {KERNEL_TOL:g})")
    if (c["K3a"], c["K1"], c["K3b"]) != (4, 1, 0) or not torch.isfinite(out).all():
        fail(f"fused-LSTM sampling launched K3a {c['K3a']}, K1 {c['K1']}, K3b {c['K3b']} or is not finite")
    if not err <= KERNEL_TOL:
        fail(f"fused-LSTM samples disagree with the time loop's: {err:.3e} > {KERNEL_TOL:g}")

    rates = {}
    for B in (4096, 256):
        cfg = _flagship_train_config(B, 1)
        m = CondRealNVP.from_config(cfg)
        c, steps, trained, (y, tr, trainer) = train_with_counts(cfg, m, rng, dev, 4, f"batch {B}")
        add(c)
        if (c["K2a"], c["K2b"]) != (steps, steps):
            fail(f"path A batch {B}: K2a {c['K2a']}, K2b {c['K2b']} for {steps} steps")
        yb = torch.from_numpy(y[:B]).to(dev)
        cb = [torch.from_numpy(tr[:B]).to(dev)]
        step_against_loop(m, trained, yb, cb, dev, f"batch {B}", (4, 4))
        rates[B] = train_rates(m, trainer, trained, yb, cb, dev)
        if B != 4096:
            continue
        # CUDA-event split of one step with the fused LSTM, as in phase 6
        fused_lstm(True)
        p = map_tree(lambda t: t.detach().clone().requires_grad_(True), trained)
        opt = make_optimizer("Adam", lr=2e-4).init(p)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        splits = []
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
            opt.zero_grad()
            ev[0].record()
            h = m.encode(p, cb, gen, train=True)
            ev[1].record()
            kargs, h_proj = m._fused_flow_args(p, h)
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
        split = [sorted(col)[1] for col in zip(*splits)]
        k3b4 = 4 * lstm_times["flagship"]["K3b"]
        print(f"    step split at batch 4096 with the fused LSTM (CUDA events, median of 3, ms): encoder forward "
              f"{split[0]:.2f} (4 x K3a alone ~{4 * lstm_times['flagship']['K3a']:.2f}), projections + stacking "
              f"{split[1]:.2f}, K2a {split[2]:.2f}, loss {split[3]:.2f}, backward {split[4]:.2f} (4 x K3b alone "
              f"~{k3b4:.2f}, K2b alone {k2b_ms:.2f}), clip + Adam {split[5]:.2f}; step {sum(split):.2f} = "
              f"{4096 / sum(split) * 1e3:.0f} samples/s")
    print(f"    train samples/s, flagship: {rates[4096][0]:.0f} at batch 4096 and {rates[256][0]:.0f} at 256 with the "
          f"fused LSTM; {rates[4096][1]:.0f} and {rates[256][1]:.0f} with the time loop (same call)")
    add(cli_round_trip(_flagship_train_config(256, 2), rng, build_dir, 4, "flagship CLI"))
    fused_lstm(False)
    return totals


def dlstm_path_b(rng, dev, build_dir: str) -> None:
    """Phase 10: t_DLSTM_large at its published widths with
    BCNF_FUSED_LSTM=1: sampling, training at batch 256 and 4096, the CLI."""
    import numpy as np
    import torch

    from bcnf_tpu_torch.config import load_config
    from bcnf_tpu_torch.models import CondRealNVP, DualDomainLSTM, count_params

    cfg = load_config(DLSTM_CONFIG).to_dict()
    model = CondRealNVP.from_config(cfg)
    if not isinstance(model.features.feature_networks[1], DualDomainLSTM):
        fail("t_DLSTM_large did not build a DualDomainLSTM encoder")
    params = model.init(torch.Generator().manual_seed(SEED), device=dev)
    n_params = count_params(params)
    if n_params != DLSTM_PARAMS:
        fail(f"t_DLSTM_large has {n_params:,} params, expected {DLSTM_PARAMS:,}")
    traj = torch.from_numpy(rng.normal(size=(N_COND, 30, 3)).astype(np.float32))
    outs, secs, counts = {}, {}, {}
    with torch.no_grad():
        for on in (True, False):
            fused_lstm(on)
            model.sample(params, torch.Generator().manual_seed(SEED), 16, traj, device=dev)  # warm-up
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            outs[on] = model.sample(params, torch.Generator().manual_seed(SEED), M_DRAWS, traj, device=dev)
            torch.cuda.synchronize()
            secs[on], counts[on] = time.perf_counter() - t0, lstm_counts()
    err = (outs[True] - outs[False]).abs().max().item()
    print(f"[10 path B] t_DLSTM_large ({n_params:,} params), BCNF_FUSED_LSTM=1: sample {M_DRAWS}x{N_COND} in "
          f"{secs[True]:.3f} s = {M_DRAWS * N_COND / secs[True]:.0f} samples/s (time loop: "
          f"{M_DRAWS * N_COND / secs[False]:.0f}); launches K3a {counts[True]['K3a']}, K1 {counts[True]['K1']}; "
          f"max|d| vs the time loop's samples {err:.3e} (tolerance {KERNEL_TOL:g})")
    if (counts[True]["K3a"], counts[True]["K1"]) != (16, 1) or counts[False]["K3a"] != 0:
        fail(f"t_DLSTM_large sampling launched K3a {counts[True]['K3a']}, K1 {counts[True]['K1']} "
             f"(time loop: K3a {counts[False]['K3a']})")
    if not torch.isfinite(outs[True]).all() or not err <= KERNEL_TOL:
        fail(f"t_DLSTM_large fused-LSTM samples not finite or off the time loop's: {err:.3e}")

    rates = {}
    for B in (256, 4096):
        tcfg = load_config(DLSTM_CONFIG).to_dict()
        tcfg["training"].update(batch_size=B, n_epochs=1, timeout=None)
        m = CondRealNVP.from_config(tcfg)
        c, steps, trained, (y, tr, trainer) = train_with_counts(tcfg, m, rng, dev, 16, f"t_DLSTM_large batch {B}")
        if (c["K2a"], c["K2b"]) != (0, 0):
            fail(f"t_DLSTM_large batch {B}: the training kernels ran ({c['K2a']}, {c['K2b']}) with coupling dropout 0.5")
        yb = torch.from_numpy(y[:B]).to(dev)
        cb = [torch.from_numpy(tr[:B]).to(dev)]
        if B == 256:
            step_against_loop(m, trained, yb, cb, dev, f"t_DLSTM_large batch {B}", (16, 16))
        rates[B] = train_rates(m, trainer, trained, yb, cb, dev)
    print(f"    train samples/s, t_DLSTM_large: {rates[256][0]:.0f} at batch 256 and {rates[4096][0]:.0f} at 4096 with "
          f"the fused LSTM; {rates[256][1]:.0f} and {rates[4096][1]:.0f} with the time loop (same call)")
    ccfg = load_config(DLSTM_CONFIG).to_dict()
    ccfg["training"].update(n_epochs=2, timeout=None)
    cli_round_trip(ccfg, rng, build_dir, 16, "t_DLSTM_large CLI")
    fused_lstm(False)


def coupling_work(args: dict, rows: int, n_cond: int, H: int, inverse: bool) -> tuple[float, float]:
    """Operations and bytes of one K4 call at the unpadded hidden width H:
    the MLP's products for every row, each weight and condition row read
    once, x_a and x_b read and the output (and the forward's logdet) written."""
    d_a, nh = args["w1y"].shape[0], len(args["wm"])
    n_out = args["wout"].shape[1]
    d_b = n_out // 2
    flops = rows * 2.0 * (d_a * H + nh * H * H + H * n_out)
    weights = d_a * H + H + nh * (H * H + H) + H * n_out + n_out
    nbytes = 4.0 * (weights + n_cond * H + rows * (d_a + 2 * d_b + (0 if inverse else 1)))
    return flops, nbytes


def coupling_path_c(model, params, traj, samples, z_all, y_lp, cond_lp, rng, dev,
                    peaks: tuple[float, float, float]) -> list[dict]:
    """Phase 11: K4 against its plain version at the flagship widths; the
    flagship with `use_pallas_coupling` (26 K4 launches a pass) against K1.
    Returns the K4 entries of the kernel table."""
    import numpy as np
    import torch

    from bcnf_tpu_torch.bridge import map_tree
    from bcnf_tpu_torch.ops.coupling_kernel import (
        coupling_flow_args,
        fused_affine_coupling,
        fused_affine_coupling_reference,
        mlp_params_to_kernel_args,
    )
    from bcnf_tpu_torch.ops.flow_kernel import fused_flow, prepare_weights

    cp = model.coupling
    blk0 = map_tree(lambda t: t[0], params["blocks"]["coupling"])
    args = mlp_params_to_kernel_args(blk0["a"], cp.d_a)
    H = model.nested_sizes[0]
    saved = fused_affine_coupling.launches
    errs = {False: 0.0, True: 0.0}
    with torch.no_grad():
        for B, N in ((4096, 8), (4099, 7)):
            h = model.encode(params, (torch.from_numpy(rng.normal(size=(N, 30, 3)).astype(np.float32)).to(dev),))
            h_proj = cp.cond_proj(blk0, h)
            x = torch.from_numpy(rng.normal(size=(B, model.size)).astype(np.float32)).to(dev)
            x_a, x_b = x[:, : cp.d_a].contiguous(), x[:, cp.d_a:].contiguous()
            for inverse in (False, True):
                out = fused_affine_coupling(x_a, x_b, h_proj, **args, inverse=inverse)
                ref = fused_affine_coupling_reference(x_a, x_b, h_proj, **args, inverse=inverse, n_cond=N)
                torch.cuda.synchronize()
                errs[inverse] = max([errs[inverse]] + [(a - b).abs().max().item() for a, b in zip(
                    (out,) if inverse else out, (ref,) if inverse else ref)])
    if fused_affine_coupling.launches != saved + 4:
        fail("fused_affine_coupling did not count its launches")
    print(f"[11 path C] K4 vs plain at H={H}, B=4096/N=8 and ragged B=4099/N=7: max|d| forward (z_b, logdet) "
          f"{errs[False]:.3e}, inverse {errs[True]:.3e} (tolerance {KERNEL_TOL:g})")
    for inverse, e in errs.items():
        if not e <= KERNEL_TOL:
            fail(f"K4 {'inverse' if inverse else 'forward'} disagrees with its plain version: {e:.3e}")

    # path C: the flagship's inverse over phase 3's sampling rows, and its
    # no-grad forward over the log_prob batch, through K4 in every coupling
    h = model.encode(params, (traj.to(dev),))
    model.use_pallas_coupling = True
    launches = {}
    with torch.no_grad():
        fused_affine_coupling.launches = fused_flow.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y4 = model.inverse_given_h(params, z_all.to(dev), h)
        torch.cuda.synchronize()
        t_inv = time.perf_counter() - t0
        launches[True], k1_inv = fused_affine_coupling.launches, fused_flow.launches
        fused_affine_coupling.launches = 0
        z4, ld4 = model.forward(params, y_lp, cond_lp)
        torch.cuda.synchronize()
        launches[False], k1_fwd = fused_affine_coupling.launches, fused_flow.launches - k1_inv
        model.use_pallas_coupling = False
        z1, ld1 = model.forward(params, y_lp, cond_lp)
    inv_err = (y4 - samples).abs().max().item()
    fwd_err = max((z4 - z1).abs().max().item(), (ld4 - ld1).abs().max().item())
    print(f"    flagship with use_pallas_coupling: inverse of {z_all.shape[0] * z_all.shape[1]} rows in {t_inv:.3f} s "
          f"(K4 launches {launches[True]}, K1 {k1_inv}), max|d| vs K1's samples {inv_err:.3e}; no-grad forward on "
          f"{y_lp.shape[0]} rows (K4 launches {launches[False]}, K1 {k1_fwd}), max|d| z, logdet vs K1's {fwd_err:.3e}")
    n_couplings = model.n_blocks
    if (launches[True], k1_inv, launches[False], k1_fwd) != (n_couplings, 0, n_couplings, 0):
        fail(f"path C launched K4 {launches[True]}/{launches[False]} and K1 {k1_inv}/{k1_fwd} times")
    if not (inv_err <= KERNEL_TOL and fwd_err <= KERNEL_TOL) or not torch.isfinite(y4).all():
        fail(f"path C disagrees with K1: inverse {inv_err:.3e}, forward {fwd_err:.3e}")

    # K4 timed at the main path's shapes: block 0's coupling over the
    # 80,000 sampling rows (inverse) and the 4096 log_prob rows (forward)
    rows = []
    with torch.no_grad():
        x_inv = z_all.to(dev).reshape(-1, model.size)
        shapes = {True: (x_inv, cp.cond_proj(blk0, h), N_COND),
                  False: (y_lp.contiguous(), cp.cond_proj(blk0, model.encode(params, (cond_lp,))), LOGPROB_ROWS)}
        for inverse, (x, hp, n) in shapes.items():
            x_a, x_b = x[:, : cp.d_a].contiguous(), x[:, cp.d_a:].contiguous()
            out = fused_affine_coupling(x_a, x_b, hp, **args, inverse=inverse)
            ref = fused_affine_coupling_reference(x_a, x_b, hp, **args, inverse=inverse, n_cond=n)
            err = max((a - b).abs().max().item() for a, b in zip((out,) if inverse else out, (ref,) if inverse else ref))
            if not err <= KERNEL_TOL:
                fail(f"K4 at the main path's shape disagrees with plain: {err:.3e}")
            k_times = cuda_ms(lambda: fused_affine_coupling(x_a, x_b, hp, **args, inverse=inverse), reps=5)
            p_times = cuda_ms(lambda: fused_affine_coupling_reference(x_a, x_b, hp, **args, inverse=inverse, n_cond=n),
                              reps=3)
            work = coupling_work(args, x.shape[0], n, H, inverse)
            direction = "inverse" if inverse else "forward"
            # what the wrapper prepares each launch: the padded one-step stack, and for
            # the wgmma inverse the hi/lo stage layout of its hidden weights
            prep = (lambda: prepare_weights(coupling_flow_args(hp, **args)["wm"])) if inverse else (
                lambda: coupling_flow_args(hp, **args))
            prep_ms = median(cuda_ms(prep, reps=5))
            src = "bcnf_tpu_torch/ops/csrc/" + ("flow_wgmma.cu" if inverse else "flow_kernel.cu")
            rows.append(kernel_row(f"K4 fused_affine_coupling[{direction}]", src,
                                   "bcnf_tpu/ops/coupling_kernel.py:69", launches[inverse], max(errs[inverse], err),
                                   k_times, p_times, work, peaks, None, ARITH_3XTF32))
            fma_bound = bound_ms(work, peaks, ARITH_FMA)[0]
            print(f"    K4[{direction}] ({'wgmma' if inverse else 'rows'}, 3xtf32) rows {x.shape[0]}: "
                  f"{median(k_times):.3f} ms (bound {rows[-1]['bound_ms']:.3f} ms, float32-FMA bound {fma_bound:.3f} ms, "
                  f"{work[0] / 1e9:.1f} GFLOP -> {work[0] / median(k_times) / 1e9:.1f} TFLOP/s, range "
                  f"{min(k_times):.3f}-{max(k_times):.3f}; of which the weights' preparation {prep_ms:.3f} ms), "
                  f"plain {median(p_times):.3f} ms; max|d| vs plain {err:.2e}; x {n_couplings} couplings a pass")
    fused_affine_coupling.launches = saved
    return rows


if __name__ == "__main__":
    main()
