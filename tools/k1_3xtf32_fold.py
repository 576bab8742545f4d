#!/usr/bin/env python3
"""K1's 3xTF32 `wgmma` inverse (`csrc/flow_wgmma.cu`, library `flow_wgmma`)
as built against variants that fold each k-stage's products into a float32
running sum, on one card, in one process: each build's distance from the
plain version in float64, its registers and spills, and its time.

The tensor cores' accumulator truncates at each `wgmma`; over the 204
accumulating products of a 544-long dot product (68 k-stages of three
passes) that bias is what a fold removes. Variants (scratch nvcc builds of
patched copies of the sources, all started together):

- `as built`: the kernel as it is;
- `fold`: each product's three passes a k-stage into a fresh accumulator of
  the product's width (68 floats a thread at Hp 544), then a float32 add;
- `fold_halves`: the same, a half of the product's columns at a time (a
  fresh accumulator of at most 36 floats), so that it fits beside the
  running sums; four waits a k-stage instead of one.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/k1_3xtf32_fold.py [--trained] [VARIANT ...]

The flagship `trajectory_LSTM_large` with random weights from seed 0 (its
ActNorm moved off identity): (a) a rank batch, 100 conditions x 1000 draws
(the shape of phase 12's check in chip_smoke.py), and (b) the sampling
shape, 10,000 draws x 8 conditions. With `--trained`, first (c) phase 12's
rank batch on phase 12's weights: the `train` CLI on the published config
for 1 epoch, its 5000 trajectories generated on the card, then 1000 draws
for each of the first 100 training conditions (z from the seed, as phase 12
draws it). For each variant: max |y - y64| against the plain version
evaluated in float64 on the same rows (the float32 plain version's own
distance printed beside), equal to the bit between two calls; at (b)
CUDA-event times in turns (as built first and last). Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "{{BCNF_ROOT}}/configs/runs/trajectory_LSTM_large.yaml"
LIB = "flow_wgmma"
SOURCE = "flow_wgmma.cu"

# the 3xTF32 build's k-stage: its two products' three passes into the running sums
STAGE = """          const float* hi0 = ring + st * W::stage + (wg * 2 * TN) * 64;
          const uint64_t bh0 = smem_desc(hi0, 128, 256), bh1 = smem_desc(hi0 + TN * 64, 128, 256);
          wgmma_fence();
          const float* lo0 = hi0 + 8 * Hp;
          const uint64_t bl0 = smem_desc(lo0, 128, 256), bl1 = smem_desc(lo0 + TN * 64, 128, 256);
          WgmmaTf32<W::NP>::mma(acc[0], alo, bh0);
          WgmmaTf32<W::NP>::mma(acc[1], alo, bh1);
          WgmmaTf32<W::NP>::mma(acc[0], ahi, bl0);
          WgmmaTf32<W::NP>::mma(acc[1], ahi, bl1);
          WgmmaTf32<W::NP>::mma(acc[0], ahi, bh0);
          WgmmaTf32<W::NP>::mma(acc[1], ahi, bh1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_operands(acc[0]);
          fence_operands(acc[1]);"""
FOLD = """          const float* hi0 = ring + st * W::stage + (wg * 2 * TN) * 64;
          const float* lo0 = hi0 + 8 * Hp;
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const uint64_t bh = smem_desc(hi0 + p * TN * 64, 128, 256), bl = smem_desc(lo0 + p * TN * 64, 128, 256);
            float part[W::R];
#pragma unroll
            for (int e = 0; e < W::R; ++e) part[e] = 0.0f;
            wgmma_fence();
            WgmmaTf32<W::NP>::mma(part, alo, bh);
            WgmmaTf32<W::NP>::mma(part, ahi, bl);
            WgmmaTf32<W::NP>::mma(part, ahi, bh);
            wgmma_commit();
            wgmma_wait<0>();
            fence_operands(part);
#pragma unroll
            for (int e = 0; e < W::R; ++e) acc[p][e] += part[e];
          }"""
FOLD_HALVES = """          const float* hi0 = ring + st * W::stage + (wg * 2 * TN) * 64;
          const float* lo0 = hi0 + 8 * Hp;
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            fold_half<TN, 0>(acc[p], alo, ahi, hi0 + p * TN * 64, lo0 + p * TN * 64);
            if constexpr (TN > 1) fold_half<TN, 1>(acc[p], alo, ahi, hi0 + p * TN * 64, lo0 + p * TN * 64);
          }"""
# the half H of a product's n-groups (H 0: the first (TN + 1) / 2, H 1: the rest): its three passes into a
# fresh accumulator, folded into the running sum by float32 adds
FOLD_HALF = """
template <int TN, int H>
__device__ __forceinline__ void fold_half(float (&acc)[4 * TN], const uint32_t (&alo)[4], const uint32_t (&ahi)[4],
                                          const float* hi, const float* lo) {
  constexpr int G0 = H == 0 ? 0 : (TN + 1) / 2, G = H == 0 ? (TN + 1) / 2 : TN / 2;
  float part[4 * G];
#pragma unroll
  for (int e = 0; e < 4 * G; ++e) part[e] = 0.0f;
  const uint64_t bh = smem_desc(hi + G0 * 64, 128, 256), bl = smem_desc(lo + G0 * 64, 128, 256);
  wgmma_fence();
  WgmmaTf32<8 * G>::mma(part, alo, bh);
  WgmmaTf32<8 * G>::mma(part, ahi, bl);
  WgmmaTf32<8 * G>::mma(part, ahi, bh);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(part);
#pragma unroll
  for (int e = 0; e < 4 * G; ++e) acc[4 * G0 + e] += part[e];
}
"""
CONSUMER_SYNC = "__device__ __forceinline__ void consumer_sync()"
INCLUDE = '#include "wgmma_tf32.cuh"\n'


def wgmma_spec(n: int) -> str:
    """`bcnf::WgmmaTf32<n>` (m64n{n}k8, tf32, A from registers), written as
    csrc/wgmma_tf32.cuh writes the widths it has."""
    r = n // 2
    regs = ", ".join(f"%{i}" for i in range(r))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(r))
    return (f"template <>\nstruct WgmmaTf32<{n}> {{\n"
            f"  static __device__ __forceinline__ void mma(float (&d)[{r}], const uint32_t (&a)[4], uint64_t desc) {{\n"
            f'    asm volatile(\n        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"\n'
            f'        "wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 "\n'
            f'        "{{{regs}}}, "\n'
            f'        "{{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, p, 1, 1;\\n}}\\n"\n'
            f"        : {outs}\n"
            f'        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));\n  }}\n}};\n')


# variant -> [(old text, new text)] in flow_wgmma.cu
PATCHES = {
    "as built": [],
    "fold": [(STAGE, FOLD)],
    "fold_halves": [(STAGE, FOLD_HALVES),
                    (INCLUDE, INCLUDE + "\nnamespace bcnf {\n" + wgmma_spec(48) + wgmma_spec(72) + "}  // namespace bcnf\n"),
                    (CONSUMER_SYNC, FOLD_HALF.lstrip("\n") + "\n" + CONSUMER_SYNC)],
}


def build(names: list[str]) -> dict[str, str]:
    """One nvcc per variant, all started together, each from its own patched
    copy of the sources; returns each variant's library, printing ptxas's
    register and spill lines."""
    from bcnf_tpu_torch.ops import _build

    csrc = os.path.join(HERE, "bcnf_tpu_torch", "ops", "csrc")
    procs = {}
    for name in names:
        out = os.path.join(HERE, "bcnf_tpu_torch", "_build", "k1_3xtf32_fold", name.replace(" ", "_"))
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(csrc, os.path.join(out, "csrc"))
        path = os.path.join(out, "csrc", SOURCE)
        with open(path) as f:
            text = f.read()
        for old, new in PATCHES[name]:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name!r}: its patch does not apply to {SOURCE}")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(out, f"lib{LIB}.so")
        procs[name] = (lib, subprocess.Popen([_build._nvcc(), *_build._flags(LIB), "-o", lib, path],
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or ("spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line):
                print(f"  ptxas {name}: {line.strip().removeprefix('ptxas info    : ')}")
        libs[name] = lib
    return libs


def load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bcnf_flow_inverse_wgmma.argtypes = [ptr] * 12 + [i32] * 8 + [ptr]
    lib.bcnf_flow_inverse_wgmma.restype = i32
    lib.bcnf_cuda_error_string.argtypes = [i32]
    lib.bcnf_cuda_error_string.restype = ctypes.c_char_p
    return lib


def trained(model, dev) -> tuple:
    """Phase 12's weights: the `train` CLI on the published flagship config
    for 1 epoch, its dataset generated on the card from the seed; returns
    the trained params and the first 100 training conditions."""
    import pickle
    import tempfile

    import torch
    import yaml

    import bcnf_tpu_torch.__main__ as cli
    from bcnf_tpu_torch.bridge import params_from_numpy
    from bcnf_tpu_torch.config import load_config, sub_root_path
    from bcnf_tpu_torch.train.data import TrainerDataHandler

    build_dir = os.path.join(HERE, "bcnf_tpu_torch", "_build")
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        with open(sub_root_path(CONFIG)) as f:
            cfg = yaml.safe_load(f)
        cfg["data"]["path"] = os.path.join(tmp, "train_data")
        cfg["training"]["n_epochs"] = 1
        cfg_path, model_dir = os.path.join(tmp, "run.yaml"), os.path.join(tmp, "model")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f)
        cli.main(["train", "-c", cfg_path, "-o", model_dir])
        with open(os.path.join(model_dir, "params.pkl"), "rb") as f:
            trained_np = pickle.load(f)
        run_cfg = load_config(cfg_path)
        _, conds = TrainerDataHandler().get_data_for_training({k.lower(): v for k, v in run_cfg.items()},
                                                              model.parameter_index_mapping)
    return params_from_numpy(trained_np, dev), torch.from_numpy(conds[0][:100]).to(dev)


def main() -> None:
    args = sys.argv[1:]
    with_trained = "--trained" in args
    names = [a for a in args if a != "--trained"] or list(PATCHES)
    if any(n not in PATCHES for n in names):
        raise SystemExit(__doc__)
    names = ["as built"] + [n for n in names if n != "as built"]
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    from bcnf_tpu_torch import CondRealNVP
    from bcnf_tpu_torch.config import load_config
    from bcnf_tpu_torch.ops import _build
    from bcnf_tpu_torch.ops.flow_kernel import MODE_3XTF32, ROUTE_WGMMA, fused_flow, fused_flow_reference

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    libs = {name: load(path) for name, path in build(names).items()}
    dev = torch.device("cuda")
    model = CondRealNVP.from_config(load_config(CONFIG))
    params = model.init(torch.Generator().manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    an = params["blocks"]["actnorm"]
    params = dict(params, blocks=dict(params["blocks"], actnorm={
        "scale": an["scale"] + 0.1 * torch.from_numpy(rng.normal(size=an["scale"].shape).astype(np.float32)).to(dev),
        "bias": 0.1 * torch.from_numpy(rng.normal(size=an["bias"].shape).astype(np.float32)).to(dev)}))

    def run(name: str, x, kargs, h_proj, n_cond):
        saved = _build._loaded.get(LIB)
        _build._loaded[LIB] = libs[name]
        try:
            return fused_flow(x, h_proj, **kargs, inverse=True, n_cond=n_cond, mode=MODE_3XTF32)
        finally:
            if saved is None:
                del _build._loaded[LIB]
            else:
                _build._loaded[LIB] = saved

    def times(name: str, x, kargs, h_proj, n_cond, reps: int = 3) -> list[float]:
        run(name, x, kargs, h_proj, n_cond)
        out = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run(name, x, kargs, h_proj, n_cond)
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
        return out

    cases = [("rank batch", 100, 1000, params, None), ("sampling", 8, 10_000, params, None)]
    if with_trained:
        cases.insert(0, ("trained rank batch", 100, 1000, *trained(model, dev)))
    for what, n_cond, draws, weights, conds in cases:
        traj = conds if conds is not None else torch.from_numpy(
            rng.normal(size=(n_cond, 30, 3)).astype(np.float32)).to(dev)
        with torch.no_grad():
            kargs, h_proj = model._fused_flow_args(weights, model.encode(weights, (traj,)))
            x = torch.randn((draws * n_cond, model.size), generator=torch.Generator(device=dev).manual_seed(0),
                            device=dev)
            before = fused_flow.route_launches[ROUTE_WGMMA]
            y = {name: (run(name, x, kargs, h_proj, n_cond), run(name, x, kargs, h_proj, n_cond)) for name in libs}
            if fused_flow.route_launches[ROUTE_WGMMA] != before + 2 * len(libs):
                raise SystemExit("K1 did not launch on its wgmma route")
            y_p = fused_flow_reference(x, h_proj, **kargs, inverse=True, n_cond=n_cond)
            y_64 = fused_flow_reference(x.double(), h_proj.double(), **{k: v.double() for k, v in kargs.items()},
                                        inverse=True, n_cond=n_cond)
            torch.cuda.synchronize()
        parts = [f"float32 plain {(y_p.double() - y_64).abs().max().item():.3e}"]
        for name in libs:
            d = (y[name][0].double() - y_64).abs().max().item()
            parts.append(f"{name} {d:.3e} ({100 * d / 1e-4:.1f}% of the 1e-4 bar; equal between calls: "
                         f"{torch.equal(*y[name])})")
        print(f"{what} ({x.shape[0]:,} rows, N {n_cond}): max|y - y64|: " + "; ".join(parts), flush=True)
        if what == "sampling":
            order = names + names[::-1]
            t = {name: [] for name in names}
            with torch.no_grad():
                for name in order:
                    t[name] += times(name, x, kargs, h_proj, n_cond)
            print(f"sampling ({x.shape[0]:,} rows): CUDA-event ms (in turns {', '.join(order)}; 6 each): " +
                  "; ".join(f"{name} median {sorted(v)[len(v) // 2]:.2f} (range {min(v):.2f}-{max(v):.2f})"
                            for name, v in t.items()))


if __name__ == "__main__":
    main()
