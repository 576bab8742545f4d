#!/usr/bin/env python3
"""Where K2b's `wgmma` route spends its time, on one NVIDIA GPU: the route
as built (`bcnf_tpu_torch/ops/csrc/flow_train_wgmma.cu`, built with
BCNF_TF32_PASSES=1 for the one-pass mode, or as it is for 3xTF32 with
`--passes 3`) and variants of its design, each timed on its rows kernels and
on its weight-grad passes.

Run from the root of a checkout on a machine with a card:

    python3 tools/train_bwd_wgmma_parts.py [--passes 3] [VARIANT ...]

Each variant is the source's text with a patch, compiled by nvcc into
`bcnf_tpu_torch/_build/train_bwd_wgmma_parts/`:
- `no_products`: the rows kernel's square products are not issued (its
  ring, barriers and everything else run);
- `unfolded` (3xTF32): each stage's three passes straight into the running
  sums, one `wgmma` group in flight across the refill, as in one pass (the
  first build; as built, each stage's passes go into a fresh accumulator
  kFoldGroups n-groups at a time, each waited for and folded into the
  running sums);
- `fold_whole` (3xTF32): the fold with a fresh accumulator of all of the
  warpgroup's n-groups (it spills at Hp 544);
- `no_stream`: its weight stages are not copied (the products run on stale
  stages; the ring's barriers are arrived on at once);
- `neither`: both;
- `no_fma`: its FMA layers (input, output, dh, dx_a) and the FMA partials
  (dWout, dW1y) are skipped;
- `no_dh`: only dh = dout Wout^T is skipped;
- `local_sync`: the hidden layers' cluster barriers are block barriers (the
  partner's columns are then stale);
- `no_stage_out`: h_l and da_l are not written out for the weight-grad pass;
- `no_product_loop`: the rows kernel's products and their ring skipped
  (everything but the square products' loop);
- `no_output_layer`, `no_partials` (dWout, dW1y), `no_dx_a`: one FMA part
  skipped;
- `no_gelu_planes`: gelu'(a_l) neither written to the scratch nor read back;
- `chunk1` / `chunk2`: the epilogues' loads issued one or two column pairs
  at a time (kChunk; four as built);
- `gw_no_products` / `gw_no_stream`: the weight-grad pass without its
  products, or without its copies;
- `gw_rows32`: its stages of 32 rows (as built in 3xTF32), a ring of 4.
Each variant's ptxas line for the flagship's instances (registers, spills) is
printed beside it.
A variant that takes a part out computes wrong values; its time is read,
beside the largest |d| of its grads from the route as built and from the
plain one-pass version (each grad's over max(1, max |plain|)). Each is
launched at the flagship's shape (4096 rows of size 19, d_a 10, 26 steps of 4
hidden layers at H 526, Hp 544; random weights from seed 0, prepared once
for the mode) through the C entry point with `parts` 1 (the rows kernels), 2
(the weight-grad passes) and 7 (all); the plain version is the mode's
(`mm=matmul_tf32`, or `matmul_3xtf32` with `--passes 3`).
Times: CUDA events around one call, median of 5 after a warm-up.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the rows kernel's square products in either build: one pass, and 3xTF32 (into the fresh accumulator)
_MMA = [("      WgmmaTf32<NW>::mma(acc, cur[0], smem_desc(st, 128, 256));\n"
         "      WgmmaTf32<NW>::mma(acc, cur[1], smem_desc(st + 2 * TN * 64, 128, 256));\n", ""),
        ("  wgmma_3xtf32<8 * G>(p, ahi, alo, smem_desc(st + G0 * 64, 128, 256), smem_desc(st + 2 * TN * 64 + G0 * 64, "
         "128, 256),\n                      true);\n", "")]
# 3xTF32 with every pass straight into the running sums (no fold), one group in flight as in one pass
_FOLD = ("      fold_groups<TN, 0>(acc, part, cur[0], cur[1], st);\n"
         "      if (next_kcol < Hp) load_a(next_kcol, nxt);  // once `cur` is free\n")
_UNFOLDED = ("      wgmma_3xtf32<NW>(acc, cur[0], cur[1], smem_desc(st, 128, 256), smem_desc(st + 2 * TN * 64, 128, 256));\n"
             "      wgmma_commit();\n"
             "      wgmma_wait<1>();\n"
             "      fence_operands(acc);\n"
             "      if (next_kcol < Hp) load_a(next_kcol, nxt);\n")
_COPY = ("    mbar_arrive_expect_tx(&full[slot], W::stage * sizeof(float));\n"
         "    bulk_copy_g2s(ring + slot * W::stage, src, W::stage * sizeof(float), &full[slot]);\n")
PATCHES = {
    "as built": [],
    "no_products": _MMA,
    "no_stream": [(_COPY, "    mbar_arrive(&full[slot]);\n    (void)src;\n")],
    "neither": _MMA + [(_COPY, "    mbar_arrive(&full[slot]);\n    (void)src;\n")],
    "unfolded": [(_FOLD, _UNFOLDED)],
    "fold_whole": [("constexpr int kFoldGroups = 6;", "constexpr int kFoldGroups = 17;")],
    "no_fma": [("for (int i = 0; i < d_a; ++i) {\n        const float2 w =", "for (int i = 0; i < 0; ++i) {\n        const float2 w ="),
               ("item < (kTwRows / 8) * n_out;", "item < 0;"),
               ("for (int c = 0; c < n_out; ++c) {\n      const float da", "for (int c = 0; c < 0; ++c) {\n      const float da"),
               ("for (int i0 = set; i0 < d_a; i0 += 16) {", "for (int i0 = set; i0 < 0; i0 += 16) {"),
               ("item < NB * groups; item += kTwThreads) {\n      const int i = c0",
                "item < 0; item += kTwThreads) {\n      const int i = c0"),
               ("item < NB * groups; item += kTwThreads) {\n      const int c = c0",
                "item < 0; item += kTwThreads) {\n      const int c = c0")],
    "no_dh": [("for (int c = 0; c < n_out; ++c) {\n      const float da", "for (int c = 0; c < 0; ++c) {\n      const float da")],
    "local_sync": [("if (!last) cluster_sync(); else __syncthreads();", "__syncthreads();"),
                   ("    if (!last) cluster_sync();\n  }", "    __syncthreads();\n  }"),
                   ("if (l > 0) cluster_sync(); else __syncthreads();", "__syncthreads();"),
                   ("    if (l > 0) cluster_sync();\n  }", "    __syncthreads();\n  }")],
    "no_stage_out": [("      if (h_out != nullptr) {", "      if (false) {"),
                     ("      if (da_out != nullptr)  //", "      if (false)  //")],
    "no_product_loop": [("    load_a(0, fa);\n", "    if (B > 0) return;\n    load_a(0, fa);\n")],
    "no_output_layer": [("item < (kTwRows / 8) * n_out;", "item < 0;")],
    "no_partials": [("item < NB * groups; item += kTwThreads) {\n      const int i = c0",
                     "item < 0; item += kTwThreads) {\n      const int i = c0"),
                    ("item < NB * groups; item += kTwThreads) {\n      const int c = c0",
                     "item < 0; item += kTwThreads) {\n      const int c = c0")],
    "no_dx_a": [("for (int i0 = set; i0 < d_a; i0 += 16) {", "for (int i0 = set; i0 < 0; i0 += 16) {")],
    "no_gelu_planes": [("      *reinterpret_cast<float2*>(gl + (e / 2 * kTwThreads + tid) * 2) = make_float2(d0, d1);\n",
                        "      (void)d0; (void)d1; (void)gl;\n"),
                       ("auto load = [&](int e, int, int) { return *reinterpret_cast<const float2*>(gl + (e / 2 * kTwThreads + tid) * 2); };",
                        "auto load = [&](int, int, int) { (void)gl; return make_float2(1.0f, 1.0f); };")],
    "gw_no_products": [("    for (int kk = 0; kk < kGwRows / 8; ++kk) {\n      const float* b =",
                        "    for (int kk = 0; kk < 0; ++kk) {\n      const float* b =")],
    "gw_no_stream": [("    mbar_arrive_expect_tx(&full[slot], stage * sizeof(float));\n",
                      "    mbar_arrive(&full[slot]);\n    return;\n")],
    "chunk1": [("constexpr int kChunk = 4;", "constexpr int kChunk = 1;")],
    "chunk2": [("constexpr int kChunk = 4;", "constexpr int kChunk = 2;")],
    "gw_rows32": [("constexpr int kGwRows = kPasses == 3 ? 32 : 64;", "constexpr int kGwRows = 32;"),
                  ("constexpr int kGwRing = 2;", "constexpr int kGwRing = 4;")],
}
PARTS = {"rows": 1, "weight grads": 2, "all": 7}


def build(names: list[str], passes: int = 1) -> dict[str, str]:
    """One nvcc per variant, all started together, built for `passes` (1 or
    3); returns the libraries."""
    sys.path.insert(0, HERE)
    from bcnf_tpu_torch.ops import _build

    csrc = os.path.join(HERE, "bcnf_tpu_torch", "ops", "csrc")
    out_dir = os.path.join(HERE, "bcnf_tpu_torch", "_build", "train_bwd_wgmma_parts", f"passes{passes}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(csrc, "flow_train_wgmma.cu")) as f:
        text = f.read()
    procs = {}
    for name in names:
        src = text
        for old, new in PATCHES[name]:
            if old not in src:
                raise SystemExit(f"variant {name}: the patch does not apply (the source changed)")
            src = src.replace(old, new)
        path = os.path.join(out_dir, f"{name.replace(' ', '_')}.cu")
        with open(path, "w") as f:
            f.write(src)
        lib = path[:-3] + ".so"
        flags = _build._flags("flow_train_wgmma_tf32" if passes == 1 else "flow_train_wgmma")
        cmd = [_build._nvcc(), *flags, "-I", csrc, "-o", lib, path]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on variant {name}:\n{out}")
        libs[name] = lib
        print(f"{name}: ptxas at TN 17: {ptxas_summary(out)}", flush=True)
    return libs


def ptxas_summary(log: str) -> str:
    """Registers and spills of the rows kernel and the weight-grad pass at
    TN 17 (Hp 544), from nvcc's -Xptxas -v output."""
    found, kernel = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = ("rows" if "bwd_rows_wgmmaILi17E" in line else
                      "weight grads" if "dwm_wgmmaILi17E" in line else None)
        elif kernel and ("registers" in line or "spill" in line):
            found.append(f"{kernel} {line.split(':', 1)[-1].strip()}")
    return "; ".join(found)


def main() -> None:
    args = sys.argv[1:]
    passes = 1
    if "--passes" in args:
        i = args.index("--passes")
        passes = int(args[i + 1])
        args = args[:i] + args[i + 2:]
    if passes not in (1, 3) or any(a not in PATCHES for a in args):
        raise SystemExit(__doc__)
    names = ["as built"] + (args or [n for n in PATCHES if n != "as built"])
    libs = build(names, passes)
    import torch

    from bcnf_tpu_torch.ops import flow_kernel as fk
    from bcnf_tpu_torch.ops.tf32 import matmul_3xtf32, matmul_tf32

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{smi}; {passes} pass(es) a product")
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
    names9 = ("an_scale", "an_bias", "ortho", "w1y", "b1", "wm", "bm", "wout", "bout")
    args = [kargs[n] for n in names9]
    x = randn(B, size)
    _, _, bound = fk.fused_flow_train_reference(x, h_proj, *args)
    dz, dld = randn(B, size), randn(B)
    plain = fk.fused_flow_train_backward_reference(bound, h_proj, dz, dld, *args,
                                                   mm=matmul_tf32 if passes == 1 else matmul_3xtf32)
    tensors = list(args)
    tensors[5] = fk.prepare_train_weights(kargs["wm"], passes)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

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

    built = None
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        lib.bcnf_flow_train_bwd_wgmma.argtypes = [ctypes.c_void_p] * 24 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.bcnf_flow_train_bwd_wgmma.restype = ctypes.c_int
        lib.bcnf_flow_train_wgmma_scratch.argtypes = [ctypes.c_int] * 6
        lib.bcnf_flow_train_wgmma_scratch.restype = ctypes.c_longlong
        grads = [torch.empty_like(t) for t in (dz, h_proj, args[0], args[1], args[3], args[4], args[5], args[6],
                                               args[7], args[8])]
        scratch = torch.zeros((lib.bcnf_flow_train_wgmma_scratch(B, S, size, d_a, nh, Hp),), device=dev)
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (bound, h_proj, dz, dld, *tensors, *grads, scratch)]

        def launch(parts: int) -> None:
            err = lib.bcnf_flow_train_bwd_wgmma(*ptrs, B, S, size, d_a, nh, Hp, parts, stream)
            if err:
                raise SystemExit(f"variant {name}: launch failed with cudaError {err}")

        launch(7)
        torch.cuda.synchronize()
        got = [g.clone() for g in grads]
        built = got if built is None else built
        err = max((a - b).abs().max().item() for a, b in zip(got, built))
        rel = max((a - p).abs().max().item() / max(1.0, p.abs().max().item()) for a, p in zip(got, plain))
        ms = {part: timed(lambda: launch(bits)) for part, bits in PARTS.items()}
        print(f"{name}: " + ", ".join(f"{part} {t:.3f} ms" for part, t in ms.items()) +
              f"; max|grads - as built| {err:.3e}; vs the mode's plain version {rel:.3e}", flush=True)


if __name__ == "__main__":
    main()
