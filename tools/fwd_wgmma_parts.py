#!/usr/bin/env python3
"""Where the `wgmma` forward spends its time, on one NVIDIA GPU: the kernel
as built (`bcnf_tpu_torch/ops/csrc/flow_fwd_wgmma.cu`, built with
BCNF_TF32_PASSES=1 for the one-pass mode, or as it is for 3xTF32 with
`--passes 3`) and variants of it, each timed as K2a (with its step-input
store) and as K1's forward.

Run from the root of a checkout on a machine with a card:

    python3 tools/fwd_wgmma_parts.py [--passes 3] [VARIANT ...]

Each variant is the source's text with a patch, compiled by nvcc into
`bcnf_tpu_torch/_build/fwd_wgmma_parts/`:
- `products`: the products alone: the hidden weights' stages are not
  copied (the products run on stale stages; their barriers are arrived on
  at once);
- `stream`: the stream alone: the square products are not issued (the
  ring, its barriers and everything else run);
- `neither`: both taken out (the FMA layers, the epilogues, the exchanges
  and the ring's hand-offs);
- `no_fma`: the FMA layers (the input layer's d_a inputs, the output
  layer) skipped;
- `no_gelu`: the epilogues' GELU skipped (h = a);
- `no_fma_gelu`: both;
- `no_input`, `no_output`: one FMA layer skipped;
- `no_hproj`: the input layer reads no condition projection (one float a
  row, not 2 a column pair);
- `no_exchange`: no activation is written to the partner's tile;
- `local_sync`: the hidden layers' cluster barriers are block barriers (the
  partner's columns are then stale);
- `sync2`: the products' block barrier (and the refill after it) every
  second stage, not every stage (a ring of at least 3);
- `ring3`, `ring2`: at most 3 or 2 ring stages (4 at the flagship's shape);
- `chunk2`: the epilogues' loads issued two column pairs at a time (kChunk;
  four as built).
Each variant's ptxas line for the flagship's instances (registers, spills)
is printed beside it. A variant that takes a part out computes wrong values;
its time is read, beside the largest |d| of its z from the kernel as built.
Each is launched at the flagship's shape (4096 rows of size 19, d_a 10, 26
steps of 4 hidden layers at H 526, Hp 544; random weights from seed 0,
prepared once for the mode) through the C entry point; the mode's row
tiles (`flow_kernel_tf32`, or `flow_kernel` in 3xTF32) are timed beside, on
the same inputs.
Times: CUDA events around one call, median of 5 after a warm-up.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MMA = ("    if constexpr (kPasses == 1) {\n"
        "      WgmmaTf32<NW>::mma(acc, cur[0], smem_desc(st, 128, 256));\n"
        "      WgmmaTf32<NW>::mma(acc, cur[1], smem_desc(st + 2 * TN * 64, 128, 256));\n"
        "    } else {\n"
        "      wgmma_3xtf32<NW>(acc, cur[0], cur[1], smem_desc(st, 128, 256), smem_desc(st + 2 * TN * 64, 128, 256));\n"
        "    }\n")
_COPY = ("      mbar_arrive_expect_tx(bar, W::stage * sizeof(float));\n"
         "      bulk_copy_g2s(dst, src, W::stage * sizeof(float), bar);\n")
_NO_COPY = "      mbar_arrive(bar);\n      (void)src;\n"
_INPUT = "for (int i = 0; i < d_a; ++i) {\n        const float xa0"
_OUTPUT = "item < (kFwRows / 8) * n_out;"
_GELU = "const float h0 = gelu_tanh(acc[e] + b.x), h1 = gelu_tanh(acc[e + 1] + b.y);"
_FMA = [(_INPUT, _INPUT.replace("i < d_a", "i < 0")), (_OUTPUT, "item < 0;")]
_NO_GELU = [(_GELU, "const float h0 = acc[e] + b.x, h1 = acc[e + 1] + b.y;")]
PATCHES = {
    "as built": [],
    "products": [(_COPY, _NO_COPY)],
    "stream": [(_MMA, "")],
    "neither": [(_MMA, ""), (_COPY, _NO_COPY)],
    "no_fma": _FMA,
    "no_gelu": _NO_GELU,
    "no_fma_gelu": _FMA + _NO_GELU,
    "local_sync": [("      if (!last) cluster_sync(); else __syncthreads();  // the tiles' readers are done\n",
                    "      __syncthreads();\n"),
                   ("      if (!last) cluster_sync(); else __syncthreads();  // both tiles whole",
                    "      __syncthreads();  // both tiles whole")],
    "no_input": [_FMA[0]],
    "no_output": [_FMA[1]],
    "no_hproj": [("        return row0 + row < B ? *reinterpret_cast<const float2*>(hp) : make_float2(0.0f, 0.0f);",
                  "        return row0 + row < B ? make_float2(hp[0] * 0.0f, 0.0f) : make_float2(0.0f, 0.0f);")],
    "no_exchange": [("      if (exchange) st_peer2(", "      if (false) st_peer2(")],
    "sync2": [("    __syncthreads();  // every warpgroup is done with stage t - 1\n    release(t);\n",
               "    if (t & 1) {\n      __syncthreads();\n      release(t);\n    }\n"),
              ("constexpr int kFwRingMin = 2;", "constexpr int kFwRingMin = 3;")],
    "ring3": [("constexpr int kFwRingMax = 8;", "constexpr int kFwRingMax = 3;")],
    "ring2": [("constexpr int kFwRingMax = 8;", "constexpr int kFwRingMax = 2;")],
    "chunk2": [("constexpr int kChunk = 4;", "constexpr int kChunk = 2;")],
}


def build(names: list[str], passes: int = 1) -> dict[str, str]:
    """One nvcc per variant, all started together, built for `passes` (1 or
    3); returns the libraries."""
    sys.path.insert(0, HERE)
    from bcnf_tpu_torch.ops import _build

    csrc = os.path.join(HERE, "bcnf_tpu_torch", "ops", "csrc")
    out_dir = os.path.join(HERE, "bcnf_tpu_torch", "_build", "fwd_wgmma_parts", f"passes{passes}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(csrc, "flow_fwd_wgmma.cu")) as f:
        text = f.read()
    procs = {}
    for name in names:
        src = text
        for old, new in PATCHES[name]:
            if src.count(old) != 1:
                raise SystemExit(f"variant {name}: the patch does not apply (the source changed)")
            src = src.replace(old, new)
        path = os.path.join(out_dir, f"{name.replace(' ', '_')}.cu")
        with open(path, "w") as f:
            f.write(src)
        lib = path[:-3] + ".so"
        flags = _build._flags("flow_fwd_wgmma_tf32" if passes == 1 else "flow_fwd_wgmma")
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
    """Registers and spills of the kernel at TN 17 (Hp 544), K2a's instance
    (with the step-input store), from nvcc's -Xptxas -v output."""
    found, on = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            on = "fwd_rows_wgmmaILi17ELb1E" in line
        elif on and ("registers" in line or "spill" in line):
            found.append(line.split(":", 1)[-1].strip())
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

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{smi}; {passes} pass(es) a product")
    mode = fk.MODE_TF32 if passes == 1 else fk.MODE_3XTF32
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
    tensors = [kargs[n] for n in names9]
    tensors[5] = fk.prepare_train_weights(kargs["wm"], passes)
    x = randn(B, size)
    z, ld, bound = torch.empty_like(x), torch.empty(B, device=dev), torch.empty(S, B, size, device=dev)
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

    args = dict(kargs, h_proj=h_proj)
    max_tn = fk.FWD_WGMMA_MAX_TN
    fk.FWD_WGMMA_MAX_TN = 0
    tiles = timed(lambda: fk._launch_flow(x, args, inverse=False, n_cond=B, mode=mode))
    fk.FWD_WGMMA_MAX_TN = max_tn
    print(f"the row tiles ({fk.ROUTE_LIBRARY[fk.ROUTE_ROWS_TF32 if passes == 1 else fk.ROUTE_ROWS]}), K1's forward: "
          f"{tiles:.3f} ms; the weight preparation {timed(lambda: fk.prepare_train_weights(kargs['wm'], passes)):.3f} ms",
          flush=True)
    built = None
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        lib.bcnf_flow_fwd_wgmma.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.bcnf_flow_fwd_wgmma.restype = ctypes.c_int

        def launch(store: bool) -> None:
            ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (x, h_proj, *tensors, z, ld)]
            err = lib.bcnf_flow_fwd_wgmma(*ptrs, ctypes.c_void_p(bound.data_ptr() if store else 0), B, B, S, size,
                                          d_a, nh, Hp, stream)
            if err:
                raise SystemExit(f"variant {name}: launch failed with cudaError {err}")

        launch(True)
        torch.cuda.synchronize()
        got = z.clone()
        built = got if built is None else built
        ms = {"K2a": timed(lambda: launch(True)), "K1 forward": timed(lambda: launch(False))}
        print(f"{name}: " + ", ".join(f"{part} {t:.3f} ms" for part, t in ms.items()) +
              f"; max|z - as built| {(got - built).abs().max().item():.3e}", flush=True)


if __name__ == "__main__":
    main()
