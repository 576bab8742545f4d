#!/usr/bin/env python3
"""Where the one-pass `wgmma` inverse's time goes, on one NVIDIA GPU: K1's
inverse as the reduced mode builds it (`bcnf_tpu_torch/ops/csrc/flow_wgmma.cu`
with BCNF_TF32_PASSES=1), timed as built and as variants of its design, each
with its parts alone.

Run from the root of a checkout on a machine with a card:

    python3 tools/wgmma_tf32_parts.py [VARIANT ...]

Each variant is the source's text with a patch (`ring2`: a ring of 2
stages; `cluster1`: no cluster, every block streams its own stages;
`no_output`: the FMA output layer skipped; `no_gelu`: the hidden layers'
GELU skipped; `no_input`: the input layer skipped; `input_unhoisted`: its
W1y loads one input at a time), compiled by nvcc into
`bcnf_tpu_torch/_build/wgmma_tf32_parts/`. Each is launched on the
flagship's shape (80,000 rows of size 19 conditioned on 8 rows, 26 steps of
4 hidden layers at Hp 544; random weights from seed 0) with its parts
(`parts` of the kernel's C entry point): both (the inverse), its products
alone (on stale stages), the weights' stream alone, and neither (what the
rest of the kernel costs with the ring's hand-offs). A variant with a part
taken out computes wrong values; only the time is read, beside the largest
|y - y as built| of the variant's whole inverse. Times: CUDA events around
one launch, median of 5 after a warm-up.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATCHES = {
    "as built": [],
    "ring2": [("constexpr int kWgRingTf32 = 4;", "constexpr int kWgRingTf32 = 2;")],
    "cluster1": [("constexpr int kWgClusterTf32 = 2;", "constexpr int kWgClusterTf32 = 1;")],
    "no_output": [("item < (kWgRows / 8) * n_out;", "item < 0;")],
    "no_gelu": [("make_float2(gelu_tanh(acc[p][4 * j + 2 * h] + bias[col]),\n"
                 "                            gelu_tanh(acc[p][4 * j + 2 * h + 1] + bias[col + 1]));",
                 "make_float2(acc[p][4 * j + 2 * h] + bias[col], acc[p][4 * j + 2 * h + 1] + bias[col + 1]);")],
    "no_input": [("input_layer_by_columns<TN>(act, xs,", "if (B < 0) input_layer_by_columns<TN>(act, xs,")],
    "input_unhoisted": [("constexpr int kHoistDa = 16;", "constexpr int kHoistDa = 1;")],
}
PARTS = {"both": 3, "products": 1, "stream": 2, "neither": 0}


def build(names: list[str]) -> dict[str, str]:
    """One nvcc per variant, all started together; returns the libraries."""
    sys.path.insert(0, HERE)
    from bcnf_tpu_torch.ops import _build

    csrc = os.path.join(HERE, "bcnf_tpu_torch", "ops", "csrc")
    out_dir = os.path.join(HERE, "bcnf_tpu_torch", "_build", "wgmma_tf32_parts")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(csrc, "flow_wgmma.cu")) as f:
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
        cmd = [_build._nvcc(), *_build._flags("flow_wgmma_tf32"), "-I", csrc, "-o", lib, path]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on variant {name}:\n{out}")
        libs[name] = lib
    return libs


def main() -> None:
    names = ["as built"] + (sys.argv[1:] or [n for n in PATCHES if n != "as built"])
    libs = build(names)
    import torch

    sys.path.insert(0, HERE)
    from bcnf_tpu_torch.ops import flow_kernel as fk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    S, size, d_a, nh, H, B, N = 26, 19, 9, 4, 526, 80_000, 8

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    w = {"an_scale": 1 + 0.1 * randn(S, size), "an_bias": 0.1 * randn(S, size),
         "ortho": torch.linalg.qr(randn(S, size, size))[0].contiguous(),
         "w1y": randn(S, d_a, H, scale=d_a ** -0.5), "b1": randn(S, H, scale=0.1),
         "wm": randn(S, nh, H, H, scale=H ** -0.5), "bm": randn(S, nh, H, scale=0.1),
         "wout": randn(S, H, 2 * (size - d_a), scale=0.1 * H ** -0.5), "bout": randn(S, 2 * (size - d_a), scale=0.1)}
    kargs, h_proj = fk.pad_hidden(w, randn(S, N, H, scale=0.5))
    Hp = h_proj.shape[-1]
    x = randn(B, size)
    staged = fk.prepare_weights(kargs["wm"], passes=1)
    tensors = [kargs[n] for n in ("an_scale", "an_bias", "ortho", "w1y", "b1")] + [staged] + [
        kargs[n] for n in ("bm", "wout", "bout")]
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
        lib.bcnf_flow_inverse_wgmma.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.bcnf_flow_inverse_wgmma.restype = ctypes.c_int
        y = torch.empty_like(x)
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (x, h_proj, *tensors, y)]

        def launch(parts: int) -> None:
            err = lib.bcnf_flow_inverse_wgmma(*ptrs, B, N, S, size, d_a, nh, Hp, parts, stream)
            if err:
                raise SystemExit(f"variant {name}: launch failed with cudaError {err}")

        launch(3)
        torch.cuda.synchronize()
        built = y.clone() if built is None else built
        err = (y - built).abs().max().item()
        ms = {part: timed(lambda: launch(bits)) for part, bits in PARTS.items()}
        print(f"{name}: " + ", ".join(f"{part} {t:.2f} ms" for part, t in ms.items()) +
              f"; max|y - y as built| {err:.3e}", flush=True)


if __name__ == "__main__":
    main()
