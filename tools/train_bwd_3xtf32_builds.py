#!/usr/bin/env python3
"""K2b in 3xTF32 (`bcnf_tpu_torch/ops/csrc/flow_train_kernel.cu`, the row
tiles) as this checkout builds it against another checkout's build, on one
NVIDIA GPU: the same grads to the bit, and their times side by side.

Run from the root of a checkout on a machine with a card, naming the other
checkout's root (for instance a `git archive` of the parent commit unpacked
into a directory that .gitignore lists):

    python3 tools/train_bwd_3xtf32_builds.py OTHER_CHECKOUT

Each checkout's `flow_train_kernel.cu` is compiled by nvcc with that
checkout's headers and this checkout's flags (`ops/_build.py`) into
`bcnf_tpu_torch/_build/train_bwd_3xtf32_builds/`, both at once, and launched
through its C entry point at the flagship's shape (4096 rows of size 19, d_a
10, 26 steps of 4 hidden layers at H 526, Hp 544; random weights, step
inputs and cotangents from seed 0). Prints whether every grad is equal to
the bit, and each build's time (CUDA events around one call, median of 5
after a warm-up) in turns: this, other, other, this.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build(roots: dict[str, str]) -> dict[str, str]:
    """One nvcc per checkout, started together; returns the libraries."""
    sys.path.insert(0, HERE)
    from bcnf_tpu_torch.ops import _build

    out_dir = os.path.join(HERE, "bcnf_tpu_torch", "_build", "train_bwd_3xtf32_builds")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, root in roots.items():
        csrc = os.path.join(root, "bcnf_tpu_torch", "ops", "csrc")
        lib = os.path.join(out_dir, f"{name}.so")
        cmd = [_build._nvcc(), *_build._flags("flow_train_kernel"), "-I", csrc, "-o", lib,
               os.path.join(csrc, "flow_train_kernel.cu")]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the {name} checkout:\n{out}")
        libs[name] = lib
    return libs


def main() -> None:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    libs = build({"this": HERE, "other": os.path.abspath(sys.argv[1])})
    import torch

    from bcnf_tpu_torch.ops import flow_kernel as fk

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
    _, _, bound = fk.fused_flow_train_reference(randn(B, size), h_proj, *args)
    dz, dld = randn(B, size), randn(B)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    calls, grads = {}, {}
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        lib.bcnf_flow_train_bwd.argtypes = [ctypes.c_void_p] * 24 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.bcnf_flow_train_bwd.restype = ctypes.c_int
        lib.bcnf_flow_train_bwd_scratch.argtypes = [ctypes.c_int] * 6
        lib.bcnf_flow_train_bwd_scratch.restype = ctypes.c_longlong
        out = [torch.empty_like(t) for t in (dz, h_proj, *args[:2], *args[3:])]
        scratch = torch.empty((lib.bcnf_flow_train_bwd_scratch(B, S, size, d_a, nh, Hp),), device=dev)
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (bound, h_proj, dz, dld, *args, *out, scratch)]

        def call(lib=lib, ptrs=ptrs, name=name) -> None:
            err = lib.bcnf_flow_train_bwd(*ptrs, B, S, size, d_a, nh, Hp, 7, stream)
            if err:
                raise SystemExit(f"the {name} build's launch failed with cudaError {err}")

        call()
        torch.cuda.synchronize()
        calls[name], grads[name] = call, [t.clone() for t in out]
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(grads["this"], grads["other"]))

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

    times = [(name, timed(calls[name])) for name in ("this", "other", "other", "this")]
    print(f"K2b 3xTF32 at the flagship's shape: every grad of this checkout's build equal to the other's to the bit: "
          f"{same}; ms in turns: " + ", ".join(f"{name} {t:.3f}" for name, t in times))
    if not same:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
