#!/usr/bin/env python3
"""Where the strict K1's time goes, on one NVIDIA GPU: the float32 FMA flow
kernel (`pallas_strict`), timed as built and with each of its parts taken
out, at the flagship's shapes, both directions.

Run from the root of a checkout on a machine with a card:

    python3 tools/strict_flow_parts.py [VARIANT ...]
    python3 tools/strict_flow_parts.py --pr1 OTHER_CHECKOUT [VARIANT ...]

The first form builds this checkout's kernel (`csrc/flow_fma.cu`); the second
the first design of the strict kernel (the `flow_kernel` template of
`csrc/flow_kernel.cu` with the helpers of `csrc/flow_common.cuh`, as the
port had it up to its slice 13) from another checkout's sources, for
instance a `git archive` of that commit unpacked into a directory that
.gitignore lists. Each variant is the sources' text with a patch:

- `products`: the hidden products on whatever the weight buffer holds (the
  weights' copies not issued);
- `stream`: the hidden weights streamed without the products;
- `no_narrow`: the input and the output layers skipped;
- `no_gelu`: the GELU skipped (the activations stay the sums);
- `no_rows`: the per-step row work skipped (ActNorm, the mixes, the
  affine update);
- (this checkout's kernel only) `ring3`: a weight ring of at most 3 stages
  (as built, as many as fit: 4 at the flagship's shape); `stage8`,
  `stage32`: stages of 8 or 32 weight rows (as built, 16); `no_a_loads`,
  `no_w_loads`: the hidden products' activations, or weights, taken from
  registers instead of shared memory (what the loads cost);
  `no_group_sync`: the row groups' named barriers left out; `kk_pipe`: each
  k-step's loads issued before the previous k-step's FMAs.

A variant with a part taken out computes wrong values; only its time is
read, beside the largest |y - y as built|. Each is compiled by nvcc (the
flags of `ops/_build.py`, `-Xptxas -v`, whose register and spill lines for
the strict kernel are printed) into `bcnf_tpu_torch/_build/strict_flow_parts/`,
all at once, and launched through its C entry point on the flagship's
shapes (26 steps of 4 hidden layers at H 526, Hp 544, size 19, d_a 10;
random weights from seed 0): the inverse on 80,000 rows conditioned on 8
(a strict `sample` of 10,000 x 8), the forward on 4096 rows with their own
conditions (`log_prob`). Times: CUDA events around one launch, median of 5
after a warm-up, beside the median SM clock and power nvidia-smi samples
meanwhile.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# variant -> [(file, old text, new text)]: this checkout's kernel
PATCHES = {
    "as built": [],
    "products": [("flow_fma.cu",  # K1's producer (K2a's is indented further)
                  "\n      mbar_arrive_expect_tx(bar, bytes); bulk_copy_g2s(dst, src, bytes, bar);\n      next.advance",
                  "\n      mbar_arrive(bar);\n      next.advance")],
    "stream": [("flow_fma.cu", "if (active) hidden_product<R, TN>(", "if (false) hidden_product<R, TN>(")],
    "no_narrow": [("flow_fma.cu", "if (active) input_product<R, TN>(", "if (false) input_product<R, TN>("),
                  ("flow_fma.cu", "if (active)\n          output_product<R>(", "if (false)\n          output_product<R>(")],
    "no_gelu": [("flow_fma.cu", "v[r] = gelu_tanh(acc[r][j] + b[j]);", "v[r] = acc[r][j] + b[j];")],
    "no_rows": [("flow_fma.cu", "const bool inner = k < S - 1;  // step", "const bool inner = false;  // step"),
                ("flow_fma.cu", "// s for its logdet), then x <- x Q (forward) or ActNorm^-1 (inverse)\n      if (active) {",
                 "// s for its logdet), then x <- x Q (forward) or ActNorm^-1 (inverse)\n      if (false) {")],
    "ring3": [("flow_fma.cu", "constexpr int kFmaRingMax = 6;", "constexpr int kFmaRingMax = 3;")],
    "stage8": [("flow_fma.cu", "constexpr int kFmaStageRows = 16;", "constexpr int kFmaStageRows = 8; ")],
    "stage32": [("flow_fma.cu", "constexpr int kFmaStageRows = 16;", "constexpr int kFmaStageRows = 32;")],
    "no_a_loads": [("flow_fma.cu", "load_rows<R>(at + kk * Sh::ldT, a);",
                    "for (int r = 0; r < R; ++r) a[r] = static_cast<float>(lc + r);")],
    "no_w_loads": [("flow_fma.cu", "load_cols<TN>(ws + kk * Sh::Hp, cq, lc, w);",
                    "for (int j = 0; j < TN; ++j) w[j] = static_cast<float>(cq + j);")],
    "kk_pipe": [("flow_fma.cu", """#pragma unroll
  for (int kk = 0; kk < Sh::BK; ++kk) {
    float w[TN], a[R];
    load_cols<TN>(ws + kk * Sh::Hp, cq, lc, w);
    load_rows<R>(at + kk * Sh::ldT, a);
    fma_k<R, TN>(w, a, acc);
  }""", """float w[2][TN], a[2][R];
  load_cols<TN>(ws, cq, lc, w[0]);
  load_rows<R>(at, a[0]);
#pragma unroll
  for (int kk = 0; kk < Sh::BK; ++kk) {
    if (kk + 1 < Sh::BK) {
      load_cols<TN>(ws + (kk + 1) * Sh::Hp, cq, lc, w[(kk + 1) % 2]);
      load_rows<R>(at + (kk + 1) * Sh::ldT, a[(kk + 1) % 2]);
    }
    fma_k<R, TN>(w[kk % 2], a[kk % 2], acc);
  }""")],
    "no_group_sync": [("flow_fma.cu", 'asm volatile("bar.sync %0, 128;\\n" ::"r"(1 + rg) : "memory");', "__syncwarp();")],
}
# the same parts of the first design (csrc/flow_kernel.cu's strict template)
PATCHES_PR1 = {
    "as built": [],
    "products": [("flow_common.cuh", "for (int i = tid * 4; i < n; i += kThreads * 4)",
                  "for (int i = tid * 4; i < 0; i += kThreads * 4)")],
    "stream": [("flow_common.cuh", "mac_slab<TM, TN>(act, s * BK,", "if (BK < 0) mac_slab<TM, TN>(act, s * BK,")],
    "no_narrow": [("flow_kernel.cu", "for (int i = 0; i < d_a; ++i) {\n        const float* wr = w1y",
                   "for (int i = 0; i < 0; ++i) {\n        const float* wr = w1y"),
                  ("flow_kernel.cu", "matmul_narrow<TM, TN>(act,", "if (B < 0) matmul_narrow<TM, TN>(act,")],
    "no_gelu": [("flow_kernel.cu", "= gelu_tanh(acc[r][j]);", "= acc[r][j];"),
                ("flow_kernel.cu", "gelu_tanh(acc[r][j] + bias[32 * j]);", "acc[r][j] + bias[32 * j];")],
    "no_rows": [("flow_kernel.cu", "const bool inner = k < S - 1;  // step S-1 is the final coupling alone\n"
                 "    const float* Q",
                 "const bool inner = false && k < S - 1;\n    const float* Q"),
                ("flow_kernel.cu", "// ---- affine update of x_b (one thread per row)\n    if (tid < BM) {",
                 "if (tid < 0) {")],
}
SHAPES = {"inverse": (80_000, 8), "forward": (4096, 4096)}  # rows, conditions


def build(root: str, source: str, patches: dict, names: list[str]) -> dict[str, tuple[str, str]]:
    """One nvcc per variant, all started together, each from its own copy of
    the patched files; returns each variant's library and ptxas output."""
    sys.path.insert(0, HERE)
    from bcnf_tpu_torch.ops import _build

    csrc = os.path.join(root, "bcnf_tpu_torch", "ops", "csrc")
    kind = "pr1" if source == "flow_kernel.cu" else "fma"
    procs = {}
    for name in names:
        out_dir = os.path.join(HERE, "bcnf_tpu_torch", "_build", "strict_flow_parts", kind, name.replace(" ", "_"))
        os.makedirs(out_dir, exist_ok=True)
        # the source and every header, so that a patched header is the one each include finds
        files = {f: open(os.path.join(csrc, f)).read() for f in os.listdir(csrc) if f == source or f.endswith(".cuh")}
        for f, old, new in patches[name]:
            if old not in files[f]:
                raise SystemExit(f"variant {name}: the patch of {f} does not apply (the source changed)")
            files[f] = files[f].replace(old, new)
        for f, text in files.items():
            with open(os.path.join(out_dir, f), "w") as fh:
                fh.write(text)
        lib = os.path.join(out_dir, "lib.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, os.path.join(out_dir, source)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on variant {name}:\n{out}")
        libs[name] = (lib, out)
    return libs


def ptxas_lines(log: str, kernel: str) -> list[str]:
    """ptxas's register and spill lines of the entry functions named `kernel`."""
    lines, current = [], ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            current = ln.split("'")[1] if "'" in ln else ""
        elif f"{len(kernel)}{kernel}I" in current and ("registers" in ln or "spill" in ln and " 0 bytes spill" not in ln):
            args = re.findall(r"Li(\d+)E", current.split(f"{len(kernel)}{kernel}", 1)[1])
            lines.append(f"{kernel}<{','.join(args)}>: {ln.split(':', 1)[-1].strip()}")
    return lines


def main() -> None:
    argv = sys.argv[1:]
    root, source, patches, kernel = HERE, "flow_fma.cu", PATCHES, "fma_flow_kernel"
    if argv[:1] == ["--pr1"]:
        if len(argv) < 2:
            raise SystemExit(__doc__)
        root, source, patches, kernel = os.path.abspath(argv[1]), "flow_kernel.cu", PATCHES_PR1, "flow_kernel"
        argv = argv[2:]
    names = ["as built"] + (argv or [n for n in patches if n != "as built"])
    for name in names:
        if name not in patches:
            raise SystemExit(f"unknown variant {name!r}; variants: {', '.join(patches)}")
    libs = build(root, source, patches, names)
    import torch

    sys.path.insert(0, HERE)
    from bcnf_tpu_torch.ops import flow_kernel as fk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    print(f"strict K1 from {os.path.relpath(os.path.join(root, 'bcnf_tpu_torch', 'ops', 'csrc', source), HERE)}")
    for ln in ptxas_lines(libs["as built"][1], kernel):
        print(f"    ptxas {ln}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    S, size, d_a, nh, H = 26, 19, 10, 4, 526

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    w = {"an_scale": 1 + 0.1 * randn(S, size), "an_bias": 0.1 * randn(S, size),
         "ortho": torch.linalg.qr(randn(S, size, size))[0].contiguous(),
         "w1y": randn(S, d_a, H, scale=d_a ** -0.5), "b1": randn(S, H, scale=0.1),
         "wm": randn(S, nh, H, H, scale=H ** -0.5), "bm": randn(S, nh, H, scale=0.1),
         "wout": randn(S, H, 2 * (size - d_a), scale=0.1 * H ** -0.5), "bout": randn(S, 2 * (size - d_a), scale=0.1)}
    inputs = {}
    for direction, (B, N) in SHAPES.items():
        kargs, h_proj = fk.pad_hidden(w, randn(S, N, H, scale=0.5))
        inputs[direction] = (randn(B, size), h_proj, [kargs[n] for n in (
            "an_scale", "an_bias", "ortho", "w1y", "b1", "wm", "bm", "wout", "bout")])
    Hp = inputs["inverse"][1].shape[-1]
    n_out = 2 * (size - d_a)  # the operations of a call at the unpadded width: the MLPs and the mixes
    flops = {d: B * (S * 2 * (d_a * H + nh * H * H + H * n_out) + (S - 1) * 2 * size * size)
             for d, (B, _) in SHAPES.items()}
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

    built = {}
    for name, (path, _) in libs.items():
        lib = ctypes.CDLL(path)
        lib.bcnf_fused_flow.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.bcnf_fused_flow.restype = ctypes.c_int
        cells = []
        for direction, (B, N) in SHAPES.items():
            x, h_proj, tensors = inputs[direction]
            y, ld = torch.empty_like(x), torch.empty((B,), device=dev)
            ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (x, h_proj, *tensors, y, ld)]
            inverse = int(direction == "inverse")

            def launch() -> None:
                err = lib.bcnf_fused_flow(*ptrs, B, N, S, size, d_a, nh, Hp, inverse, stream)
                if err:
                    raise SystemExit(f"variant {name}: launch failed with cudaError {err}")

            launch()
            torch.cuda.synchronize()
            built.setdefault(direction, y.clone())
            err = (y - built[direction]).abs().max().item()
            smi_log = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                        "--format=csv,noheader,nounits", "-lms", "50"],
                                       stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
            ms = timed(launch)
            smi_log.terminate()
            samples = [ln.split(",") for ln in smi_log.communicate()[0].splitlines() if ln.count(",") == 1]
            mhz = sorted(float(c) for c, _ in samples)[len(samples) // 2] if samples else float("nan")
            watts = sorted(float(w) for _, w in samples)[len(samples) // 2] if samples else float("nan")
            cells.append(f"{direction} {B} rows {ms:.2f} ms ({flops[direction] / ms / 1e9:.1f} TFLOP/s; SM clock "
                         f"{mhz:.0f} MHz, {watts:.0f} W, medians of nvidia-smi's samples), "
                         f"max|y - y as built| {err:.3e}")
        print(f"{name}: " + "; ".join(cells), flush=True)


if __name__ == "__main__":
    main()
