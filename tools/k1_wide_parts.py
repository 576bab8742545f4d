#!/usr/bin/env python3
"""Where the wide 3xTF32 inverse's time goes, on one NVIDIA GPU: K1's inverse
at the padded widths 768 and 1024 (`bcnf_tpu_torch/ops/csrc/flow_wide_wgmma.cu`),
timed as built and as variants of its design, each with its parts alone,
beside the row tiles and the float32 plain version.

Run from the root of a checkout on a machine with a card:

    python3 tools/k1_wide_parts.py [--shape tool|wide] [--width H] [VARIANT ...]

Each variant is the source's text with a patch (`trunc_hi`: the stage as
copied serves as hi, the tensor cores truncating it, and the producers
write lo = w - truncated w alone; `hi4`: a hi ring of 4 stages; `one_pass`:
each k-step's hi x hi product alone, a third of the tensor cores' work;
`no_fold`: the running sums take each k-step's fresh sum in place of
adding it), compiled
by nvcc into `bcnf_tpu_torch/_build/k1_wide_parts/`.
Each is launched at each width on the shape (`tool`: 26 steps of 4 hidden
layers at H 700 and 1000, `tools/wide_rows_times.py`'s; `wide`: 32 steps
at H 1024, the wide run config's; size 19, d_a 10, 80,000 rows conditioned
on 8; random weights from seed 0) with its parts (`parts` of the kernel's C
entry point): all (the inverse); its products alone, on stale stages; the
weights' stream and split alone; everything but the exchange (each block
reads its own tile for every k-step's A fragment); everything but the
split; neither products nor stream (the FMA layers, the hand-offs and the
rings' barriers); and the whole kernel with no hidden layer (nh 0: the FMA
layers, the mixes and the hand-offs alone). A variant with a part taken out computes wrong values;
only the time is read. Each variant's whole inverse is held against the
plain version in float64: its max |d| beside the float32 plain version's.
Times: CUDA events around one launch, median of 3 after a warm-up. The row
tiles (forced through `WIDE_WGMMA_MAX_TN = 0`) and the float32 plain
version (TF32 off) are timed beside them in the same process. Prints the
card's name and power limit, each variant's registers and spill bytes
(ptxas), and its clusters resident at once.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATCHES = {
    "as built": [],
    "trunc_hi": [("const float4 h = make_float4(rna(w.x), rna(w.y), rna(w.z), rna(w.w));\n            h4[i] = h;",
                  "const float4 h = make_float4(__uint_as_float(__float_as_uint(w.x) & 0xFFFFE000u), "
                  "__uint_as_float(__float_as_uint(w.y) & 0xFFFFE000u), "
                  "__uint_as_float(__float_as_uint(w.z) & 0xFFFFE000u), "
                  "__uint_as_float(__float_as_uint(w.w) & 0xFFFFE000u));")],
    "hi4": [("constexpr int kWwHiStages = 8;", "constexpr int kWwHiStages = 4;")],
    "one_pass": [("            WgmmaTf32<128>::mma(part, alo, bh, 0);\n            WgmmaTf32<128>::mma(part, ahi, bl);\n"
                  "            WgmmaTf32<128>::mma(part, ahi, bh);",
                  "            WgmmaTf32<128>::mma(part, ahi, bh, 0);")],
    "no_fold": [("            for (int e = 0; e < 64; ++e) acc[e] += part[e];",
                 "            for (int e = 0; e < 64; ++e) acc[e] = part[e];")],
}
PARTS = {"all": 15, "products": 1, "stream": 2 | 8, "no exchange": 15 & ~4, "no split": 15 & ~8, "neither": 0}
SHAPES = {"tool": (26, (700, 1000)), "wide": (32, (1024,))}


def build(names: list[str]) -> dict[str, tuple[str, str]]:
    """One nvcc per variant (a '+' joins patches), all started together;
    returns each library and its ptxas summary."""
    sys.path.insert(0, HERE)
    from bcnf_tpu_torch.ops import _build

    csrc = os.path.join(HERE, "bcnf_tpu_torch", "ops", "csrc")
    out_dir = os.path.join(HERE, "bcnf_tpu_torch", "_build", "k1_wide_parts")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(csrc, "flow_wide_wgmma.cu")) as f:
        text = f.read()
    procs = {}
    for name in names:
        src = text
        for part in name.split("+"):
            for old, new in PATCHES[part]:
                if old not in src:
                    raise SystemExit(f"variant {name}: the patch does not apply (the source changed)")
                src = src.replace(old, new)
        path = os.path.join(out_dir, f"{name.replace(' ', '_').replace('+', '-')}.cu")
        with open(path, "w") as f:
            f.write(src)
        lib = path[:-3] + ".so"
        cmd = [_build._nvcc(), *_build._flags("flow_wide_wgmma"), "-I", csrc, "-o", lib, path]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on variant {name}:\n{out}")
        regs = re.findall(r"Used (\d+) registers", out)
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", out)
        libs[name] = (lib, f"registers {'/'.join(regs)}, spill bytes {'/'.join(str(int(a) + int(b)) for a, b in spills)}")
    return libs


def main() -> None:
    argv, shape, widths = sys.argv[1:], "tool", None
    if argv[:1] == ["--shape"]:
        argv, shape = argv[2:], argv[1]
    if argv[:1] == ["--width"]:  # one of the shape's widths, H
        argv, widths = argv[2:], (int(argv[1]),)
    names = ["as built"] + (argv or [n for n in PATCHES if n != "as built"])
    libs = build(names)
    import torch

    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from bcnf_tpu_torch.ops import flow_kernel as fk

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    peaks = cs.peaks_for(torch.cuda.get_device_name(0))
    gen = torch.Generator(device=dev).manual_seed(0)
    S, widths = SHAPES[shape][0], widths or SHAPES[shape][1]
    size, d_a, nh, B, N = 19, 10, 4, 80_000, 8
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def randn(*shape_, scale=1.0):
        return scale * torch.randn(shape_, generator=gen, device=dev)

    def timed(fn, reps: int = 3) -> float:
        return cs.median(cs.cuda_ms(fn, reps))

    for H in widths:
        w = {"an_scale": 1 + 0.1 * randn(S, size), "an_bias": 0.1 * randn(S, size),
             "ortho": torch.linalg.qr(randn(S, size, size))[0].contiguous(),
             "w1y": randn(S, d_a, H, scale=d_a ** -0.5), "b1": randn(S, H, scale=0.1),
             "wm": randn(S, nh, H, H, scale=H ** -0.5), "bm": randn(S, nh, H, scale=0.1),
             "wout": randn(S, H, 2 * (size - d_a), scale=0.1 * H ** -0.5),
             "bout": randn(S, 2 * (size - d_a), scale=0.1)}
        kargs, h_proj = fk.pad_hidden(w, randn(S, N, H, scale=0.5))
        Hp = h_proj.shape[-1]
        x = randn(B, size)
        staged = fk.prepare_wide_weights(kargs["wm"])
        tensors = [kargs[n] for n in ("an_scale", "an_bias", "ortho", "w1y", "b1")] + [staged] + [
            kargs[n] for n in ("bm", "wout", "bout")]
        bound = cs.bound_ms(cs.flow_work(kargs, h_proj, B, H), peaks, cs.ARITH_3XTF32)[0]
        with torch.no_grad():
            p32 = fk.fused_flow_reference(x, h_proj, **kargs, inverse=True, n_cond=N)
            p64 = fk.fused_flow_reference(x.double(), h_proj.double(), **{k: v.double() for k, v in kargs.items()},
                                          inverse=True, n_cond=N)
            d32 = (p32.double() - p64).abs().max().item()

            def rows():
                old, fk.WIDE_WGMMA_MAX_TN = fk.WIDE_WGMMA_MAX_TN, 0
                try:
                    return fk.fused_flow(x, h_proj, **kargs, inverse=True, n_cond=N)
                finally:
                    fk.WIDE_WGMMA_MAX_TN = old

            ref_ms = {"row tiles": timed(rows), "plain": timed(lambda: fk.fused_flow_reference(
                x, h_proj, **kargs, inverse=True, n_cond=N))}
        print(f"H {H} (Hp {Hp}), {S} steps x {nh} layers, {B} rows: bound {bound:.2f} ms; row tiles "
              f"{ref_ms['row tiles']:.2f} ms, float32 plain {ref_ms['plain']:.2f} ms (from float64 {d32:.3e}); "
              f"card layout (smem, clusters) {fk.wide_card_layout(Hp, size, d_a)}", flush=True)
        for name, (path, ptxas) in libs.items():
            lib = ctypes.CDLL(path)
            lib.bcnf_flow_inverse_wide.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
            lib.bcnf_flow_inverse_wide.restype = ctypes.c_int
            lib.bcnf_flow_wide_clusters.argtypes = [ctypes.c_int] * 3
            y = torch.empty_like(x)
            ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (x, h_proj, *tensors, y)]

            def launch(parts: int) -> None:
                err = lib.bcnf_flow_inverse_wide(*ptrs, B, N, S, size, d_a, nh, Hp, parts, stream)
                if err:
                    raise SystemExit(f"variant {name}: launch failed with cudaError {err}")

            launch(15)
            torch.cuda.synchronize()
            dk = (y.double() - p64).abs().max().item()
            err = (y - p32).abs().max().item()
            ms = {part: timed(lambda: launch(bits)) for part, bits in PARTS.items()}
            ms["nh 0"] = timed(lambda: lib.bcnf_flow_inverse_wide(*ptrs, B, N, S, size, d_a, 0, Hp, 15, stream))
            print(f"    {name} ({ptxas}; {lib.bcnf_flow_wide_clusters(Hp, size, d_a)} clusters): "
                  + ", ".join(f"{part} {t:.2f}" for part, t in ms.items())
                  + f" ms; {bound / ms['all']:.1%} of the bound; max|d| from plain {err:.2e}, from float64 {dk:.3e} "
                  f"({dk / d32:.2f}x the float32 plain version's)", flush=True)


if __name__ == "__main__":
    main()
