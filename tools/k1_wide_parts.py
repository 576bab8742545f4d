#!/usr/bin/env python3
"""Where the wide kernels' time goes, on one NVIDIA GPU: K1's inverse, or
with `--forward` K1's forward, at the padded widths 768 and 1024
(`bcnf_tpu_torch/ops/csrc/flow_wide_wgmma.cu`), in 3xTF32 or (`--passes
1`) in the one-pass build, timed as built and as variants of its design,
each with its parts alone, beside the row tiles of the mode and the float32
plain version.

Run from the root of a checkout on a machine with a card:

    python3 tools/k1_wide_parts.py [--shape tool|wide] [--width H] [--forward ROWS] [--passes 3|1] [VARIANT ...]

Each variant is the source's text with a patch (the inverse's: `trunc_hi`:
the stage as copied serves as hi, the tensor cores truncating it, and the
producers write lo = w - truncated w alone, as the forward's do; `hi4`: a
hi ring of 4 stages; `one_pass`: each k-step's hi x hi product alone, a
third of the tensor cores' work; `no_fold`: the running sums take each
k-step's fresh sum in place of adding it; the forward's: `fold0`: no fold,
the passes summed in the tensor cores; `fold1`, `fold8`, `fold32`: a fold
every 1, 8 or 32 k-steps in place of 16; `fwd_one_pass`: hi x hi alone;
`loads_before`: the next k-step's fragment read before the current one is
split, not after its group is issued; timing only, the values wrong: `no_free`,
`no_landed`: the hidden layers without the hand-off before or after their
epilogue; one pass, either way: `hi8`: a hi ring of 8 stages in place of
11; `wait0`: each k-step's group waited for before the next is issued (no
group in flight); `sets2`, `sets4`: 2 or 4 A register sets in place of 8,
each fragment read 1 or 3 k-steps ahead in place of 7; `+` joins patches),
compiled
by nvcc into `bcnf_tpu_torch/_build/k1_wide_parts/`.
Each is launched at each width on the shape (`tool`: 26 steps of 4 hidden
layers at H 700 and 1000, `tools/wide_rows_times.py`'s; `wide`: 32 steps
at H 1024, the wide run config's; size 19, d_a 10, 80,000 rows conditioned
on 8, or with `--forward ROWS` that many rows with their own conditions,
on each of the forward's tiles, 128 and 64 rows; random weights from seed
0) with its parts (`parts` of the kernel's C entry point): all (the inverse,
or the forward); its products alone, on stale stages; the
weights' stream and split alone; everything but the exchange (each block
reads its own tile for every k-step's A fragment); everything but the
split; neither products nor stream (the FMA layers, the hand-offs and the
rings' barriers); and the whole kernel with no hidden layer (nh 0: the FMA
layers, the mixes and the hand-offs alone). A variant with a part taken out computes wrong values;
only the time is read. Each variant's whole inverse (or forward: z and
logdet) is held against the plain version in float64: its max |d| beside
the float32 plain version's (and, forward, the row tiles'); in one pass
against the plain one-pass version (`mm=tf32.matmul_tf32`), beside the
one-pass row tiles'.
Times: CUDA events around one launch, median of 3 after a warm-up. The row
tiles (forced through `WIDE_WGMMA_MAX_TN = 0`, forward `WIDE_FWD_MAX_TN = 0`) and the float32 plain
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
# the one-pass loop's wait for the group before the one just issued
ONE_PASS_WAIT = ("              wgmma_wait<1>();  // k-step s - 1's group is done: its A registers and, at a stage's "
                 "first, its stage\n              hold_fragment(a[(b + kWwASets - 1) % kWwASets]);")
PATCHES = {
    "as built": [],
    "trunc_hi": [("                const float4 h = make_float4(rna(w.x), rna(w.y), rna(w.z), rna(w.w));\n"
                  "                h4[i] = h;",
                  "                const float4 h = make_float4(trunc_tf32(w.x), trunc_tf32(w.y), trunc_tf32(w.z), "
                  "trunc_tf32(w.w));")],
    "hi4": [("constexpr int kWwHiStages = 8;", "constexpr int kWwHiStages = 4;")],
    "one_pass": [("            WgmmaTf32<NW>::mma(part, alo, bh, 0);\n            WgmmaTf32<NW>::mma(part, ahi, bl);\n"
                  "            WgmmaTf32<NW>::mma(part, ahi, bh);",
                  "            WgmmaTf32<NW>::mma(part, ahi, bh, 0);")],
    "no_fold": [("#pragma unroll\n            for (int e = 0; e < R; ++e) acc[e] += part[e];",
                 "#pragma unroll\n            for (int e = 0; e < R; ++e) acc[e] = part[e];")],
    **{f"fold{n}": [("constexpr int kWwFwdFold = 16;", f"constexpr int kWwFwdFold = {n};")] for n in (0, 1, 8, 32)},
    "fwd_one_pass": [("            WgmmaTf32<NW>::mma(sum, a[b][1], bh, keep);\n            WgmmaTf32<NW>::mma(sum, a[b][0], bl);\n"
                      "            WgmmaTf32<NW>::mma(sum, a[b][0], bh);",
                      "            WgmmaTf32<NW>::mma(sum, a[b][0], bh, keep);")],
    "loads_before": [("            split_tf32(cur, a[b][0], a[b][1]);",
                      "            if (s + 1 < KS) ld_cluster4(frag_at(s + 1), nxt);\n            split_tf32(cur, a[b][0], a[b][1]);"),
                     ("            if (s + 1 < KS) ld_cluster4(frag_at(s + 1), nxt);  // read while the group runs\n", "")],
    # timing only (the values are wrong): the forward without a hidden layer's hand-off before or after its epilogue
    "no_free": [("      if (!kTwoTiles) hand_off_free();  // every block is done reading the tiles of h_l",
                 "      if (kInverse) hand_off_free();  // every block is done reading the tiles of h_l")],
    "no_landed": [("      hand_off_landed();\n    }\n\n    // ---- output layer",
                   "      if (kInverse) hand_off_landed();\n    }\n\n    // ---- output layer")],
    # one pass
    "hi8": [("constexpr int kWwHiStagesTf32 = 11;", "constexpr int kWwHiStagesTf32 = 8;")],
    **{f"sets{n}": [("constexpr int kWwASets = 8;", f"constexpr int kWwASets = {n};")] for n in (2, 4)},
    "wait0": [(ONE_PASS_WAIT, ONE_PASS_WAIT.replace("wgmma_wait<1>", "wgmma_wait<0>"))],
}
# the variants run by default: the inverse's, and the forward's (`--forward`); in one pass either way's
DEFAULTS = {True: ("trunc_hi", "hi4", "one_pass", "no_fold"),
            False: ("fold0", "fold1", "fold8", "fwd_one_pass", "loads_before", "no_free+no_landed")}
ONE_PASS_DEFAULTS = ("sets2", "sets4", "hi8", "wait0")
PARTS = {"all": 15, "products": 1, "stream": 2 | 8, "no exchange": 15 & ~4, "no split": 15 & ~8, "neither": 0}
SHAPES = {"tool": (26, (700, 1000)), "wide": (32, (1024,))}


def build(names: list[str], library: str = "flow_wide_wgmma") -> dict[str, tuple[str, str]]:
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
        path = os.path.join(out_dir, f"{name.replace(' ', '_').replace('+', '-')}_{library}.cu")
        with open(path, "w") as f:
            f.write(src)
        lib = path[:-3] + ".so"
        cmd = [_build._nvcc(), *_build._flags(library), "-I", csrc, "-o", lib, path]
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
    argv, shape, widths, fwd_rows, passes = sys.argv[1:], "tool", None, 0, 3
    while argv[:1] in (["--shape"], ["--width"], ["--forward"], ["--passes"]):
        if argv[0] == "--shape":
            shape = argv[1]
        elif argv[0] == "--width":  # one of the shape's widths, H
            widths = (int(argv[1]),)
        elif argv[0] == "--passes":
            passes = int(argv[1])
        else:  # the forward on this many rows
            fwd_rows = int(argv[1])
        argv = argv[2:]
    inverse = not fwd_rows
    names = ["as built"] + (argv or list(DEFAULTS[inverse] if passes == 3 else ONE_PASS_DEFAULTS))
    libs = build(names, "flow_wide_wgmma" + ("_tf32" if passes == 1 else ""))
    import torch

    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from bcnf_tpu_torch.ops import flow_kernel as fk
    from bcnf_tpu_torch.ops.tf32 import matmul_tf32

    mode = fk.MODE_TF32 if passes == 1 else fk.MODE_3XTF32

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    peaks = cs.peaks_for(torch.cuda.get_device_name(0))
    gen = torch.Generator(device=dev).manual_seed(0)
    S, widths = SHAPES[shape][0], widths or SHAPES[shape][1]
    size, d_a, nh = 19, 10, 4
    B, N = (80_000, 8) if inverse else (fwd_rows, fwd_rows)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    limit = "WIDE_WGMMA_MAX_TN" if inverse else "WIDE_FWD_MAX_TN"

    def randn(*shape_, scale=1.0):
        return scale * torch.randn(shape_, generator=gen, device=dev)

    def timed(fn, reps: int = 3) -> float:
        return cs.median(cs.cuda_ms(fn, reps))

    def outputs(out) -> tuple:
        return (out,) if inverse else tuple(out)

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
        staged = fk.prepare_wide_weights(kargs["wm"], passes)
        tensors = [kargs[n] for n in ("an_scale", "an_bias", "ortho", "w1y", "b1")] + [staged] + [
            kargs[n] for n in ("bm", "wout", "bout")]
        bound = cs.bound_ms(cs.flow_work(kargs, h_proj, B, H), peaks,
                            cs.ARITH_TF32 if passes == 1 else cs.ARITH_3XTF32)[0]
        with torch.no_grad():
            p32 = outputs(fk.fused_flow_reference(x, h_proj, **kargs, inverse=inverse, n_cond=N))
            # the distances' reference: float64, or in one pass the plain one-pass version
            p64 = outputs(fk.fused_flow_reference(x, h_proj, **kargs, inverse=inverse, n_cond=N, mm=matmul_tf32)
                          if passes == 1 else fk.fused_flow_reference(
                              x.double(), h_proj.double(), **{k: v.double() for k, v in kargs.items()},
                              inverse=inverse, n_cond=N))

            def dist(out) -> list[float]:
                return [(a.double() - b).abs().max().item() for a, b in zip(out, p64)]

            def rows():
                old = getattr(fk, limit)
                setattr(fk, limit, 0)
                try:
                    return fk.fused_flow(x, h_proj, **kargs, inverse=inverse, n_cond=N, mode=mode)
                finally:
                    setattr(fk, limit, old)

            d32, drt = dist(p32), dist(outputs(rows()))
            ref_ms = {"row tiles": timed(rows), "plain": timed(lambda: fk.fused_flow_reference(
                x, h_proj, **kargs, inverse=inverse, n_cond=N))}
        tiles = (fk.kernel_limit("kWwRows"),) if inverse else (fk.kernel_limit("kWwRows"), fk.kernel_limit("kWwHalfRows"))
        ref = "the plain one-pass version" if passes == 1 else "float64"
        print(f"H {H} (Hp {Hp}), {S} steps x {nh} layers, {B} rows, {'inverse' if inverse else 'forward'}, {mode}: "
              f"bound {bound:.2f} ms; row tiles {ref_ms['row tiles']:.2f} ms (from {ref} "
              f"{'/'.join(f'{d:.3e}' for d in drt)}), float32 plain {ref_ms['plain']:.2f} ms (from {ref} "
              f"{'/'.join(f'{d:.3e}' for d in d32)}); card layout (smem, clusters) by tile "
              f"{[fk.wide_card_layout(Hp, size, d_a, r, not inverse, mode) for r in tiles]}", flush=True)
        for name, (path, ptxas) in libs.items():
            lib = ctypes.CDLL(path)
            lib.bcnf_flow_inverse_wide.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
            lib.bcnf_flow_forward_wide.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
            y, ld = torch.empty_like(x), torch.empty((B,), device=dev)
            ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (x, h_proj, *tensors, y)]
            for tile in tiles:
                def launch(parts: int, layers: int = nh) -> None:
                    if inverse:
                        err = lib.bcnf_flow_inverse_wide(*ptrs, B, N, S, size, d_a, layers, Hp, parts, stream)
                    else:
                        err = lib.bcnf_flow_forward_wide(*ptrs, ctypes.c_void_p(ld.data_ptr()), ctypes.c_void_p(0),
                                                         B, N, S, size, d_a, layers, Hp, tile, parts, stream)
                    if err:
                        raise SystemExit(f"variant {name}: launch failed with cudaError {err}")

                launch(15)
                torch.cuda.synchronize()
                out = (y,) if inverse else (y, ld)
                dk, err = dist(out), max((a - b).abs().max().item() for a, b in zip(out, p32))
                ms = {part: timed(lambda: launch(bits)) for part, bits in PARTS.items()}
                ms["nh 0"] = timed(lambda: launch(15, 0))
                print(f"    {name}, {tile}-row tiles ({ptxas}): "
                      + ", ".join(f"{part} {t:.2f}" for part, t in ms.items())
                      + f" ms; {bound / ms['all']:.1%} of the bound; max|d| from float32 plain {err:.2e}, from {ref} "
                      + "/".join(f"{d:.3e} ({d / p:.2f}x the float32 plain version's, {d / r:.2f}x the row tiles')"
                                 for d, p, r in zip(dk, d32, drt)), flush=True)


if __name__ == "__main__":
    main()
