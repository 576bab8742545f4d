#!/usr/bin/env python3
"""K2b at the padded widths 768 and 1024 on one NVIDIA GPU, in 3xTF32 or
(`--passes 1`) in one TF32 pass: the wide route of the mode
(`csrc/flow_wide_train_wgmma.cu`, library `flow_wide_train_wgmma` or its
one-pass build `flow_wide_train_wgmma_tf32`) beside the row tiles of the
mode (forced, `WIDE_TRAIN_MAX_TN = 0`) and the float32 plain version (and,
in one pass, the plain one-pass version, `mm=tf32.matmul_tf32`), timed in
turns in one process, and its parts, each alone: the rows kernels
(`BWD_ROWS`), the weight-grad passes (`BWD_WEIGHT_GRADS`), the rest
(`BWD_ACTNORM`: the partials' reduction) and the step's weight layout
(`prepare_wide_train_weights`).

Run from the root of a checkout on a machine with a card:

    python3 tools/wide_train_parts.py [--shape wide|tool] [--rows 4096,256] [--passes 3|1] [VARIANT ...]

Each VARIANT is the source's text with a patch (`serial`: each step's
weight-grad pass after its rows kernel on the caller's stream, not beside
the next step's rows kernel; `dwm_groups1`: the weight-grad pass with one
consumer warpgroup a block, each block reading its own B stages, in place
of two sharing them; one pass: `hi8`: a hi ring of 8 stages in place of
11; `wait0`: the rows kernel's products with no group in flight;
`sets2`, `sets4`: 2 or 4 A register sets in place of 8), compiled by nvcc into
`bcnf_tpu_torch/_build/wide_train_parts/` and timed in turns beside the
route as built (its grads held equal to the bit to the build's).

`wide` (the default) is the wide run config's shape
(`trajectory_LSTM_xsmall_large_hybrid_dual`: 32 steps of 4 hidden layers at
H 1024, size 19, d_a 10); `tool` is `tools/wide_rows_times.py`'s (26 steps
at H 700 and 1000). Random weights, rows, conditions and cotangents from
seed 0; the step inputs from K2a on the same rows. Times: CUDA events around
one call, each version in turn and then in reverse, 3 calls a turn, medians;
the wide route is handed the step's weight layout as a training step hands
it (prepared once, outside the time). Also, for each row count: every grad's
distance from the float64 plain version beside the row tiles' and the
float32 plain version's (the bar: max(row tiles, twice the float32 plain
version)), the wide route's grads against the float32 plain version's
(max |d| over max |plain| a grad); in one pass each grad's distance from
the plain one-pass version beside the row tiles' (the bar: within 5e-3 of
max(1, max |plain|), and no further than twice the row tiles), equality to the bit between two calls,
the card layout (shared memory, clusters resident) and the library's ptxas
registers and spills. Exits non-zero where a check fails.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, D_A, NH = 19, 10, 4
SHAPES = {"tool": (26, (700, 1000)), "wide": (32, (1024,))}  # steps; H
GRADS = ("dx", "dh_proj", "dan_scale", "dan_bias", "dw1y", "db1", "dwm", "dbm", "dwout", "dbout")
NAMES = ("an_scale", "an_bias", "ortho", "w1y", "b1", "wm", "bm", "wout", "bout")
# the one-pass rows kernel's wait for the group before the one just issued
ONE_PASS_WAIT = ("            wgmma_wait<1>();  // k-step s - 1's group is done: its A registers and, at a stage's "
                 "first, its stage\n            hold_fragment(a[(b + kWwASets - 1) % kWwASets]);")
PATCHES = {"serial": [("const bool beside = (parts & (kWtRows | kWtGrads)) == (kWtRows | kWtGrads);",
                        "const bool beside = false;")],
           "dwm_groups1": [("constexpr int kWtGwGroups = 2;", "constexpr int kWtGwGroups = 1;")],
           "hi8": [("constexpr int kWwHiStagesTf32 = 11;", "constexpr int kWwHiStagesTf32 = 8;")],
           **{f"sets{n}": [("constexpr int kWwASets = 8;", f"constexpr int kWwASets = {n};")] for n in (2, 4)},
           "wait0": [(ONE_PASS_WAIT, ONE_PASS_WAIT.replace("wgmma_wait<1>", "wgmma_wait<0>"))]}
ONE_PASS_BAR = 5e-3  # JAX's reduced-mode bar, a grad's scale max(1, max |plain|)


def variants(names: list[str], library: str) -> dict[str, tuple[ctypes.CDLL, str]]:
    """One nvcc per variant, all started together; each library typed as
    the route's, and its ptxas registers and spill bytes."""
    from bcnf_tpu_torch.ops import _build

    csrc = os.path.join(HERE, "bcnf_tpu_torch", "ops", "csrc")
    out_dir = os.path.join(HERE, "bcnf_tpu_torch", "_build", "wide_train_parts")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(csrc, "flow_wide_train_wgmma.cu")) as f:
        text = f.read()
    with open(os.path.join(csrc, "flow_wide_wgmma.cu")) as f:
        included = f.read()  # the device parts it includes, which hold the rings
    procs = {}
    for name in names:
        src, inc = text, included
        for old, new in PATCHES[name]:
            if src.count(old) + inc.count(old) != 1:
                raise SystemExit(f"variant {name}: the patch does not apply (the source changed)")
            src, inc = src.replace(old, new), inc.replace(old, new)
        path = os.path.join(out_dir, f"{name}_{library}.cu")
        with open(path, "w") as f:
            f.write(src.replace('#include "flow_wide_wgmma.cu"', f'#include "{name}_{library}_ww.cu"'))
        with open(os.path.join(out_dir, f"{name}_{library}_ww.cu"), "w") as f:
            f.write(inc)
        cmd = [_build._nvcc(), *_build._flags(library), "-I", csrc, "-o", path[:-3] + ".so", path]
        procs[name] = (path[:-3] + ".so", subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                          text=True))
    built = _build.load_library(library)
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on variant {name}:\n{out}")
        lib = ctypes.CDLL(so)
        for fn in ("bcnf_flow_train_bwd_wide", "bcnf_flow_train_wide_scratch", "bcnf_flow_train_wide_layout",
                   "bcnf_cuda_error_string"):
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = getattr(built, fn).argtypes, getattr(built, fn).restype
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", out)
        libs[name] = (lib, f"registers {'/'.join(re.findall(r'Used (\d+) registers', out))}, spill bytes "
                           f"{'/'.join(str(int(a) + int(b)) for a, b in spills)}")
    return libs


def main() -> None:
    import torch

    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from bcnf_tpu_torch.ops import _build
    from bcnf_tpu_torch.ops import flow_kernel as fk
    from bcnf_tpu_torch.ops.tf32 import matmul_tf32

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    argv = sys.argv[1:]
    shape = argv[argv.index("--shape") + 1] if "--shape" in argv else "wide"
    rows_list = [int(r) for r in (argv[argv.index("--rows") + 1] if "--rows" in argv else "4096,256").split(",")]
    passes = int(argv[argv.index("--passes") + 1]) if "--passes" in argv else 3
    names = [a for i, a in enumerate(argv) if not a.startswith("--") and (i == 0 or argv[i - 1] not in (
        "--shape", "--rows", "--passes"))]
    mode = fk.MODE_TF32 if passes == 1 else fk.MODE_3XTF32
    library = fk.TRAIN_BWD_LIBRARY[fk.ROUTE_WIDE_TRAIN_TF32 if passes == 1 else fk.ROUTE_WIDE_TRAIN]
    S, widths = SHAPES[shape]
    torch.backends.cuda.matmul.allow_tf32 = False
    one = _build.ONE_PASS if passes == 1 else ""
    _build.build_all([library, "flow_wide_wgmma" + one, "flow_train_kernel" + one])  # together
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    usage = _build.resource_usage(library)
    print(f"{library}: " + "; ".join(
        f"{cs.kernel_label(repr(fn))} {u['REG']} registers, stack {u['STACK']} B, local {u['LOCAL']} B"
        for fn, u in usage.items()))
    for ln in _build.build_logs.get(library, "").splitlines():
        if "spill" in ln:
            print("    ptxas: " + ln.strip())
    failed = [fn for fn, u in usage.items() if u["STACK"] or u["LOCAL"]]
    built = _build.load_library(library)
    libs = variants(names, library)
    for name, (_, ptxas) in libs.items():
        print(f"variant {name}: {ptxas}")

    def on(lib, fn):  # fn with the route's library swapped for a variant's
        def run():
            _build._loaded[library] = lib
            try:
                return fn()
            finally:
                _build._loaded[library] = built
        return run

    dev = torch.device("cuda")
    peaks = cs.peaks_for(torch.cuda.get_device_name(0))
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    def turns(fns: dict, reps: int = 3) -> dict:
        times = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            times[k] += cs.cuda_ms(fns[k], reps)
        return {k: cs.median(v) for k, v in times.items()}

    def forced(fn):  # fn with K2b on its row tiles
        def run():
            old, fk.WIDE_TRAIN_MAX_TN = fk.WIDE_TRAIN_MAX_TN, 0
            try:
                return fn()
            finally:
                fk.WIDE_TRAIN_MAX_TN = old
        return run

    n_out = 2 * (SIZE - D_A)
    for H in widths:
        w = {"an_scale": 1 + 0.1 * randn(S, SIZE), "an_bias": 0.1 * randn(S, SIZE),
             "ortho": torch.linalg.qr(randn(S, SIZE, SIZE))[0].contiguous(),
             "w1y": randn(S, D_A, H, scale=D_A ** -0.5), "b1": randn(S, H, scale=0.1),
             "wm": randn(S, NH, H, H, scale=H ** -0.5), "bm": randn(S, NH, H, scale=0.1),
             "wout": randn(S, H, n_out, scale=0.3 * H ** -0.5), "bout": randn(S, n_out, scale=0.1)}
        B_max = max(rows_list)
        kargs, hp_all = fk.pad_hidden(w, randn(S, B_max, H, scale=0.5))
        Hp = hp_all.shape[-1]
        args = [kargs[n] for n in NAMES]
        x_all, dz_all, dld_all = randn(B_max, SIZE), randn(B_max, SIZE), randn(B_max)
        route, want = fk.train_bwd_route(Hp, SIZE, D_A, NH, mode), (
            fk.ROUTE_WIDE_TRAIN_TF32 if passes == 1 else fk.ROUTE_WIDE_TRAIN)
        if route != want:
            raise SystemExit(f"H {H}: K2b's {mode} route is {route}, not {want}")
        ws = fk.prepare_wide_train_weights(kargs["wm"], passes)
        prep_ms = cs.median(cs.cuda_ms(lambda: fk.prepare_wide_train_weights(kargs["wm"], passes), 5))
        for rows in rows_list:
            x, hp = x_all[:rows].contiguous(), hp_all[:, :rows].contiguous()
            dz, dld = dz_all[:rows].contiguous(), dld_all[:rows].contiguous()
            with torch.no_grad():
                bound = fk.fused_flow_train_fwd(x, hp, *args, mode=mode, wstages=ws)[2]
            tile = fk.wide_fwd_rows(rows)
            smem, resident, gw_smem, gw_blocks = fk.wide_train_card_layout(Hp, SIZE, D_A, tile, mode)
            wide = lambda: fk.fused_flow_train_bwd(bound, hp, dz, dld, *args, mode=mode, wstages=ws)
            plain = lambda: fk.fused_flow_train_backward_reference(bound, hp, dz, dld, *args)
            plain1 = lambda: fk.fused_flow_train_backward_reference(bound, hp, dz, dld, *args, mm=matmul_tf32)
            grads = [torch.empty_like(t) for t in (dz, hp, *[kargs[n] for n in NAMES if n != "ortho"])]
            ms = turns({"wide": wide, **{name: on(lib, wide) for name, (lib, _) in libs.items()},
                        "rows": forced(wide), "plain": plain, **({"plain one-pass": plain1} if passes == 1 else {})})
            ref = wide()
            for name, (lib, _) in libs.items():
                grads_alone = lambda: fk._train_bwd_parts(bound, hp, dz, dld, dict(zip(NAMES, args)), grads,
                                                          fk.BWD_WEIGHT_GRADS, mode, ws)
                alone = cs.median(cs.cuda_ms(on(lib, grads_alone), 5))
                equal = all(torch.equal(a, b) for a, b in zip(ref, on(lib, wide)()))
                print(f"    variant {name}: {ms[name]:.2f} ms (as built {ms['wide']:.2f}), its weight grads alone "
                      f"{alone:.2f}; grads equal to the build's to the bit: {equal}")
                if not equal:
                    failed.append(f"variant {name}'s grads at H {H}, {rows} rows")
            parts = {}
            for name, bit in (("rows", fk.BWD_ROWS), ("weight grads", fk.BWD_WEIGHT_GRADS), ("rest", fk.BWD_ACTNORM)):
                run = lambda bit=bit: fk._train_bwd_parts(bound, hp, dz, dld, dict(zip(NAMES, args)), grads, bit,
                                                          mode, ws)
                parts[name] = cs.median(cs.cuda_ms(run, 5))
            one, two = wide(), wide()
            k_rows, p32 = forced(wide)(), plain()
            p1 = plain1() if passes == 1 else p32
            p64 = fk.fused_flow_train_backward_reference(bound.double(), hp.double(), dz.double(), dld.double(),
                                                         *[a.double() for a in args])
            torch.cuda.synchronize()
            work = cs.train_work(kargs, hp, rows, H)[1]
            bound_ms, by = cs.bound_ms(work, peaks, cs.ARITH_TF32 if passes == 1 else cs.ARITH_3XTF32)
            print(f"H {H} (Hp {Hp}), {S} steps x {NH} layers, size {SIZE}, d_a {D_A}, {rows} rows on tiles of {tile} "
                  f"({-(-rows // tile)} clusters of {Hp // 128}, {resident} resident; rows kernel {smem} B of shared "
                  f"memory, weight-grad pass {gw_smem} B, {gw_blocks} blocks an SM), {mode}, in turns: wide "
                  f"{ms['wide']:.2f} ms, row tiles (forced) {ms['rows']:.2f}, float32 plain {ms['plain']:.2f}"
                  + (f", plain one-pass {ms['plain one-pass']:.2f}" if passes == 1 else "") + f"; bound {bound_ms:.2f} ms "
                  f"({by}, {bound_ms / ms['wide']:.1%} of the wide route's time)")
            print(f"    parts alone: rows {parts['rows']:.2f} ms, weight grads {parts['weight grads']:.2f}, the rest "
                  f"{parts['rest']:.3f}; the step's weight layout {prep_ms:.3f} ms (outside the times)")
            worst = []
            for name, a, b, r, p, d, q in zip(GRADS, one, two, k_rows, p32, p64, p1):
                dk, dr, dp = ((t.double() - d).abs().max().item() for t in (a, r, p))
                rel = (a - p).abs().max().item() / max(p.abs().max().item(), 1e-30)
                if passes == 1:  # from the plain one-pass version: the reduced bar, and twice the row tiles'
                    dk1, dr1 = (a - q).abs().max().item(), (r - q).abs().max().item()
                    ok = dk1 <= ONE_PASS_BAR * max(1.0, q.abs().max().item()) and dk1 <= 2 * dr1 and torch.equal(a, b)
                    worst.append(f"{name} {dk1:.2e} from the plain one-pass version (rows {dr1:.2e}); from float64 "
                                 f"{dk:.2e} (rows {dr:.2e}, float32 plain {dp:.2e})" + ("" if ok else " FAILS"))
                else:
                    ok = dk <= max(dr, 2 * dp) and torch.equal(a, b)
                    worst.append(f"{name} {dk:.2e} (rows {dr:.2e}, plain {dp:.2e}; {rel:.1e} of max|plain|)"
                                 + ("" if ok else " FAILS"))
                if not ok:
                    failed.append(f"{name} at H {H}, {rows} rows")
            print("    from float64: " + "; ".join(worst), flush=True)
    if failed:
        raise SystemExit(f"failed: {failed}")


if __name__ == "__main__":
    main()
