#!/usr/bin/env python3
"""K2b in 3xTF32 at the padded widths 768 and 1024 on one NVIDIA GPU: the
wide route (`csrc/flow_wide_train_wgmma.cu`) beside the row tiles (forced,
`WIDE_TRAIN_MAX_TN = 0`) and the float32 plain version, timed in turns in
one process, and its parts, each alone: the rows kernels (`BWD_ROWS`), the weight-grad passes
(`BWD_WEIGHT_GRADS`), the rest (`BWD_ACTNORM`: the partials' reduction) and
the step's weight layout (`prepare_wide_train_weights`).

Run from the root of a checkout on a machine with a card:

    python3 tools/wide_train_parts.py [--shape wide|tool] [--rows 4096,256] [VARIANT ...]

Each VARIANT is the source's text with a patch (`serial`: each step's
weight-grad pass after its rows kernel on the caller's stream, not beside
the next step's rows kernel; `dwm_groups1`: the weight-grad pass with one
consumer warpgroup a block, each block reading its own B stages, in place
of two sharing them), compiled by nvcc into
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
(max |d| over max |plain| a grad), equality to the bit between two calls,
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
LIBRARY = "flow_wide_train_wgmma"
PATCHES = {"serial": [("const bool beside = (parts & (kWtRows | kWtGrads)) == (kWtRows | kWtGrads);",
                        "const bool beside = false;")],
           "dwm_groups1": [("constexpr int kWtGwGroups = 2;", "constexpr int kWtGwGroups = 1;")]}


def variants(names: list[str]) -> dict[str, tuple[ctypes.CDLL, str]]:
    """One nvcc per variant, all started together; each library typed as
    the route's, and its ptxas registers and spill bytes."""
    from bcnf_tpu_torch.ops import _build

    csrc = os.path.join(HERE, "bcnf_tpu_torch", "ops", "csrc")
    out_dir = os.path.join(HERE, "bcnf_tpu_torch", "_build", "wide_train_parts")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(csrc, LIBRARY + ".cu")) as f:
        text = f.read()
    procs = {}
    for name in names:
        src = text
        for old, new in PATCHES[name]:
            if src.count(old) != 1:
                raise SystemExit(f"variant {name}: the patch does not apply (the source changed)")
            src = src.replace(old, new)
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        cmd = [_build._nvcc(), *_build._flags(LIBRARY), "-I", csrc, "-o", path[:-3] + ".so", path]
        procs[name] = (path[:-3] + ".so", subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                          text=True))
    built = _build.load_library(LIBRARY)
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

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    argv = sys.argv[1:]
    shape = argv[argv.index("--shape") + 1] if "--shape" in argv else "wide"
    rows_list = [int(r) for r in (argv[argv.index("--rows") + 1] if "--rows" in argv else "4096,256").split(",")]
    names = [a for i, a in enumerate(argv) if not a.startswith("--") and (i == 0 or argv[i - 1] not in ("--shape",
                                                                                                        "--rows"))]
    S, widths = SHAPES[shape]
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(["flow_wide_train_wgmma", "flow_wide_wgmma", "flow_train_kernel"])  # together
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    usage = _build.resource_usage("flow_wide_train_wgmma")
    print("flow_wide_train_wgmma: " + "; ".join(
        f"{cs.kernel_label(repr(fn))} {u['REG']} registers, stack {u['STACK']} B, local {u['LOCAL']} B"
        for fn, u in usage.items()))
    for ln in _build.build_logs.get("flow_wide_train_wgmma", "").splitlines():
        if "spill" in ln:
            print("    ptxas: " + ln.strip())
    failed = [fn for fn, u in usage.items() if u["STACK"] or u["LOCAL"]]
    built = _build.load_library(LIBRARY)
    libs = variants(names)
    for name, (_, ptxas) in libs.items():
        print(f"variant {name}: {ptxas}")

    def on(lib, fn):  # fn with the route's library swapped for a variant's
        def run():
            _build._loaded[LIBRARY] = lib
            try:
                return fn()
            finally:
                _build._loaded[LIBRARY] = built
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
        route = fk.train_bwd_route(Hp, SIZE, D_A, NH)
        if route != fk.ROUTE_WIDE_TRAIN:
            raise SystemExit(f"H {H}: K2b's 3xTF32 route is {route}, not {fk.ROUTE_WIDE_TRAIN}")
        ws = fk.prepare_wide_train_weights(kargs["wm"])
        prep_ms = cs.median(cs.cuda_ms(lambda: fk.prepare_wide_train_weights(kargs["wm"]), 5))
        for rows in rows_list:
            x, hp = x_all[:rows].contiguous(), hp_all[:, :rows].contiguous()
            dz, dld = dz_all[:rows].contiguous(), dld_all[:rows].contiguous()
            with torch.no_grad():
                bound = fk.fused_flow_train_fwd(x, hp, *args, wstages=ws)[2]
            tile = fk.wide_fwd_rows(rows)
            smem, resident, gw_smem, gw_blocks = fk.wide_train_card_layout(Hp, SIZE, D_A, tile)
            wide = lambda: fk.fused_flow_train_bwd(bound, hp, dz, dld, *args, wstages=ws)
            plain = lambda: fk.fused_flow_train_backward_reference(bound, hp, dz, dld, *args)
            grads = [torch.empty_like(t) for t in (dz, hp, *[kargs[n] for n in NAMES if n != "ortho"])]
            ms = turns({"wide": wide, **{name: on(lib, wide) for name, (lib, _) in libs.items()},
                        "rows": forced(wide), "plain": plain})
            ref = wide()
            for name, (lib, _) in libs.items():
                grads_alone = lambda: fk._train_bwd_parts(bound, hp, dz, dld, dict(zip(NAMES, args)), grads,
                                                          fk.BWD_WEIGHT_GRADS, fk.MODE_3XTF32, ws)
                alone = cs.median(cs.cuda_ms(on(lib, grads_alone), 5))
                equal = all(torch.equal(a, b) for a, b in zip(ref, on(lib, wide)()))
                print(f"    variant {name}: {ms[name]:.2f} ms (as built {ms['wide']:.2f}), its weight grads alone "
                      f"{alone:.2f}; grads equal to the build's to the bit: {equal}")
                if not equal:
                    failed.append(f"variant {name}'s grads at H {H}, {rows} rows")
            parts = {}
            for name, bit in (("rows", fk.BWD_ROWS), ("weight grads", fk.BWD_WEIGHT_GRADS), ("rest", fk.BWD_ACTNORM)):
                run = lambda bit=bit: fk._train_bwd_parts(bound, hp, dz, dld, dict(zip(NAMES, args)), grads, bit,
                                                          fk.MODE_3XTF32, ws)
                parts[name] = cs.median(cs.cuda_ms(run, 5))
            one, two = wide(), wide()
            k_rows, p32 = forced(wide)(), plain()
            p64 = fk.fused_flow_train_backward_reference(bound.double(), hp.double(), dz.double(), dld.double(),
                                                         *[a.double() for a in args])
            torch.cuda.synchronize()
            work = cs.train_work(kargs, hp, rows, H)[1]
            bound_ms, by = cs.bound_ms(work, peaks, cs.ARITH_3XTF32)
            print(f"H {H} (Hp {Hp}), {S} steps x {NH} layers, size {SIZE}, d_a {D_A}, {rows} rows on tiles of {tile} "
                  f"({-(-rows // tile)} clusters of {Hp // 128}, {resident} resident; rows kernel {smem} B of shared "
                  f"memory, weight-grad pass {gw_smem} B, {gw_blocks} blocks an SM), in turns: wide {ms['wide']:.2f} "
                  f"ms, row tiles (forced) {ms['rows']:.2f}, float32 plain {ms['plain']:.2f}; bound {bound_ms:.2f} ms "
                  f"({by}, {bound_ms / ms['wide']:.1%} of the wide route's time)")
            print(f"    parts alone: rows {parts['rows']:.2f} ms, weight grads {parts['weight grads']:.2f}, the rest "
                  f"{parts['rest']:.3f}; the step's weight layout {prep_ms:.3f} ms (outside the times)")
            worst = []
            for name, a, b, r, p, d in zip(GRADS, one, two, k_rows, p32, p64):
                dk, dr, dp = ((t.double() - d).abs().max().item() for t in (a, r, p))
                rel = (a - p).abs().max().item() / max(p.abs().max().item(), 1e-30)
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
