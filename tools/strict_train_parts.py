#!/usr/bin/env python3
"""Where the strict training pair's time goes, on one NVIDIA GPU: the
training backward K2b (`csrc/flow_train_fma.cu`) and forward K2a with its
keep (`csrc/flow_fma.cu`'s `fma_flow_train_kernel`) in exact float32
(`pallas_strict`), timed as built and with each of their parts taken out,
at the flagship's shape.

Run from the root of a checkout on a machine with a card:

    python3 tools/strict_train_parts.py [VARIANT ...]
    python3 tools/strict_train_parts.py --first OTHER_CHECKOUT [VARIANT ...]
    python3 tools/strict_train_parts.py --k2a-against OTHER_CHECKOUT [VARIANT ...]

The first form builds this checkout's kernel; the second also the first
design of the strict K2b (a rows kernel a step that recomputes the step's
MLP, then a weight-grad pass a step) from another
checkout's `csrc/flow_train_fma.cu`, for instance a `git archive` of that
commit unpacked into a directory that .gitignore lists, so that both are
timed in one run. Its variants are named `first <variant>`. Each variant is
the sources' text with a patch.

This checkout's kernel (one rows kernel over every step on the activations
the strict K2a keeps, then one weight-grad pass over every step's jobs):
- `products`: the rows kernel's products on whatever the weight ring holds
  (the weights' copies not issued);
- `stream`: the rows kernel's weights streamed without its hidden products;
- `no_acts`: the rows kernel's reads of K2a's gelu'(a_l) (their ring
  stages left empty) and of its s taken out (zeros);
- `atb_no_smem`: the weight-grad pass's shared-memory loads of A and B taken
  from registers (each stage's first row, loaded once a stage);
- `atb_one_level`: its per-stage sums added straight into the running sums
  (one level: one running sum over all rows);
- `atb_16`: weight-grad stages of 16 rows (as built, 32);
- `atb_no_loads`: the weight-grad pass on whatever its first stages hold
  (no copies after them: its arithmetic and barriers alone);
- `atb_one_block`: one block an SM (as built, two);
- `atb_unroll2`, `atb_unroll8`, `atb_unroll32`: the weight-grad pass's row
  loop unrolled 2, 8 or 32 times (as built, 4): the same sums in the same
  order.

The two designs' grads as built are compared, bit for bit. Each variant's
grads are also held against the plain version in float64 on
the same inputs: the largest over the ten grads of max |d| / max |float64|,
beside the float32 plain version's (the smoke's bar: at most twice it).

The strict K2a's variants (`k2a ...`, this checkout's `csrc/flow_fma.cu`
patched and built alone; the keep leaves the epilogue: gelu' through two
staging slots of the weight ring a layer, copied out in bulk by the
producer, h from the tile by the producer warpgroup's other warps):
- `k2a as built`, and `k2a body`: the same library called with no keep (the
  body alone: K1's forward with the step-input store);
- `k2a no_stores`: gelu's staging slots handed out and written, its bulk
  stores not issued (the slots' hand-offs and the epilogue's writes; h
  still stored);
- `k2a no_keepers`: h's stores from the tile not issued (the tile's
  hand-offs to the keepers still made; gelu' still stored): with
  `no_stores`, each array's share, and K2a's side of keeping one array a
  layer;
- `k2a no_writes`: the epilogue writes h into the tile alone (no gelu', no
  staging writes); the slots still handed out and stored (stale bytes);
- `k2a no_fence`: without the proxy fence before the slot's hand-off (not
  safe: times only).
With `--k2a-against OTHER_CHECKOUT` another checkout's strict K2a (its
`csrc/flow_fma.cu` as built, for instance the parent commit's) is built and
timed in turns with this one's (`other k2a`): this, other, other, this;
then the two again in turns on the flagship's own inputs as chip_smoke.py's
phase 6b makes them (`configs/runs/trajectory_LSTM_large.yaml` at dropout
0, its weights from seed 0, the conditions from random trajectories through
its encoder's time loop); and on both sets of inputs the strict pair's
grads (K2a keeping, K2b on its keep: this checkout's, and the other's from
its `csrc/flow_fma.cu` and `csrc/flow_train_fma.cu` at their C entry points,
each on its own keep's layout) are compared bit for bit, and the two pairs
timed in turns (this, other, other, this): K2a keeping, K2b alone on its
own K2a's keep, and the pair.
Each K2a variant's time is the median of 5 CUDA-event-timed calls at 4096
rows, beside its ptxas registers and spill bytes and its keep's largest
|d| from this checkout's as built.

The first design's (`first ...`): `products`, `stream`, `one_step` (the
step loop cut to one inner step: its rows kernel and weight-grad pass once,
to set beside 26), `atb_no_smem` (its weight-grad pass's shared-memory loads
taken from registers: values made from the loop's indices, which adds
conversions), `atb_one_block` (its weight-grad pass at one block
an SM, by asking for more shared memory; as built 2-3 an SM).

A variant with a part taken out computes wrong grads; only its time is
read, beside the largest |grad - grad as built| of its kind. Each is
compiled by nvcc (the flags of `ops/_build.py`, `-Xptxas -v`, whose register
and spill lines for the K2b kernels are printed) into
`bcnf_tpu_torch/_build/strict_train_parts/`, all at once, and launched
through its C entry point at the flagship's shape (4096 rows, 26 steps of 4
hidden layers at H 526 / Hp 544, size 19, d_a 10; random weights, conditions
and cotangents from seed 0; the step inputs, and for this checkout's kernel
the activations it reads, from the strict K2a). Times: CUDA events around
one call, median of 5 after a warm-up: the whole call, then its parts alone
(the rows kernels, the weight-grad passes on the scratch the rows left, the
ActNorm grads), beside the median SM clock and power nvidia-smi samples
meanwhile, and the rate of the products each design does (the first
recomputes each step's MLP, three MLPs' products; this checkout's reads what
the strict K2a keeps, two). This checkout's strict K2a is timed with its
keep.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("ft_rows_kernel", "ft_atb_kernel")
K2A = "k2a "
# gelu''s place in the keep without its swizzle (`keep_grad_at`): plain column-major
UNSWIZZLE_OLD = "  return R * ((4 * col + rb) ^ (((col >> 2) & 7) << (R == 2 ? 1 : 0)));"
UNSWIZZLE_NEW = "  return R * (4 * col + rb);"
# the strict K2a's variants: [(file, old text, new text)] of csrc/flow_fma.cu
K2A_PATCHES = {
    "as built": [],
    "no_stores": [("flow_fma.cu", "        if (rows > 0) {\n          bulk_store_s2g(",
                   "        if (false) {\n          bulk_store_s2g(")],
    "no_keepers": [("flow_fma.cu", "                __stcs(reinterpret_cast<float4*>(hs +",
                    "                if (false) __stcs(reinterpret_cast<float4*>(hs +")],
    "no_fence": [("flow_fma.cu", """lane_row / R, cq, lc);
    fence_async_smem();""", """lane_row / R, cq, lc);""")],
    "no_writes": [("flow_fma.cu",
                   "    keep_act<R, TN>(at, acc, bias, ring + static_cast<size_t>(slot) * stage, lane_row / R, cq, lc);",
                   "    store_act<R, TN>(at, acc, bias, cq, lc);")],
    "unswizzled": [("flow_fma.cu", UNSWIZZLE_OLD, UNSWIZZLE_NEW)],
}
# variant -> [(file, old text, new text)]: this checkout's kernel
PATCHES = {
    "as built": [],
    "products": [("flow_train_fma.cu", "mbar_arrive_expect_tx(bar, bytes); bulk_copy_g2s(dst, src, bytes, bar);",
                  "mbar_arrive(bar);")],
    "stream": [("flow_train_fma.cu", "if (active) hidden_product<R, TN>(", "if (false) hidden_product<R, TN>(")],
    "unswizzled": [("flow_fma.cu", UNSWIZZLE_OLD, UNSWIZZLE_NEW)],
    "no_acts": [("flow_train_fma.cu", "load_rows<R>(gs + keep_grad_at<R>(col + c, rb), g);",
                 "for (int r = 0; r < R; ++r) g[r] = 0.0f;"),
                ("flow_train_fma.cu", "load_rows<R>(gs + keep_grad_at<R>(col, rb), g);",
                 "for (int r = 0; r < R; ++r) g[r] = 0.0f;"),
                ("flow_train_fma.cu",
                 "push(keep + fma_keep_act(k, l, true, B, nh, Hp) + static_cast<size_t>(grp) * G * Hp, grp < g1 ? G * Hp : 0);",
                 "push(keep, 0);"),
                ("flow_train_fma.cu", "const float s = row0 + rr < B ? sk[(row0 + rr) * d_b + j] : 0.0f;",
                 "const float s = 0.0f;")],
    "atb_no_smem": [("flow_train_fma.cu", "const float4 a = *reinterpret_cast<const float4*>(as + kk * kFtTile + h * kFtTile / 2 + 4 * ty);",
                     "const float4 a = *reinterpret_cast<const float4*>(as + h * kFtTile / 2 + 4 * ty);"),
                    ("flow_train_fma.cu", "ld_frag(bs + kk * kFtTile, tx, bv);", "ld_frag(bs, tx, bv);")],
    "atb_one_level": [("flow_train_fma.cu", "sum[4 * h + i][c] += acc[i][c];\n", "sum[4 * h + i][c] = acc[i][c];\n"),
                      ("flow_train_fma.cu", "acc[i][c] = 0.0f;  // the stage's fresh sums",
                       "acc[i][c] = sum[4 * h + i][c];  // the stage's fresh sums")],
    "atb_16": [("flow_train_fma.cu", "constexpr int kFtK = 32;", "constexpr int kFtK = 16;")],
    "atb_no_loads": [("flow_train_fma.cu", "if (kt + kFtRing - 1 < nk) load_stage(", "if (false) load_stage(")],
    **{f"atb_unroll{u}": [("flow_train_fma.cu", "#pragma unroll 4\n      for (int kk = 0; kk < kFtK; ++kk) {",
                           f"#pragma unroll {u}\n      for (int kk = 0; kk < kFtK; ++kk) {{")] for u in (2, 8, 32)},
    "atb_one_block": [("flow_train_fma.cu", "__launch_bounds__(kFtThreads, 2) ft_atb_kernel",
                       "__launch_bounds__(kFtThreads, 1) ft_atb_kernel"),
                      ("flow_train_fma.cu", "const int smem = static_cast<int>(sizeof(float)) * kFtRing * 2 * kFtK * kFtTile;",
                       "const int smem = static_cast<int>(sizeof(float)) * kFtRing * 2 * kFtK * kFtTile + 120 * 1024;")],
}
# the first design's parts (its csrc/flow_train_fma.cu)
PATCHES_FIRST = {
    "as built": [],
    "products": [("flow_train_fma.cu", "mbar_arrive_expect_tx(bar, bytes); bulk_copy_g2s(dst, src, bytes, bar);",
                  "mbar_arrive(bar);")],
    "stream": [("flow_train_fma.cu", "if (active) hidden_product<R, TN>(", "if (false) hidden_product<R, TN>(")],
    "one_step": [("flow_train_fma.cu", "for (int k = S - 1; k >= 0; --k) {", "for (int k = S - 2; k == S - 2; --k) {")],
    "atb_no_smem": [("flow_train_fma.cu", "const float4 a = *reinterpret_cast<const float4*>(as + kk * kFtTile + 4 * ty);",
                     "const float4 a = make_float4(kk, ty, kk + ty, kk - ty);"),
                    ("flow_train_fma.cu", "const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * kFtTile + 4 * tx);",
                     "const float4 b0 = make_float4(kk, tx, kk + tx, kk - tx);"),
                    ("flow_train_fma.cu",
                     "const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * kFtTile + 32 + 4 * tx);",
                     "const float4 b1 = make_float4(tx, kk, tx - kk, kk * tx);")],
    "atb_one_block": [("flow_train_fma.cu", "const int smem = static_cast<int>(sizeof(float)) * kFtRing * 2 * kFtK * kFtTile;",
                       "const int smem = static_cast<int>(sizeof(float)) * kFtRing * 2 * kFtK * kFtTile + 120 * 1024;")],
}
FIRST = "first "
S, SIZE, D_A, NH, H, B = 26, 19, 10, 4, 526, 4096
PARTS = {"whole": 7, "rows": 1, "weight grads": 2, "rest": 4}


def build(root: str, kind: str, patches: dict, names: list[str], source: str = "flow_train_fma.cu",
          ) -> dict[str, tuple[str, str]]:
    """One nvcc per variant of `source`, all started together, each from its
    own copy of the patched sources; returns each variant's library and
    ptxas output."""
    sys.path.insert(0, HERE)
    from bcnf_tpu_torch.ops import _build

    csrc = os.path.join(root, "bcnf_tpu_torch", "ops", "csrc")
    procs = {}
    for name in names:
        out_dir = os.path.join(HERE, "bcnf_tpu_torch", "_build", "strict_train_parts", kind, name.replace(" ", "_"))
        os.makedirs(out_dir, exist_ok=True)
        files = {f: open(os.path.join(csrc, f)).read() for f in os.listdir(csrc)
                 if f in ("flow_train_fma.cu", "flow_fma.cu") or f.endswith(".cuh")}
        for f, old, new in patches[name]:
            if old not in files[f]:
                raise SystemExit(f"variant {kind} {name}: the patch of {f} does not apply (the source changed)")
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
            raise SystemExit(f"nvcc failed on variant {kind} {name}:\n{out}")
        libs[name] = (lib, out)
    return libs


def ptxas_lines(log: str) -> list[str]:
    """ptxas's register, shared-memory and spill lines of the K2b kernels."""
    lines, current = [], ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            current = ln.split("'")[1] if "'" in ln else ""
        elif any(k in current for k in KERNELS) and ("registers" in ln or ("spill" in ln and " 0 bytes spill" not in ln)):
            name = next(k for k in KERNELS if k in current)
            args = re.findall(r"Li(\d+)E", current)
            if name == "ft_rows_kernel" and args and args[0] != "17":
                continue  # the flagship's width only
            lines.append(f"{name}{'<' + ','.join(args) + '>' if args else ''}: {ln.split(':', 1)[-1].strip()}")
    return lines


def k2a_ptxas(log: str) -> str:
    """ptxas's register and spill lines of `fma_flow_train_kernel<17>`."""
    lines, current = [], ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            current = ln
        elif "fma_flow_train_kernelILi17E" in current and ("registers" in ln or "spill" in ln):
            lines.append(ln.split(":", 1)[-1].strip())
    return "; ".join(lines)


def main() -> None:
    argv = sys.argv[1:]
    other = k2a_other = None
    if argv[:1] == ["--first"]:
        if len(argv) < 2:
            raise SystemExit(__doc__)
        other, argv = os.path.abspath(argv[1]), argv[2:]
    if argv[:1] == ["--k2a-against"]:
        if len(argv) < 2:
            raise SystemExit(__doc__)
        k2a_other, argv = os.path.abspath(argv[1]), argv[2:]
    known = (list(PATCHES) + ([FIRST + n for n in PATCHES_FIRST] if other else [])
             + [K2A + n for n in K2A_PATCHES] + [K2A + "body"])
    names = argv or known
    for name in names:
        if name not in known:
            raise SystemExit(f"unknown variant {name!r}; variants: {', '.join(known)}")
    k2a_names = [n[len(K2A):] for n in names if n.startswith(K2A)]
    names = [n for n in names if not n.startswith(K2A)]
    ours = [n for n in names if not n.startswith(FIRST)]
    theirs = [n[len(FIRST):] for n in names if n.startswith(FIRST)]
    if ours and "as built" not in ours:
        ours.insert(0, "as built")
    if theirs and "as built" not in theirs:
        theirs.insert(0, "as built")
    libs = {}
    if ours:
        libs.update({("this", n): v for n, v in build(HERE, "this", PATCHES, ours).items()})
    if theirs:
        libs.update({("first", n): v for n, v in build(other, "first", PATCHES_FIRST, theirs).items()})
    if k2a_names or k2a_other:
        k2a_built = [n for n in K2A_PATCHES if n in k2a_names or n == "as built"]
        k2a_libs = {n: v for n, v in build(HERE, "k2a", K2A_PATCHES, k2a_built, "flow_fma.cu").items()}
        if k2a_other:
            k2a_libs["other"] = build(k2a_other, "k2a_other", {"as built": []}, ["as built"], "flow_fma.cu")["as built"]
            k2b_other = build(k2a_other, "k2b_other", {"as built": []}, ["as built"])["as built"][0]
        if "body" in k2a_names:
            k2a_libs["body"] = k2a_libs["as built"]

    import torch

    sys.path.insert(0, HERE)
    from bcnf_tpu_torch.ops import flow_kernel as fk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    for kind, src in (("this", HERE), ("first", other)):
        if (kind, "as built") in libs:
            print(f"strict K2b ({kind}) from {os.path.relpath(os.path.join(src, 'bcnf_tpu_torch', 'ops', 'csrc'), HERE)}"
                  f"/flow_train_fma.cu")
            for ln in ptxas_lines(libs[(kind, "as built")][1]):
                print(f"    ptxas {ln}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    w = {"an_scale": 1 + 0.1 * randn(S, SIZE), "an_bias": 0.1 * randn(S, SIZE),
         "ortho": torch.linalg.qr(randn(S, SIZE, SIZE))[0].contiguous(),
         "w1y": randn(S, D_A, H, scale=D_A ** -0.5), "b1": randn(S, H, scale=0.1),
         "wm": randn(S, NH, H, H, scale=H ** -0.5), "bm": randn(S, NH, H, scale=0.1),
         "wout": randn(S, H, 2 * (SIZE - D_A), scale=0.1 * H ** -0.5), "bout": randn(S, 2 * (SIZE - D_A), scale=0.1)}
    kargs, h_proj = fk.pad_hidden(w, randn(S, B, H, scale=0.5))
    Hp = h_proj.shape[-1]
    args = [kargs[n] for n in ("an_scale", "an_bias", "ortho", "w1y", "b1", "wm", "bm", "wout", "bout")]
    x, dz, dld = randn(B, SIZE), randn(B, SIZE), randn(B)
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

    def clocked(fn) -> tuple[float, float, float]:
        smi_log = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
                                    "-lms", "50"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        ms = timed(fn)
        smi_log.terminate()
        samples = [ln.split(",") for ln in smi_log.communicate()[0].splitlines() if ln.count(",") == 1]
        mhz = sorted(float(c) for c, _ in samples)[len(samples) // 2] if samples else float("nan")
        watts = sorted(float(v) for _, v in samples)[len(samples) // 2] if samples else float("nan")
        return ms, mhz, watts

    current = ""
    with torch.no_grad():  # this checkout's strict K2a: the step inputs, and the activations its K2b reads
        keep = fk.train_keep(x, h_proj, kargs["wm"], D_A, fk.MODE_FMA)
        _, _, bound = fk.fused_flow_train_fwd(x, h_proj, *args, mode=fk.MODE_FMA, keep=keep)
        if ours:
            k2a = timed(lambda: fk.fused_flow_train_fwd(x, h_proj, *args, mode=fk.MODE_FMA, keep=keep))
            print(f"strict K2a {B} rows: {k2a:.3f} ms with its keep ({keep.numel() * 4 / 1e9:.3f} GB)")
            from bcnf_tpu_torch.ops import _build

            for ln in _build.build_logs.get("flow_fma", "").splitlines():  # K2a at the flagship's width
                if "Compiling entry function" in ln:
                    current = ln
                elif "fma_flow_train_kernelILi17E" in current and ("registers" in ln or "spill" in ln):
                    print(f"    ptxas fma_flow_train_kernel<17>: {ln.split(':', 1)[-1].strip()}")
    mlp = B * S * 2 * (D_A * H + NH * H * H + H * 2 * (SIZE - D_A))  # one MLP's products over every step
    flops = {"first": 3 * mlp, "this": 2 * mlp}  # the first design recomputes the MLP; this one reads the keep
    with torch.no_grad():  # the plain version in float64 and in float32 on the same inputs
        g64 = fk.fused_flow_train_backward_reference(bound.double(), h_proj.double(), dz.double(), dld.double(),
                                                     *[t.double() for t in args])
        g32 = fk.fused_flow_train_backward_reference(bound, h_proj, dz, dld, *args)
    names = ("dx", "dh_proj", "dan_scale", "dan_bias", "dw1y", "db1", "dwm", "dbm", "dwout", "dbout")

    def from64(got) -> tuple[float, str, dict]:
        rel = {n: ((g.double() - r).abs().max() / r.abs().max().clamp_min(1e-30)).item()
               for n, g, r in zip(names, got, g64)}
        worst = max(rel, key=rel.get)
        return rel[worst], worst, rel

    plain64 = from64(g32)
    print(f"the float32 plain version from float64: {plain64[0]:.3e} (worst {plain64[1]}; by grad: "
          + ", ".join(f"{n} {v:.2e}" for n, v in plain64[2].items()) + ")")
    built = {}
    for (kind, name), (path, _) in libs.items():
        lib = ctypes.CDLL(path)
        n_ptr, n_int = (24, 7) if kind == "first" else (25, 9)  # this checkout's takes a row range
        lib.bcnf_flow_train_bwd_fma.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        lib.bcnf_flow_train_bwd_fma.restype = ctypes.c_int
        lib.bcnf_flow_train_fma_scratch.restype = ctypes.c_longlong
        scratch = torch.empty((lib.bcnf_flow_train_fma_scratch(B, S, SIZE, D_A, NH, Hp),), device=dev)
        grads = [torch.zeros_like(t) for t in (dz, h_proj, *args[:2], *args[3:])]
        ins = [bound, h_proj, dz, dld, *args] + ([] if kind == "first" else [keep])
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (*ins, *grads, scratch)]

        def launch(parts: int) -> None:
            rows = (B,) if kind == "first" else (B, 0, B)
            err = lib.bcnf_flow_train_bwd_fma(*ptrs, *rows, S, SIZE, D_A, NH, Hp, parts, stream)
            if err:
                raise SystemExit(f"variant {kind} {name}: launch failed with cudaError {err}")

        launch(7)
        torch.cuda.synchronize()
        got = [g.clone() for g in grads]
        ref = built.setdefault(kind, got)
        err = max((a - b).abs().max().item() for a, b in zip(got, ref))
        if name == "as built" and len(built) == 2:  # the second kind's as built, against the first's
            other = built["first" if kind == "this" else "this"]
            same = all(torch.equal(a, b) for a, b in zip(got, other))
            print(f"this checkout's grads against the first design's: equal to the bit: {same}; max|d| "
                  f"{max((a - b).abs().max().item() for a, b in zip(got, other)):.3e}")
        cells = []
        for part, mask in PARTS.items():
            ms, mhz, watts = clocked(lambda: launch(mask))
            rate = (f" ({flops[kind] / ms / 1e9:.1f} TFLOP/s of its {flops[kind] / 1e9:.0f} GFLOP)"
                    if part == "whole" else "")
            cells.append(f"{part} {ms:.3f} ms{rate} [SM {mhz:.0f} MHz, {watts:.0f} W]")
        regs = "; ".join(ln.split(": ", 1)[1] for ln in ptxas_lines(libs[(kind, name)][1])
                         if ln.startswith("ft_atb") or "spill" in ln)
        d64 = from64(got)
        by_grad = ("; by grad: " + ", ".join(f"{n} {v:.2e}" for n, v in d64[2].items())) if d64[0] < 1e-3 else ""
        print(f"{kind} {name}: " + "; ".join(cells) + f"; max|grad - grad as built| {err:.3e}; from float64 "
              f"{d64[0]:.3e} (worst {d64[1]}; {d64[0] / (2 * plain64[0]):.3f} of the bar{by_grad}) [ptxas: {regs}]",
              flush=True)
    if k2a_names or k2a_other:
        k2a_variants(k2a_libs, x, h_proj, args, keep, timed, clocked, stream)
    if k2a_other:
        for what, inputs in (("random", (x, h_proj, args)), ("the flagship's", flagship_inputs(dev))):
            pair_against(k2a_libs["other"][0], k2b_other, *inputs, dz, dld, stream, what, timed)


def k2a_variants(libs: dict, x, h_proj, args: list, keep, timed, clocked, stream) -> None:
    """Time each strict K2a variant at 4096 rows through its C entry point
    (the other checkout's in turns with this one's as built)."""
    import torch

    Hp = h_proj.shape[-1]
    outs = (torch.empty_like(x), torch.empty((B,), device=x.device), torch.empty((S, B, SIZE), device=x.device))
    base = [ctypes.c_void_p(t.data_ptr()) for t in (x, h_proj, *args, *outs)]
    refs = {}  # as built's keep on each set of inputs
    order = [n for n in libs if n not in ("as built", "other")]
    order = ["as built", *(["other", "other"] if "other" in libs else []), *order, "as built"]
    if "other" in libs:
        order += ["flagship as built", "flagship other", "flagship other", "flagship as built"]
        flagship = flagship_inputs(x.device)
    for label in order:
        name = label.removeprefix("flagship ")
        if label.startswith("flagship "):
            x, h_proj, args = flagship
            base = [ctypes.c_void_p(t.data_ptr()) for t in (x, h_proj, *args, *outs)]
        path, log = libs[name]
        lib = ctypes.CDLL(path)
        this = name != "other"
        lib.bcnf_fused_flow_train.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * (7 if this else 6)
                                              + [ctypes.c_void_p])
        lib.bcnf_fused_flow_train.restype = ctypes.c_int
        kept = torch.zeros_like(keep)
        ptr = ctypes.c_void_p(None if name == "body" else kept.data_ptr())
        shape = (B, B, S, SIZE, D_A, NH, Hp) if this else (B, S, SIZE, D_A, NH, Hp)

        def launch() -> None:
            err = lib.bcnf_fused_flow_train(*base, ptr, *shape, stream)
            if err:
                raise SystemExit(f"k2a variant {name}: launch failed with cudaError {err}")

        ms, mhz, watts = clocked(launch)
        torch.cuda.synchronize()
        inputs = label.startswith("flagship ")
        if name == "as built" and inputs not in refs:
            refs[inputs] = kept.clone()
        d = ("no keep" if name == "body"
             else f"keep max|d| from as built {(kept - refs[inputs]).abs().max().item():.3e}")
        print(f"k2a {label}: {ms:.3f} ms [SM {mhz:.0f} MHz, {watts:.0f} W]; {d} [ptxas <17>: {k2a_ptxas(log)}]",
              flush=True)


def pair_against(other_k2a: str, other_k2b: str, x, h_proj, args: list, dz, dld, stream, what: str,
                 timed) -> None:
    """The strict pair's grads, this checkout's (K2a keeping, then K2b on
    that keep, through `ops/flow_kernel.py`) against another checkout's
    (its libraries' C entry points, each on its own keep layout), on the
    same inputs: equal to the bit or not, grad by grad. Then both pairs
    timed at their C entry points in turns (this, other, other, this): K2a
    keeping, K2b alone on its own K2a's keep, and the two one after the
    other, each the median of 5 CUDA-event-timed calls."""
    import torch

    from bcnf_tpu_torch.ops import flow_kernel as fk
    from bcnf_tpu_torch.ops._build import load_library

    Hp = h_proj.shape[-1]
    ptr = lambda *ts: [ctypes.c_void_p(t.data_ptr()) for t in ts]  # noqa: E731
    with torch.no_grad():
        keep = fk.train_keep(x, h_proj, args[5], D_A, fk.MODE_FMA)
        _, _, bound = fk.fused_flow_train_fwd(x, h_proj, *args, mode=fk.MODE_FMA, keep=keep)
        ours = fk.fused_flow_train_bwd(bound, h_proj, dz, dld, *args, mode=fk.MODE_FMA, keep=keep)
        a_lib, b_lib = ctypes.CDLL(other_k2a), ctypes.CDLL(other_k2b)
        a_lib.bcnf_flow_fma_keep.restype = b_lib.bcnf_flow_train_fma_scratch.restype = ctypes.c_longlong
        a_lib.bcnf_fused_flow_train.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        b_lib.bcnf_flow_train_bwd_fma.argtypes = [ctypes.c_void_p] * 25 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        their_keep = torch.empty((a_lib.bcnf_flow_fma_keep(B, S, SIZE, D_A, NH, Hp),), device=x.device)
        outs = (torch.empty_like(x), torch.empty((B,), device=x.device), torch.empty((S, B, SIZE), device=x.device))
        err = a_lib.bcnf_fused_flow_train(*ptr(x, h_proj, *args, *outs, their_keep), B, S, SIZE, D_A, NH, Hp, stream)
        theirs = [torch.empty_like(t) for t in ours]
        scratch = torch.empty((b_lib.bcnf_flow_train_fma_scratch(B, S, SIZE, D_A, NH, Hp),), device=x.device)
        err = err or b_lib.bcnf_flow_train_bwd_fma(*ptr(outs[2], h_proj, dz, dld, *args, their_keep, *theirs, scratch),
                                                   B, S, SIZE, D_A, NH, Hp, 7, stream)
        torch.cuda.synchronize()
    if err:
        raise SystemExit(f"the other checkout's strict pair failed to launch: cudaError {err}")
    names = ("dx", "dh_proj", "dan_scale", "dan_bias", "dw1y", "db1", "dwm", "dbm", "dwout", "dbout")
    same = [n for n, a, b in zip(names, ours, theirs) if torch.equal(a, b)]
    print(f"the strict pair on {what} inputs (K2a keeping, K2b on its keep) against the other checkout's: "
          f"{len(same)} of 10 grads equal to the bit; max|d| "
          + ", ".join(f"{n} {(a - b).abs().max().item():.3e}" for n, a, b in zip(names, ours, theirs)), flush=True)

    k2a, k2b = load_library(fk.ROUTE_LIBRARY[fk.ROUTE_FMA]), load_library(fk.TRAIN_BWD_LIBRARY[fk.ROUTE_FMA])
    our_outs = [torch.empty_like(t) for t in outs]
    our_scratch = torch.empty((k2b.bcnf_flow_train_fma_scratch(B, S, SIZE, D_A, NH, Hp),), device=x.device)
    grads = [torch.empty_like(t) for t in ours]
    calls = {  # each checkout's K2a keeping and its K2b on that keep, at their C entry points
        "this": (lambda: k2a.bcnf_fused_flow_train(*ptr(x, h_proj, *args, *our_outs, keep), B, B, S, SIZE, D_A, NH,
                                                   Hp, stream),
                 lambda: k2b.bcnf_flow_train_bwd_fma(*ptr(bound, h_proj, dz, dld, *args, keep, *grads, our_scratch),
                                                     B, 0, B, S, SIZE, D_A, NH, Hp, 7, stream)),
        "other": (lambda: a_lib.bcnf_fused_flow_train(*ptr(x, h_proj, *args, *outs, their_keep), B, S, SIZE, D_A, NH,
                                                      Hp, stream),
                  lambda: b_lib.bcnf_flow_train_bwd_fma(*ptr(outs[2], h_proj, dz, dld, *args, their_keep, *theirs,
                                                             scratch), B, S, SIZE, D_A, NH, Hp, 7, stream)),
    }

    def checked(fn):
        def call() -> None:
            if fn():
                raise SystemExit(f"the strict pair's timing on {what} inputs: a launch failed")
        return call

    for kind in ("this", "other", "other", "this"):
        fwd, bwd = (checked(f) for f in calls[kind])
        cells = [timed(fwd), timed(bwd), timed(lambda: (fwd(), bwd()))]
        print(f"the strict pair on {what} inputs, {kind}: K2a keeping {cells[0]:.3f} ms, K2b on its keep "
              f"{cells[1]:.3f} ms, the two {cells[2]:.3f} ms", flush=True)


def flagship_inputs(dev) -> tuple:
    """The strict K2a's inputs as chip_smoke.py's phase 6b makes them: the
    flagship at dropout 0, weights from seed 0, B random rows and random
    trajectories through the encoder's time loop (no LSTM kernel to build)."""
    import torch

    os.environ["BCNF_FUSED_LSTM"] = "0"
    from bcnf_tpu_torch.config import load_config
    from bcnf_tpu_torch.models import CondRealNVP

    cfg = load_config(os.path.join(HERE, "configs", "runs", "trajectory_LSTM_large.yaml")).to_dict()
    cfg["model"]["kwargs"]["dropout"] = 0.0
    model = CondRealNVP.from_config(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    traj = torch.randn((B, 30, 3), generator=gen, device=dev)
    with torch.no_grad():
        kargs, h_proj = model._fused_flow_args(params, model.encode(params, (traj,)))
    names = ("an_scale", "an_bias", "ortho", "w1y", "b1", "wm", "bm", "wout", "bout")
    return torch.randn((B, model.size), generator=gen, device=dev), h_proj, [kargs[n].contiguous() for n in names]


if __name__ == "__main__":
    main()
