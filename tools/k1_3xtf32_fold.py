#!/usr/bin/env python3
"""K1's 3xTF32 `wgmma` inverse (`csrc/flow_wgmma.cu`, library `flow_wgmma`)
as built, which folds each k-stage's three passes into a float32 running
sum, against variants and against another checkout's build, on one card, in
one process: each build's distance from the plain version in float64, its
registers and spills, its time and its parts.

The tensor cores' accumulator truncates at each `wgmma`; over the 204
accumulating products of a 544-long dot product (68 k-stages of three
passes) that bias is what the fold removes. Variants (scratch nvcc builds of
patched copies of the sources, all started together):

- `as built`: the kernel as it is (a 2-block cluster splitting each hidden
  layer's columns; each k-step's three passes into a fresh accumulator,
  waited for, then folded into the running sums; ring stages of 2 k-steps);
- `stage1`: ring stages of one k-step, a ring of 4;
- `pingpong`: the two consumer warpgroups issue their groups in turn;
- `halves` (stages of one k-step): the fresh accumulator split by columns
  into two halves, each its own `wgmma` group, one folded while the other
  runs;
- `unfolded` (stages of one k-step): every pass straight into the running
  sums, as the tensor cores accumulate, waited for each k-step;
- with `--against OTHER_CHECKOUT`, `other`: that checkout's `flow_wgmma` as
  it is, fed its own weight layout (its `prepare_weights`).

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/k1_3xtf32_fold.py [--trained] [--against OTHER_CHECKOUT] [VARIANT ...]

The flagship `trajectory_LSTM_large` with random weights from seed 0 (its
ActNorm moved off identity): (a) a rank batch, 100 conditions x 1000 draws
(the shape of phase 12's check in chip_smoke.py), (b) the sampling shape,
10,000 draws x 8 conditions, and (c) K4's shape, the first coupling at one
step over the same 80,000 rows. With `--trained`, first phase 12's rank
batch on phase 12's weights: the `train` CLI on the published config for 1
epoch, its 5000 trajectories generated on the card, then 1000 draws for each
of the first 100 training conditions (z from the seed, as phase 12 draws
it). For each build: max |y - y64| against the plain version evaluated in
float64 on the same rows (the float32 plain version's own distance printed
beside), equal to the bit between two calls; at (a), (b) and (c) CUDA-event
times in turns (the builds in order, then in reverse, 3 launches each); at
(b) each build's parts alone: its products (on stale stages), the weights'
stream, both without the exchange between a cluster's blocks, and neither.
Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import functools
import importlib.util
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "{{BCNF_ROOT}}/configs/runs/trajectory_LSTM_large.yaml"
LIB = "flow_wgmma"
SOURCE = "flow_wgmma.cu"

# variants of the layer's product (csrc/flow_wgmma.cu: fold_product), with
# its arguments, inserted before it and called in its place
CALL = "fold_product<TN>(acc, act, ring, full, empty, st, ph, wg, w4, g, q, lane);"
ANCHOR = "// acc = the warpgroup's m64 x n(8 TN) share of (tile x the layer's hidden"
# the fresh accumulator split by columns into two halves, each its own
# `wgmma` group, taking turns: one group in flight while the other folds
HALVES = r"""// a completed fresh sum of P floats folded into the running sums from float O on
template <int O, int R, int P>
__device__ __forceinline__ void fold_at(float (&acc)[R], float (&p)[P]) {
  fence_operands(p);
#pragma unroll
  for (int e = 0; e < P; ++e) acc[O + e] += p[e];
}

// One k-step s of halves_product, its two groups (on the other fragment set)
// in flight: load k-step s + 1's fragments into (nhi, nlo) (kMore); as each
// half's group completes, fold it and issue that half of k-step s + 1; then
// release k-step s's slot.
template <int TN, bool kMore>
__device__ __forceinline__ void halves_kstep(float (&acc)[4 * TN], float (&pa)[4 * ((TN + 1) / 2)],
                                           float (&pb)[4 * (TN > 1 ? TN / 2 : 1)], uint32_t (&nhi)[4],
                                           uint32_t (&nlo)[4], int s, const float* act, const float* b,
                                           uint64_t* full, uint64_t* empty, int& st, uint32_t& ph, int w4, int g,
                                           int q, int lane) {
  using W = WgShape<TN>;
  constexpr int GA = (TN + 1) / 2, GB = TN / 2;
  int st1 = st;
  uint32_t ph1 = ph;
  next_slot(st1, ph1);
  if constexpr (kMore) {
    load_a_split<W::ldA>(act, w4, g, q, s + 1, nhi, nlo);
    mbar_wait(&full[st1], ph1);
  }
  if constexpr (GB > 0) {
    wgmma_wait<1>();  // half A of k-step s
    fold_at<0>(acc, pa);
    if constexpr (kMore) {
      three_passes<GA>(pa, nhi, nlo, b + st1 * W::stage, W::Hp);
      wgmma_wait<1>();  // half B of k-step s
    } else {
      wgmma_wait<0>();
    }
    fold_at<4 * GA>(acc, pb);
    if (lane == 0) mbar_arrive(&empty[st]);
    if constexpr (kMore) three_passes<GB>(pb, nhi, nlo, b + st1 * W::stage + GA * 64, W::Hp);
  } else {  // TN 1: a product too narrow to split
    wgmma_wait<0>();
    fold_at<0>(acc, pa);
    if (lane == 0) mbar_arrive(&empty[st]);
    if constexpr (kMore) three_passes<GA>(pa, nhi, nlo, b + st1 * W::stage, W::Hp);
  }
  st = st1;
  ph = ph1;
}

// halves_product: the warpgroup's m64 x n(8 TN) share of (tile x the layer's hidden
// weight) in 3xTF32, each k-step's passes into fresh accumulators folded into
// the running sums. The product is split by columns into halves (GA = (TN +
// 1) / 2 n-groups, then GB = TN / 2), each with its own fresh accumulator and
// `wgmma` group, so that one half's group runs while the other half is
// folded and its next k-step issued: one group in flight, with the two fresh
// accumulators taking the 4 TN registers one whole one would (a second whole
// one does not fit: PERF.md). A slot is released once both halves of its
// k-step are done; the A fragments alternate between two register sets.
template <int TN>
__device__ __forceinline__ void halves_product(float (&acc)[4 * TN], const float* act, const float* ring, uint64_t* full,
                                             uint64_t* empty, int& st, uint32_t& ph, int wg, int w4, int g, int q,
                                             int lane) {
  using W = WgShape<TN>;
  constexpr int GA = (TN + 1) / 2, GB = TN / 2;
  float pa[4 * GA];
  [[maybe_unused]] float pb[4 * (TN > 1 ? GB : 1)];
  uint32_t ahi[2][4], alo[2][4];
  const float* b = ring + wg * TN * 64;  // the warpgroup's n-groups wg TN .. of the block's half-stages
#pragma unroll
  for (int e = 0; e < 4 * TN; ++e) acc[e] = 0.0f;
  load_a_split<W::ldA>(act, w4, g, q, 0, ahi[0], alo[0]);
  mbar_wait(&full[st], ph);
  three_passes<GA>(pa, ahi[0], alo[0], b + st * W::stage, W::Hp);
  if constexpr (GB > 0) three_passes<GB>(pb, ahi[0], alo[0], b + st * W::stage + GA * 64, W::Hp);
#pragma unroll 1
  for (int s = 0; s < W::n_stages - 2; s += 2) {  // W::n_stages = 4 TN is even: the fragment sets alternate
    halves_kstep<TN, true>(acc, pa, pb, ahi[1], alo[1], s, act, b, full, empty, st, ph, w4, g, q, lane);
    halves_kstep<TN, true>(acc, pa, pb, ahi[0], alo[0], s + 1, act, b, full, empty, st, ph, w4, g, q, lane);
  }
  halves_kstep<TN, true>(acc, pa, pb, ahi[1], alo[1], W::n_stages - 2, act, b, full, empty, st, ph, w4, g, q, lane);
  halves_kstep<TN, false>(acc, pa, pb, ahi[0], alo[0], W::n_stages - 1, act, b, full, empty, st, ph, w4, g, q, lane);
}

"""
# every pass straight into the running sums, as the tensor cores accumulate,
# waited for each k-step (the parent's pipeline, on the cluster's halves)
UNFOLDED = """template <int TN>
__device__ __forceinline__ void unfolded_product(float (&acc)[4 * TN], const float* act, const float* ring,
                                                 uint64_t* full, uint64_t* empty, int& st, uint32_t& ph, int wg,
                                                 int w4, int g, int q, int lane) {
  using W = WgShape<TN>;
#pragma unroll
  for (int e = 0; e < 4 * TN; ++e) acc[e] = 0.0f;
#pragma unroll 1
  for (int s = 0; s < W::n_stages; ++s) {
    uint32_t ahi[4], alo[4];
    load_a_split<W::ldA>(act, w4, g, q, s, ahi, alo);
    mbar_wait(&full[st], ph);
    const float* hi = ring + st * W::stage + wg * TN * 64;
    const uint64_t bh = smem_desc(hi, 128, 256), bl = smem_desc(hi + 4 * W::Hp, 128, 256);
    wgmma_fence();
    WgmmaTf32<W::NP>::mma(acc, alo, bh);
    WgmmaTf32<W::NP>::mma(acc, ahi, bl);
    WgmmaTf32<W::NP>::mma(acc, ahi, bh);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    if (lane == 0) mbar_arrive(&empty[st]);
    next_slot(st, ph);
  }
}

"""


def wgmma_spec(n: int) -> str:
    """`bcnf::WgmmaTf32<n>` (m64n{n}k8, tf32, A from registers), written as
    csrc/wgmma_tf32.cuh writes the widths it has."""
    r = n // 2
    regs = ", ".join(f"%{i}" for i in range(r))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(r))
    return (f"template <>\nstruct WgmmaTf32<{n}> {{\n"
            f"  static __device__ __forceinline__ void mma(float (&d)[{r}], const uint32_t (&a)[4], uint64_t desc,\n"
            f"                                             uint32_t scale_d = 1) {{\n"
            f'    asm volatile(\n        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"\n'
            f'        "wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 "\n'
            f'        "{{{regs}}}, "\n'
            f'        "{{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, p, 1, 1;\\n}}\\n"\n'
            f"        : {outs}\n"
            f'        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));\n  }}\n}};\n')


# stages of one k-step (17,408 bytes a block at Hp 544), a ring of 4
STAGE1 = [("constexpr int kWgStageK = 2;", "constexpr int kWgStageK = 1;"),
          ("constexpr int kWgRing3xTf32 = 2;", "constexpr int kWgRing3xTf32 = 4;")]

# the two consumer warpgroups issue their k-steps' groups in turn (named
# barriers 2 and 3, as FlashAttention 3 schedules its warpgroups), so one
# folds while the other's products run
PINGPONG = [
    ("#pragma unroll 1\n  for (int s = 0; s < W::n_stages; s += kWgStageK) {",
     '  if (wg == 1) asm volatile("bar.arrive 2, 256;\\n" ::: "memory");  // warpgroup 0 issues first\n'
     "#pragma unroll 1\n  for (int s = 0; s < W::n_stages; s += kWgStageK) {"),
    ("      three_passes<TN>(part, ahi, alo, ring + (st * kWgStageK + u) * W::stage + wg * TN * 64, W::Hp);\n",
     '      asm volatile("bar.sync %0, 256;\\n" ::"r"(2 + wg) : "memory");  // this warpgroup\'s turn\n'
     "      three_passes<TN>(part, ahi, alo, ring + (st * kWgStageK + u) * W::stage + wg * TN * 64, W::Hp);\n"
     "      if (wg == 0 || s + u + 1 < W::n_stages)\n"
     '        asm volatile("bar.arrive %0, 256;\\n" ::"r"(3 - wg) : "memory");  // the other\'s turn\n'),
]

# variant -> [(old text, new text)] in flow_wgmma.cu
PATCHES = {
    "as built": [],
    "stage1": STAGE1,
    "pingpong": PINGPONG,
    "halves": STAGE1 + [(ANCHOR, HALVES + ANCHOR), (CALL, CALL.replace("fold_product", "halves_product"))],
    "unfolded": STAGE1 + [(ANCHOR, UNFOLDED + ANCHOR), (CALL, CALL.replace("fold_product", "unfolded_product"))],
}
# the k-steps a stage of each variant holds (its weight layout: `prepare_weights(stage_k=)`)
STAGE_KS = {"stage1": 1, "halves": 1, "unfolded": 1}
# the parts a launch runs (csrc/flow_wgmma.cu: kWgProducts, kWgCopies, kWgExchange)
PARTS = {"products": 1, "stream": 2, "no exchange": 3, "neither": 0}


def build(names: list[str], other: str | None) -> dict[str, str]:
    """One nvcc per build, all started together, each from its own copy of
    the sources (this checkout's, patched for a variant, or `other`'s as it
    is); returns each build's library, printing ptxas's register and spill
    lines."""
    from bcnf_tpu_torch.ops import _build

    procs = {}
    for name in names:
        root = other if name == "other" else HERE
        out = os.path.join(HERE, "bcnf_tpu_torch", "_build", "k1_3xtf32_fold", name.replace(" ", "_"))
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(os.path.join(root, "bcnf_tpu_torch", "ops", "csrc"), os.path.join(out, "csrc"))
        path = os.path.join(out, "csrc", SOURCE)
        with open(path) as f:
            text = f.read()
        for old, new in PATCHES.get(name, []):
            if text.count(old) != 1:
                raise SystemExit(f"variant {name!r}: its patch does not apply to {SOURCE}")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(out, f"lib{LIB}.so")
        procs[name] = (lib, subprocess.Popen([_build._nvcc(), *_build._flags(LIB), "-o", lib, path],
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or ("spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line):
                print(f"  ptxas {name}: {line.strip().removeprefix('ptxas info    : ')}")
        libs[name] = lib
    return libs


def other_layout(other: str):
    """`prepare_weights` of the other checkout (its weight layout), loaded
    from its source (it imports torch and this checkout's `ops.nn` only)."""
    spec = importlib.util.spec_from_file_location(
        "other_flow_kernel", os.path.join(other, "bcnf_tpu_torch", "ops", "flow_kernel.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.prepare_weights


def load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bcnf_flow_inverse_wgmma.argtypes = [ptr] * 12 + [i32] * 8 + [ptr]
    lib.bcnf_flow_inverse_wgmma.restype = i32
    lib.bcnf_cuda_error_string.argtypes = [i32]
    lib.bcnf_cuda_error_string.restype = ctypes.c_char_p
    return lib


def trained(model, dev) -> tuple:
    """Phase 12's weights: the `train` CLI on the published flagship config
    for 1 epoch, its dataset generated on the card from the seed; returns
    the trained params and the first 100 training conditions."""
    import pickle
    import tempfile

    import torch
    import yaml

    import bcnf_tpu_torch.__main__ as cli
    from bcnf_tpu_torch.bridge import params_from_numpy
    from bcnf_tpu_torch.config import load_config, sub_root_path
    from bcnf_tpu_torch.train.data import TrainerDataHandler

    build_dir = os.path.join(HERE, "bcnf_tpu_torch", "_build")
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        with open(sub_root_path(CONFIG)) as f:
            cfg = yaml.safe_load(f)
        cfg["data"]["path"] = os.path.join(tmp, "train_data")
        cfg["training"]["n_epochs"] = 1
        cfg_path, model_dir = os.path.join(tmp, "run.yaml"), os.path.join(tmp, "model")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f)
        cli.main(["train", "-c", cfg_path, "-o", model_dir])
        with open(os.path.join(model_dir, "params.pkl"), "rb") as f:
            trained_np = pickle.load(f)
        run_cfg = load_config(cfg_path)
        _, conds = TrainerDataHandler().get_data_for_training({k.lower(): v for k, v in run_cfg.items()},
                                                              model.parameter_index_mapping)
    return params_from_numpy(trained_np, dev), torch.from_numpy(conds[0][:100]).to(dev)


def main() -> None:
    args = sys.argv[1:]
    with_trained = "--trained" in args
    args = [a for a in args if a != "--trained"]
    other = None
    if "--against" in args:
        i = args.index("--against")
        if i + 1 >= len(args):
            raise SystemExit(__doc__)
        other = os.path.abspath(args[i + 1])
        args = args[:i] + args[i + 2:]
    names = args or list(PATCHES)
    if any(n not in PATCHES for n in names):
        raise SystemExit(__doc__)
    names = ["as built"] + [n for n in names if n != "as built"] + (["other"] if other else [])
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    from bcnf_tpu_torch import CondRealNVP
    from bcnf_tpu_torch.config import load_config
    from bcnf_tpu_torch.ops import _build
    from bcnf_tpu_torch.ops.coupling_kernel import coupling_flow_args, mlp_params_to_kernel_args
    from bcnf_tpu_torch.bridge import map_tree
    from bcnf_tpu_torch.ops.flow_kernel import MODE_3XTF32, _launch_flow, fused_flow_reference, prepare_weights

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    libs = {name: load(path) for name, path in build(names, other).items()}
    layouts = {name: other_layout(other) if name == "other" else
               functools.partial(prepare_weights, stage_k=STAGE_KS.get(name)) for name in names}
    dev = torch.device("cuda")
    model = CondRealNVP.from_config(load_config(CONFIG))
    params = model.init(torch.Generator().manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    an = params["blocks"]["actnorm"]
    params = dict(params, blocks=dict(params["blocks"], actnorm={
        "scale": an["scale"] + 0.1 * torch.from_numpy(rng.normal(size=an["scale"].shape).astype(np.float32)).to(dev),
        "bias": 0.1 * torch.from_numpy(rng.normal(size=an["bias"].shape).astype(np.float32)).to(dev)}))

    def run(name: str, x, args, n_cond, parts: int = 7):
        saved = _build._loaded.get(LIB)
        _build._loaded[LIB] = libs[name]
        try:
            return _launch_flow(x, args[0], inverse=True, n_cond=n_cond, mode=MODE_3XTF32, wstages=args[1][name],
                                parts=parts)[1]
        finally:
            if saved is None:
                del _build._loaded[LIB]
            else:
                _build._loaded[LIB] = saved

    def times(name: str, x, args, n_cond, parts: int = 7, reps: int = 3) -> list[float]:
        run(name, x, args, n_cond, parts)
        out = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run(name, x, args, n_cond, parts)
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
        return out

    def case_args(weights, conds, n_cond: int, one_step: bool):
        traj = conds if conds is not None else torch.from_numpy(
            rng.normal(size=(n_cond, 30, 3)).astype(np.float32)).to(dev)
        kargs, h_proj = model._fused_flow_args(weights, model.encode(weights, (traj,)))
        if one_step:  # K4: the first coupling at one step
            cp = model.coupling
            blk0 = map_tree(lambda v: v[0], weights["blocks"]["coupling"])
            hp = cp.cond_proj(blk0, model.encode(weights, (traj,)))["a"][0]
            flat = coupling_flow_args(hp, **mlp_params_to_kernel_args(blk0["a"], cp.d_a))
        else:
            flat = dict(kargs, h_proj=h_proj)
        return flat, {name: layouts[name](flat["wm"]) for name in names}

    cases = [("rank batch", 100, 1000, params, None, False), ("sampling", 8, 10_000, params, None, False),
             ("K4 one step", 8, 10_000, params, None, True)]
    if with_trained:
        cases.insert(0, ("trained rank batch", 100, 1000, *trained(model, dev), False))
    for what, n_cond, draws, weights, conds, one_step in cases:
        with torch.no_grad():
            args = case_args(weights, conds, n_cond, one_step)
            x = torch.randn((draws * n_cond, model.size), generator=torch.Generator(device=dev).manual_seed(0),
                            device=dev)
            y = {name: (run(name, x, args, n_cond), run(name, x, args, n_cond)) for name in names}
            flat = args[0]
            kw = {k: v for k, v in flat.items() if k != "h_proj"}
            y_p = fused_flow_reference(x, flat["h_proj"], **kw, inverse=True, n_cond=n_cond)
            y_64 = fused_flow_reference(x.double(), flat["h_proj"].double(), **{k: v.double() for k, v in kw.items()},
                                        inverse=True, n_cond=n_cond)
            torch.cuda.synchronize()
        d32 = (y_p.double() - y_64).abs().max().item()
        parts = [f"float32 plain {d32:.3e}"]
        for name in names:
            d = (y[name][0].double() - y_64).abs().max().item()
            parts.append(f"{name} {d:.3e} ({100 * d / 1e-4:.1f}% of the 1e-4 bar, {d / d32:.2f}x the float32 plain "
                         f"version's; equal between calls: {torch.equal(*y[name])}; from the float32 plain version "
                         f"{(y[name][0] - y_p).abs().max().item():.3e})")
        print(f"{what} ({x.shape[0]:,} rows, N {n_cond}): max|y - y64|: " + "; ".join(parts), flush=True)
        if what == "trained rank batch":
            continue
        order = names + names[::-1]
        t = {name: [] for name in names}
        with torch.no_grad():
            for name in order:
                t[name] += times(name, x, args, n_cond)
        print(f"{what} ({x.shape[0]:,} rows): CUDA-event ms (in turns {', '.join(order)}; 6 each): " +
              "; ".join(f"{name} median {sorted(v)[len(v) // 2]:.3f} (range {min(v):.3f}-{max(v):.3f})"
                        for name, v in t.items()), flush=True)
        if what == "sampling":
            with torch.no_grad():
                for name in names:
                    got = {part: sorted(times(name, x, args, n_cond, bits))[1] for part, bits in PARTS.items()}
                    print(f"  parts of {name} at {x.shape[0]:,} rows (CUDA-event medians of 3, ms): " +
                          "; ".join(f"{part} {ms:.2f}" for part, ms in got.items()), flush=True)


if __name__ == "__main__":
    main()
