#!/usr/bin/env python3
"""The routes at the padded widths 768 and 1024, on one NVIDIA GPU: K1 both
ways, K2a, K2b and K4 both ways, in 3xTF32 and in one TF32 pass, each beside
its bound and its plain version's time; the 3xTF32 inverses (K1's and K4's)
on the wide inverse and on the row tiles, forced; the 3xTF32 forwards (K1's,
K2a, K4's) on the wide forward, on each of its tiles (128 and 64 rows) and
on the row tiles, forced, at 4096 rows and at a validation batch's 256; the
3xTF32 K2b on the wide backward and on the row tiles, forced.

Run from the root of a checkout on a machine with a card:

    python3 tools/wide_rows_times.py [--shape tool|wide]

Below Hp 544 the tensor-core modes run the `wgmma` kernels; at 768 and 1024
the 3xTF32 inverse runs the wide inverse and the 3xTF32 forwards the wide
forward (`csrc/flow_wide_wgmma.cu`), the 3xTF32 K2b the wide backward
(`csrc/flow_wide_train_wgmma.cu`, handed the step's weight layout,
`train_weights`, as a training step hands it), and every other of these
kernels the row tiles (`csrc/flow_kernel.cu`, `csrc/flow_train_kernel.cu`,
and their one-pass `*_tf32` builds); the 3xTF32 inverses, forwards and K2b
are timed on the row tiles too (`WIDE_WGMMA_MAX_TN = 0`, `WIDE_FWD_MAX_TN =
0`, `WIDE_TRAIN_MAX_TN = 0`), the forwards on each tile of the wide forward
(`WIDE_FWD_HALF_MAX_ROWS` 0 and past the rows).
The shape (`tool`, the default) is the flagship's but wider: 26 steps of 4
hidden layers, size 19, d_a 10, at H 700 (Hp 768) and H 1000 (Hp 1024);
`wide` is the wide run config's (`trajectory_LSTM_xsmall_large_hybrid_dual`:
32 steps of 4 layers at H 1024), where K1's inverse also runs on the rank
batch's 100,000 rows conditioned on 100. Random weights, conditions and
cotangents from seed 0. Rows as on the main path: K1's inverse on 80,000
rows conditioned on 8 (a `sample` of 10,000 x 8), its forward, K2a and K2b
on 4096 rows with their own conditions, K4 (K1's kernel at one step) on
80,000 rows inverse and 4096 forward; K1's forward and K2a also on 256
rows (the run configs' validation batch). Each call's route (`flow_route`,
`train_bwd_route`) is printed and must be the one named. Times: CUDA events around one call, median of 5 after a warm-up
(3 for K1's inverse). Bound: the larger of the operations at the mode's
rate (3xTF32 a third of the TF32 peak, one pass the TF32 peak) and the bytes
at the memory rate, from chip_smoke.py's `flow_work`/`train_work` at the
unpadded width; the card's peaks from its name (chip_smoke.py's PEAKS).
Each kernel's plain PyTorch version (`fused_flow_reference`,
`fused_flow_train_reference`, `fused_flow_train_backward_reference`,
`fused_affine_coupling_reference`) is timed once a width on the same inputs
in float32 with TF32 off (the contract both modes serve; cuBLAS SGEMM),
median of 3, and printed beside each mode's kernel time.
"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, D_A, NH = 19, 10, 4
SHAPES = {"tool": (26, (700, 1000)), "wide": (32, (1024,))}  # steps; H (Hp 768 and 1024)


def main() -> None:
    import torch

    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from bcnf_tpu_torch.ops import _build
    from bcnf_tpu_torch.ops import coupling_kernel as ck
    from bcnf_tpu_torch.ops import flow_kernel as fk

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    shape = sys.argv[2] if sys.argv[1:2] == ["--shape"] else "tool"
    S, widths = SHAPES[shape]
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(["flow_kernel", "flow_kernel_tf32", "flow_train_kernel", "flow_train_kernel_tf32",
                      "flow_wide_wgmma", "flow_wide_train_wgmma"])  # together
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    peaks = cs.peaks_for(torch.cuda.get_device_name(0))
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    def timed(fn, reps: int = 5) -> float:
        return cs.median(cs.cuda_ms(fn, reps))

    names = ("an_scale", "an_bias", "ortho", "w1y", "b1", "wm", "bm", "wout", "bout")
    n_out = 2 * (SIZE - D_A)
    for H in widths:
        w = {"an_scale": 1 + 0.1 * randn(S, SIZE), "an_bias": 0.1 * randn(S, SIZE),
             "ortho": torch.linalg.qr(randn(S, SIZE, SIZE))[0].contiguous(),
             "w1y": randn(S, D_A, H, scale=D_A ** -0.5), "b1": randn(S, H, scale=0.1),
             "wm": randn(S, NH, H, H, scale=H ** -0.5), "bm": randn(S, NH, H, scale=0.1),
             "wout": randn(S, H, n_out, scale=0.1 * H ** -0.5), "bout": randn(S, n_out, scale=0.1)}
        k8, hp8 = fk.pad_hidden(w, randn(S, 8, H, scale=0.5))
        k4096, hp4096 = fk.pad_hidden(w, randn(S, 4096, H, scale=0.5))
        Hp = hp8.shape[-1]
        args = [k4096[n] for n in names]
        x80k, x4096 = randn(80_000, SIZE), randn(4096, SIZE)
        halves = {rows: (x[:, :D_A].contiguous(), x[:, D_A:].contiguous()) for rows, x in ((80_000, x80k), (4096, x4096))}
        dz, dld = randn(4096, SIZE), randn(4096)
        x256, hp256 = x4096[:256].contiguous(), hp4096[:, :256].contiguous()
        f_inv, f_fwd = cs.flow_work(k8, hp8, 80_000, H), cs.flow_work(k4096, hp4096, 4096, H)
        f_fwd256 = cs.flow_work(k4096, hp256, 256, H)
        w2a, w2b = cs.train_work(k4096, hp4096, 4096, H)
        w2a256 = cs.train_work(k4096, hp256, 256, H)[0]
        # K4: the first step's coupling alone (K1's kernel at one step)
        one = {n: t[:1] for n, t in w.items()}
        cw = dict(w1y=w["w1y"][0], b1=w["b1"][0], wm=list(w["wm"][0]), bm=list(w["bm"][0]), wout=w["wout"][0],
                  bout=w["bout"][0])
        c8, c4096 = randn(8, H, scale=0.5), randn(4096, H, scale=0.5)
        k4_inv_work = cs.flow_work(fk.pad_hidden(one, c8[None])[0], c8[None], 80_000, H)
        k4_fwd = cs.flow_work(fk.pad_hidden(one, c4096[None])[0], c4096[None], 4096, H)
        print(f"H {H} (Hp {Hp}), {S} steps x 4 hidden layers, size {SIZE}, d_a {D_A}:")
        x100k, hp100 = randn(100_000, SIZE), fk.pad_hidden(w, randn(S, 100, H, scale=0.5))[1]
        f_rank = cs.flow_work(k8, hp100, 100_000, H)
        with torch.no_grad():  # the plain versions, float32 (TF32 off), on the same inputs
            _, _, bound32 = fk.fused_flow_train_reference(x4096, hp4096, *args)
            plain = {
                "K1 inverse, 80,000 rows": timed(lambda: fk.fused_flow_reference(
                    x80k, hp8, *[k8[n] for n in names], inverse=True, n_cond=8), 3),
                "K1 inverse, rank batch's 100,000 rows": timed(lambda: fk.fused_flow_reference(
                    x100k, hp100, *[k8[n] for n in names], inverse=True, n_cond=100), 3),
                "K1 forward, 4096 rows": timed(lambda: fk.fused_flow_reference(
                    x4096, hp4096, *args, inverse=False, n_cond=4096), 3),
                "K1 forward, 256 rows": timed(lambda: fk.fused_flow_reference(
                    x256, hp256, *args, inverse=False, n_cond=256), 3),
                "K2a, 4096 rows": timed(lambda: fk.fused_flow_train_reference(x4096, hp4096, *args), 3),
                "K2a, 256 rows": timed(lambda: fk.fused_flow_train_reference(x256, hp256, *args), 3),
                "K2b, 4096 rows": timed(lambda: fk.fused_flow_train_backward_reference(
                    bound32, hp4096, dz, dld, *args), 3),
                "K4 inverse, 80,000 rows": timed(lambda: ck.fused_affine_coupling_reference(
                    *halves[80_000], c8, **cw, inverse=True, n_cond=8), 3),
                "K4 forward, 4096 rows": timed(lambda: ck.fused_affine_coupling_reference(
                    *halves[4096], c4096, **cw, inverse=False, n_cond=4096), 3),
            }
        print("    float32 plain versions (TF32 off): " + ", ".join(f"{k} {v:.3f} ms" for k, v in plain.items()),
              flush=True)
        for mode, arith in ((fk.MODE_3XTF32, cs.ARITH_3XTF32), (fk.MODE_TF32, cs.ARITH_TF32)):
            routes = {"K1": (fk.flow_route(Hp, SIZE, D_A, True, mode), fk.flow_route(Hp, SIZE, D_A, False, mode)),
                      "K2b": fk.train_bwd_route(Hp, SIZE, D_A, NH, mode)}
            def forced(fn, **settings):  # fn with fk's limits set: by default the 3xTF32 inverses on the row tiles
                settings = settings or {"WIDE_WGMMA_MAX_TN": 0}

                def run():
                    old = {k: getattr(fk, k) for k in settings}
                    for k, v in settings.items():
                        setattr(fk, k, v)
                    try:
                        return fn()
                    finally:
                        for k, v in old.items():
                            setattr(fk, k, v)
                return run

            def forwards(what, work, fn):  # a 3xTF32 forward on each wide tile and on the row tiles, forced
                if mode != fk.MODE_3XTF32:
                    return [(what, work, 5, fn)]
                return [(what + " (128-row tiles)", work, 5, forced(fn, WIDE_FWD_HALF_MAX_ROWS=0)),
                        (what + " (64-row tiles)", work, 5, forced(fn, WIDE_FWD_HALF_MAX_ROWS=1 << 30)),
                        (what + " (row tiles, forced)", work, 5, forced(fn, WIDE_FWD_MAX_TN=0))]

            with torch.no_grad():
                ws = fk.train_weights(x4096, hp4096, k4096["wm"], D_A, mode)  # the step's layout, as a step hands it
                _, _, bound = fk.fused_flow_train_fwd(x4096, hp4096, *args, mode=mode, wstages=ws)
                k2b = lambda: fk.fused_flow_train_bwd(bound, hp4096, dz, dld, *args, mode=mode, wstages=ws)
                k1_inv = lambda: fk.fused_flow(x80k, hp8, *[k8[n] for n in names], inverse=True, n_cond=8, mode=mode)
                k1_rank = lambda: fk.fused_flow(x100k, hp100, *[k8[n] for n in names], inverse=True, n_cond=100,
                                                mode=mode)
                k4_inv = lambda: ck.fused_affine_coupling(*halves[80_000], c8, **cw, inverse=True, n_cond=8, mode=mode)
                inverses = [("K1 inverse, 80,000 rows", f_inv, 3, k1_inv)] + (
                    [("K1 inverse, rank batch's 100,000 rows", f_rank, 3, k1_rank)] if shape == "wide" else [])
                if mode == fk.MODE_3XTF32:  # each beside its row tiles, in turns
                    inverses = [c for case in inverses for c in (case, (case[0] + " (row tiles, forced)", case[1], case[2],
                                                                       forced(case[3])))]
                cases = inverses + [
                    *forwards("K1 forward, 4096 rows", f_fwd,
                              lambda: fk.fused_flow(x4096, hp4096, *args, inverse=False, n_cond=4096, mode=mode)),
                    *forwards("K1 forward, 256 rows", f_fwd256,
                              lambda: fk.fused_flow(x256, hp256, *args, inverse=False, n_cond=256, mode=mode)),
                    *forwards("K2a, 4096 rows", w2a, lambda: fk.fused_flow_train_fwd(x4096, hp4096, *args, mode=mode)),
                    *forwards("K2a, 256 rows", w2a256, lambda: fk.fused_flow_train_fwd(x256, hp256, *args, mode=mode)),
                    ("K2b, 4096 rows", w2b, 5, k2b),
                    *([("K2b, 4096 rows (row tiles, forced)", w2b, 5, forced(k2b, WIDE_TRAIN_MAX_TN=0))]
                      if mode == fk.MODE_3XTF32 else []),
                    ("K4 inverse, 80,000 rows", k4_inv_work, 5, k4_inv),
                    *([("K4 inverse, 80,000 rows (row tiles, forced)", k4_inv_work, 5, forced(k4_inv))]
                      if mode == fk.MODE_3XTF32 else []),
                    *forwards("K4 forward, 4096 rows", k4_fwd,
                              lambda: ck.fused_affine_coupling(*halves[4096], c4096, **cw, mode=mode)),
                ]
                for what, work, reps, fn in cases:
                    ms = timed(fn, reps)
                    bound_ms, by = cs.bound_ms(work, peaks, arith)
                    p_ms = plain[what.split(" (")[0]]
                    print(f"    {mode} {what}: {ms:.3f} ms, bound {bound_ms:.3f} ms ({by}), {bound_ms / ms:.1%} of "
                          f"its bound; plain {p_ms:.3f} ms ({p_ms / ms:.2f}x the kernel's time)", flush=True)
            print(f"    {mode} routes: K1 inverse {routes['K1'][0]}, K1 forward / K2a / K4 forward "
                  f"{routes['K1'][1]} (tiles of {fk.wide_fwd_rows(256)} rows at 256, {fk.wide_fwd_rows(4096)} at "
                  f"4096), K2b {routes['K2b']}")
            wide = mode == fk.MODE_3XTF32
            if ((routes["K1"][0] == fk.ROUTE_WIDE) != wide or (routes["K1"][1] == fk.ROUTE_WIDE_FWD) != wide
                    or routes["K2b"] != (fk.ROUTE_WIDE_TRAIN if wide else fk.ROUTE_ROWS_TF32)):
                raise SystemExit(f"H {H} {mode}: not the wide inverse, forward and backward in 3xTF32 (the row "
                                 f"tiles in one pass): {routes}")


if __name__ == "__main__":
    main()
