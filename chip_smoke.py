#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`bcnf_tpu_torch`) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one line each; any failure exits non-zero and prints no result:

1. device: the card's name and power limit, versions; build every kernel
   from the checkout's sources (`bcnf_tpu_torch/ops/csrc/`, 15 libraries,
   one nvcc each, all started together); the registers and spill bytes of
   each instance of K1's `wgmma` inverse, the `wgmma` forward and K2b's
   `wgmma` route, both builds of each, of the wide inverse and forward and
   of the wide K2b (fails on any spill in the 3xTF32 libraries,
   `flow_wgmma`, `flow_wide_wgmma`, `flow_fwd_wgmma`, `flow_train_wgmma`
   and `flow_wide_train_wgmma`).
2. kernels: each kernel against its plain PyTorch version on the card, at
   the flagship widths, on a tiled and on a ragged shape: K1 in its default
   mode (3xTF32: the inverse on `wgmma`, the forward on the `wgmma`
   forward) and in
   strict mode (float32 FMA, csrc/flow_fma.cu); the strict K1 also at the
   padded widths 32, 128, 544 and 1024 and with no square hidden layer (nh =
   0), N not dividing B, both directions, each equal to the bit between two
   calls; the strict libraries' SASS (`flow_fma`: the strict K1 and K2a;
   `flow_train_fma`: the strict K2b) holds no tensor-core instruction; the
   3xTF32 `wgmma` inverse (2-block clusters, each k-stage folded into a
   float32 sum) at TN 1, 4, 16 and 17 on 64 k + 1 rows over an odd count of
   tiles, and the wide inverse (csrc/flow_wide_wgmma.cu) at H 700, 1000 and
   1024 (Hp 768, 1024) over odd counts of 128-row tiles, each equal to the
   bit between two calls, from the plain version in float64 no further than
   twice the float32 plain version; phase 1 fails on any spill in
   `flow_wide_wgmma` as in the other 3xTF32 `wgmma` libraries; and the wide
   forward (the same source) for K1's forward and K2a at H 700, 1000 and
   1024 on each of its tiles (128 and 64 rows), from float64 no further
   than the larger of the row tiles' distance and twice the float32 plain
   version's (z, logdet and K2a's step inputs), equal to the bit between
   two calls.
3. main path: the flagship `trajectory_LSTM_large` model (48,852,615
   params, random weights from a seed) on the card: posterior sampling of
   10,000 draws for 8 trajectories, then `log_prob` and the round trip on
   4096 of them, first in the default mode and then with `pallas_strict`;
   K1's launches by route are read for each; samples/s, the split of a
   `sample` call (with the `wgmma` weight preparation), the `wgmma`
   inverse's blocks, clusters and waves and its parts (products, stream,
   both without the cluster's exchange, neither), and each K1 kernel's time
   beside its bound and its plain version's time; the strict K1 with its
   layout (rows a lane, blocks, rounds, ring stages); both inverses on the
   main path's inputs equal to the bit between two calls and, on the 80,000
   sampling rows, no further from the plain version in float64 than twice
   the float32 plain version.
4. entry point: the `sample` CLI on a model directory written here.
5. training kernels: K2a (the whole-flow training forward) and K2b (its
   backward), 3xTF32 on their `wgmma` routes (csrc/flow_fwd_wgmma.cu,
   csrc/flow_train_wgmma.cu), against their float32 plain PyTorch versions
   and their plain 3xTF32 versions at the flagship widths, B = 4096 and a
   ragged B = 4099, every output and every grad (pulled back from
   standard-normal cotangents; each grad's largest value printed beside its
   error), two calls equal to the bit, launched on their routes; then,
   beside the row tiles forced, against the plain version in float64 on the
   flagship's random weights (fails where a `wgmma` route is further than
   the larger of the row tiles' distance and twice the float32 plain
   version's; phase 12 repeats it on its trained weights).
6. training main path: `Trainer.train` at float32 on the full flagship
   (coupling dropout 0, as bench.py's flagship) at batch 4096 (2 epochs of 3
   batches) and at batch 256 (1 epoch of 3 batches), on random y and
   trajectories from a seed, launches counted by route and mode (K2a on the
   3xTF32 `wgmma` forward, K2b on its 3xTF32 `wgmma` route, the hi/lo
   weights prepared once a step), then the same runs with the row tiles
   forced (losses within KERNEL_TOL of max(1, |loss|)); one step through
   the kernels against the plain autograd step on the same batch; train
   samples/s on each route and with the gate closed, a CUDA-event split of
   one step; K2a and K2b on both routes at the main path's inputs (in turns)
   beside their bounds and plain versions, K2b's parts alone on each (its
   26 rows kernels, 26 weight-grad passes, the rest), the `wgmma` routes'
   blocks and waves and ptxas lines, the hi/lo preparation against its plain
   version; fails where a `wgmma` route is not faster than the row tiles.
6b. strict training (`pallas_strict`: K2a and K2b in float32 FMA,
   csrc/flow_fma.cu's `fma_flow_train_kernel` and csrc/flow_train_fma.cu):
   both at the flagship widths, B = 4096 and a ragged 4099, against their
   plain versions with TF32 off on the plain version's inputs (K2a and what
   it keeps for K2b within 1e-4; K2b, on the plain step inputs and the plain
   keep, `train_keep_reference`, at the grad bar), each no further from the
   plain version in float64 than twice the float32 plain version, equal to
   the bit between two calls, and K2b on K2a's step inputs and keep at the
   grad bar; the flagship built
   with `pallas_strict` (dropout 0) trained by `Trainer.train` for 3 steps at
   batch 4096, K2a/K2b launched 3 times each, all in float32 FMA on the FMA
   route, counts zeroed before and read after; one step against the plain
   float32 autograd step (loss and grads at the bars); train samples/s both
   ways; the strict K2a's and K2b's times beside their bounds and plain
   versions, their layouts, K2b's parts (its rows kernel and its weight-grad
   pass, each one launch over the 26 steps), the keep's and K2b's scratch's
   bytes and the strict step's peak beside the card's memory. Their bounds
   count the work each does: K2a writes the keep, K2b reads it and
   recomputes nothing (two MLPs' products, not three).
7. entry point: the `train` CLI on a written dataset with a copy of the
   flagship config (`model.kwargs.dropout: 0`, 2 epochs), then `sample` from
   the model directory it wrote.
8. LSTM kernels: K3a (one direction's recurrence) and K3b (its backward),
   both on tensor cores in 3xTF32, against their plain PyTorch versions at
   the flagship encoder's shapes
   (B = 4096 and a ragged 4099, T = 30, H = 140, layers of 3 and 280
   inputs) and t_DLSTM_large's (H = 128, T = 30 and 16), both directions;
   their times beside cuDNN's one-layer LSTM (`torch.nn.LSTM`, timed as a
   yardstick only, never on the port's path); K3a's cluster rows and wave
   count at batch 4096; K3b's parts alone: the cluster recurrence and the
   dW_hh pass.
9. path A: the flagship with BCNF_FUSED_LSTM=1: sampling 10,000 x 8 (K3a
   4, K1 1) against phase 3's samples; `Trainer.train` at batch 4096 and
   256 (K3a/K3b 4 a step, K2a/K2b); a training step through K3a/K3b against
   the time-loop encoder's; train samples/s both ways; the `train` CLI.
10. path B: `configs/runs/nll/t_DLSTM_large.yaml` at its published widths
   (DualDomainLSTM, 37,053,181 params, random weights from the seed) with
   BCNF_FUSED_LSTM=1: sampling (K3a 16, K1 1) against the time loop's,
   `Trainer.train` at batch 256 and 4096 (K3a/K3b 16 a step; the flow on
   plain autograd, its coupling dropout 0.5 closing the training-kernel
   gate), a step against the time loop's, then `train` -> `sample` CLI.
11. path C: K4 (the per-coupling kernel: K1's kernels at one step, 3xTF32)
   against its plain version at the flagship widths, 4096 and 4099 rows,
   forward and inverse, and bit-equal to K4 on weights prepared for the
   launch, its inverse equal to the bit between two calls and no further
   from the plain version in float64 than twice the float32 plain version;
   the flagship with `use_pallas_coupling`: the inverse of phase 3's
   80,000 sampling rows through 26 K4 launches against K1's samples, the
   no-grad forward against K1's, and a second inverse pass: each coupling's
   weights prepared once over the three passes (its `preparations` and
   `stage_preparations`); K4's times on its kept weights beside the cost of
   one preparation and its earlier times; K4's forward on the 3xTF32
   `wgmma` forward against the row tiles forced (fails where they win).

12. the evaluation path: `generate_data` with the filter and the MC
   renderer (n = 128, the CLI's dt 1/30 and T 2), the impact loop's steps a
   batch and its CUDA-graph replays against its eager loop; the `train` CLI
   on the flagship's published config (coupling dropout 0.407, batch 256)
   with no dataset on disk, so its 5000 trajectories are generated on the
   card, 1 epoch (K2a/K2b not launched: their gate is closed), train
   samples/s and a CUDA-event split of one step; the 3xTF32 K2a and K2b on
   its trained weights and first 4096 training rows against the plain
   version in float64 beside the row tiles (as phase 5 on random weights);
   `generate` of a held-out
   set of 200 and `eval` with its defaults (M = 10,000, 1000 resimulation
   draws; its figures only where matplotlib is installed), K1's launches by
   direction, route and rows, each stage's seconds; then the card's test
   NLL against the CPU plain path, one rank batch through K1 against the
   plain version in float64 on the same z (at most half the 1e-4 bar and
   twice the float32 plain version's own distance; ranks against the
   float32 plain version's, near-ties excepted), and 4096 resimulated
   trajectories against the CPU; the
   published config's training step and `eval` also timed with the encoder
   on K3a/K3b (phase 17's table).

13. the model zoo, at published widths with random weights from the seed:
   path D, `configs/runs/nll/t_PTRF_large.yaml` (the Transformer encoder,
   37,046,525 params): sampling 10,000 x 8 through K1 (1 launch) against
   the plain path and the CPU, the encoder against the CPU, `log_prob` and
   the round trip on 4096 rows, K1's time at its sampling shape (Hp 512)
   beside its bound, equal to the bit between two calls and no further from
   the plain version in float64 than twice the float32 plain version,
   `Trainer.train` at batch 256 with the published dropout (plain
   autograd), train samples/s and a step split, then `train` -> `sample`;
   path E, `configs/runs/dev/trajectory_SFrExp_LSTM_SiGLU_2_large.yaml`
   (signed FrExp -> LSTM, a two-way AnyGLU flow, 48,543,591 params) with
   BCNF_FUSED_LSTM=1: sampling through the plain flow (K1 0, K3a 4), the
   round trip, `Trainer.train` at 256 with K3a/K3b and a step against the
   time loop's; path F, `configs/runs/trajectory_LSTM_noisy_calib7.yaml`
   (the RQS coupling): the `train` CLI on data generated on the card, `eval`
   at its defaults, its test NLL against the CPU; and both dual-domain
   hybrids (`t_DPTRF_large_hybrid`, `t_DFC_large_hybrid`): one `sample`
   through K1 and one training step each; then the one config at Hp 1024,
   `configs/runs/dev/trajectory_LSTM_xsmall_large_hybrid_dual.yaml` (32
   blocks of 5 x 1024, 136,369,060 params): one `sample` of 10,000 x 8
   through K1's wide inverse (csrc/flow_wide_wgmma.cu, 1 launch) against
   the plain path, and its rank batch (1000 draws x 100 conditions) timed
   on the wide inverse, the row tiles forced and the plain version in
   turns, held to float64 (twice the float32 plain version's distance, half
   the 1e-4 bar); fails where the wide inverse loses to either. Then its
   forwards on the wide forward: `log_prob` and the forward of 4096 draws
   (2 launches), a `Trainer` validation pass of its 1000 validation rows in
   padded batches of 256 (4 launches), one training step at batch 256 with
   the coupling dropout at 0 (K2a once on the wide forward, K2b once on the
   wide backward, csrc/flow_wide_train_wgmma.cu; the step's grads from
   standard-normal cotangents against the plain step's at the JAX grad
   bar) and the forward through K4 (32 launches), each against the plain
   path within the 1e-4 bar (the metrics relative to their size); K1's
   forward at 4096 and 256 rows with their own conditions timed in turns on
   the route, the row tiles (forced) and the plain version, K2a and K4's
   forward beside their plain versions; fails where the route loses at 4096
   rows to either or at 256 to the row tiles; K2b at 4096 and 256 rows timed
   in turns on the wide backward, the row tiles (forced) and the plain
   version, its grads within the JAX grad bar of the plain version, no
   further from float64 than max(row tiles, twice the float32 plain
   version), equal to the bit between calls; fails where it loses at 4096
   rows to either or at 256 to the row tiles.

14. the video path, `configs/runs/videos_CNN_LSTM_large.yaml` at its
   published widths (CNN 1->8->16->32 on 2 cameras x 30 frames of 90 x 160,
   a bidirectional 2-layer LSTM of H 212, a flow of 26 blocks of 5 x 526;
   67,787,515 params) with BCNF_FUSED_LSTM=1: (a) its CNN on the card
   against the CPU, features and weight grads; (b) K3a and K3b at H = 212
   (Hp 224) against their plain versions at B = 64, 100 and 200, their
   times at B = 64 beside the bound and cuDNN; (c) `train --online` at batch
   64 for 16 steps, a batch simulated and rendered on the card each step,
   launches held, then videos/s, a step split (simulate + render, CNN, LSTM,
   flow forward, backward, clip + Adam) and a profiled step; (d) `generate
   --output-type videos --renderer analytic` of 200 held-out videos; (e)
   `sample`, and `eval` at its defaults (K1's launches by rows, the JAX
   package's report keys, the test NLL of 8 points against the CPU plain
   path); (f) one epoch of the `train` CLI on 160 videos it generates; (g)
   `train --online --online-steps 8` on `trajectory_LSTM_noisy_calib2.yaml`
   (observation noise); (h) `train --pretrained-features` from (c)'s
   params.pkl with `--freeze-features`: the features stay (c)'s, bit for bit.

15. the reduced matmul precisions and `hpo`: (a) K1 (the inverse on `wgmma`
   at the sampling shape and on the row tiles, the forward at the log_prob
   shape), K2a and K2b at batch 4096 and K4 in one TF32 pass at the
   flagship's widths, each against its plain one-pass version and the 3xTF32
   kernel (JAX's reduced-mode bar, 5e-3) and shown not to be the 3xTF32
   kernel, their CUDA-event times beside 3xTF32's, the one-pass `wgmma`
   inverse's parts (products alone, stream alone, both, neither) and layout,
   the one-pass round trip beside the JAX CLI's TPU figure; K1's forward
   (4096 log_prob rows) and K2a on the `wgmma` forward
   (csrc/flow_fwd_wgmma.cu) and on the one-pass row tiles forced on the same
   inputs, each with its time (the `wgmma` forward's also with its weight
   preparation), bound and layout, the `wgmma` forward equal to the bit
   between two calls and no further from the plain one-pass version than
   twice the row tiles; K2b's `wgmma`
   route (csrc/flow_train_wgmma.cu) and the one-pass row tiles forced on the
   same inputs, each with its time, parts (rows, weight grads, the rest),
   bound, rate, blocks and waves, the `wgmma` route's weight preparation
   against its plain version (to the bit) and its ptxas lines; fails where
   the route is past the bar, further from the plain one-pass version than
   twice the row tiles, not equal to the bit between two calls, or not
   faster than the row tiles; then the precision path, counts zeroed
   before it: (b) `sample --precision BF16_BF16_F32_X3` and `eval` at its
   defaults in float32 and with `--precision default` on 200 generated
   points (the test NLL equal to the bit; stage seconds), the per-coupling
   inverse (K4) at "default"; (c) `Trainer.train` at `training.precision:
   default` on the flagship at batch 4096 with dropout 0 (K2a/K2b in one
   pass, both on `wgmma`, then with K2b's row tiles forced, then with K2a's:
   samples/s, the losses within the one-pass bar, the hidden weights
   prepared once a step) and on the published config at 256
   (plain autograd in TF32), train samples/s and losses beside float32; the
   one-pass training floor sweep (the flagship's dropout-0 step at 32-256
   rows with K2b on `wgmma`, on the row tiles and on plain autograd); (d)
   `hpo` on 512 trajectories generated on the card, 3 calls x 2 folds x 2
   epochs, then a re-run that resumes. Fails if a one-pass kernel (K2b by
   route, its weight preparation) was not launched on the path.

16. data parallelism (`parallel/mesh.py`) on the one card: (a) the
   flagship (dropout 0, BCNF_FUSED_LSTM=1) on a mesh of two shards placed on
   the card (`Mesh([cuda:0, cuda:0])`): one `Trainer` step at batch 4096
   against the unsharded step on the same batch and params (the NLL, and
   every grad pulled back from standard-normal cotangents, at the JAX grad
   bar), K2a, K2b, K3a and K3b launched exactly twice as often, then
   `Trainer.train` for 1 epoch of 3 batches and train samples/s beside the
   unsharded rate; (b) the same step under a one-rank NCCL process group,
   and the time of the grads' `all_reduce`; (c) sharded calibration ranks of
   64 points at M = 10,000 equal to the unsharded ranks, K1's launches by
   rows, and sharded resimulation of 8 points x 100 draws (the grid against
   one device's on the same draws within 1e-6); (d) `train_online` on
   `videos_CNN_LSTM_large` on the mesh for 8 steps at batch 64 beside the
   unsharded run, launches per shard; (e) `sample --dp-devices 1` and `eval
   --dp-devices 1` on the card, and `train --dp-devices 2`, which must raise
   the JAX package's message (one card). Fails if a sharded path launched
   no kernel.

17. the policies set from the card's numbers: (a) the fused LSTM's table,
   each published configuration timed in this run with the encoder on
   K3a/K3b and on the time loop (phases 9, 10, 12, 14: the flagship's step
   at 4096 and 256 with dropout 0 and at its published dropout, t_DLSTM's
   step at 256, the online video step at 64, the flagship's `eval`), then,
   with BCNF_FUSED_LSTM unset, the flagship's `sample` on the card through
   K3a/K3b (the default); fails where the kernels lose a case by more than
   LSTM_LOSS; (b) the training floor: the flagship's dropout-0 step at 32,
   64, 128 and 256 rows with K2a/K2b and without, beside the model's
   `fused_train_min_batch`; the one-pass forward's routes by rows: K2a at
   32-256 and 4096 rows, K1's forward at 200, 2048 and 4096, on the `wgmma`
   forward and on the row tiles (fails where the row tiles win: the route
   has no row floor), in one pass and in 3xTF32; the float32 training
   floor on the 3xTF32 `wgmma` routes, on the row tiles and on plain
   autograd, and K2a + K2b of a step on both routes (fails where the row
   tiles win).

The line before the last is the kernel table as JSON (each row with its
arithmetic, `arith`: float32 FMA, 3xTF32 on the tensor cores, or one TF32
pass (`tf32`, phase 15's rows, with `ms_3xtf32` beside), its bound
at that arithmetic's peak, `zoo_launches`, `video_launches` and
`dp_launches`, its launches on phase 13's, phase 14's video-model and
phase 16's sharded runs, and for K3a and K3b
their `video_*` times and bound at the video model's LSTM shape); the last
line is {"ok": true, "device": {...}}. Imports nothing of JAX or of
`bcnf_tpu`.
"""

from __future__ import annotations

import contextlib
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = "{{BCNF_ROOT}}/configs/runs/trajectory_LSTM_large.yaml"  # resolves to this checkout
FLAGSHIP_PARAMS = 48_852_615
N_COND, M_DRAWS, LOGPROB_ROWS = 8, 10_000, 4096  # calibration protocol: M = 10,000 (bench.py:187)
SEED = 0
# K1's 3xTF32 inverse on phase 12's rank batch against the plain version in
# float64: at most this share of KERNEL_TOL (and twice the float32 plain
# version's own distance). Before each k-stage was folded into a float32 sum
# the tensor cores' truncated accumulation took it to 91-95% (PERF.md).
RANK_MARGIN = 0.5
# Kernel vs plain, both float32 on the card: they differ only in the order of
# the sums (526-long dot products, 6 layers x 26 steps), which moves results
# by ~1e-6..1e-5 here; 1e-4 is the JAX package's own kernel-vs-XLA bar
# (tests/test_flow_kernel.py) and still catches a wrong layer or step.
KERNEL_TOL = 1e-4
# inverse then forward through 26 steps: the JAX package's round-trip bar
ROUNDTRIP_TOL = 5e-4
# grads, kernel against plain: the JAX package's grad bar
# (tests/test_flow_kernel.py:313), |d| <= atol + rtol * |plain|, with the
# atol capped at GRAD_REL of the grad's largest value, so that the bar stays
# well below the values of a grad at any scale (an absolute atol set at
# B = 16 sits above the values of small grads at B = 4096). The grads are
# pulled back from standard-normal cotangents on z and logdet (as the `gpu`
# tests do): no sum cancels, as the summed NLL's constant logdet cotangent
# makes the ActNorm scale grad's do, past what float32 resolves.
GRAD_ATOL, GRAD_RTOL, GRAD_REL = 5e-4, 1e-3, 1e-4
# the LSTM kernels against their plain versions: the JAX package's bars for
# its LSTM kernel (tests/test_lstm_kernel.py:30, 48), hs and cs 1e-5, grads
# atol 1e-4 (capped at GRAD_REL of the grad's largest value) and rtol 1e-4
LSTM_TOL, LSTM_GRAD_ATOL, LSTM_GRAD_RTOL = 1e-5, 1e-4, 1e-4
# the fused LSTM's default (phase 17): each published configuration's time
# with the encoder on K3a/K3b and on the time loop, in this run:
# case -> (kernels, loop, unit); a unit of "s" is better lower
LSTM_TABLE: dict[str, tuple[float, float, str]] = {}
DLSTM_CONFIG = "{{BCNF_ROOT}}/configs/runs/nll/t_DLSTM_large.yaml"
DLSTM_PARAMS = 37_053_181
TRAIN_ARGS = ("an_scale", "an_bias", "ortho", "w1y", "b1", "wm", "bm", "wout", "bout")
GRAD_NAMES = ("dx", "dh_proj", "dan_scale", "dan_bias", "dw1y", "db1", "dwm", "dbm", "dwout", "dbout")
# Published dense peaks (NVIDIA data sheets) by card: float32 outside the
# tensor cores, TF32 on the tensor cores, and device-memory bandwidth.
PEAKS = {  # name fragment: (float32 FLOP/s, TF32 FLOP/s, bytes/s)
    "H100 PCIe": (51.2e12, 378e12, 2.0e12),
    "H100 NVL": (60.0e12, 417.5e12, 3.9e12),
    "H100": (66.9e12, 494.7e12, 3.35e12),  # SXM5
    "H200": (66.9e12, 494.7e12, 4.8e12),
}
# K1's times at the main path's shapes in earlier runs on an H100 80GB HBM3
# at 700 W (PERF.md's kernel table), printed beside this run's
K1_EARLIER_MS = {"inverse": 73.69, "forward": 8.52, "inverse, strict": 162.63, "forward, strict": 16.70}
# tensor-core instructions, none of which the strict K1's library may hold
TENSOR_CORE_SASS = ("HMMA", "HGMMA", "IMMA", "IGMMA", "DMMA", "BMMA", "BGMMA", "QMMA", "QGMMA")
# K4's times when it padded and stacked its weights at every launch, and its
# plain version's, in the same earlier runs (PERF.md)
K4_EARLIER_MS = {"inverse": (2.951, 6.504), "forward": (0.803, 0.535)}
# A kernel's arithmetic, and the rate its operations are bounded by: float32
# FMA at the float32 peak; 3xTF32 (three tensor-core products a product,
# csrc/mma_tf32.cuh) at a third of the TF32 peak.
ARITH_FMA, ARITH_3XTF32, ARITH_TF32 = "fp32-fma", "3xtf32", "tf32"  # tf32: one pass, at the TF32 peak


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def peaks_for(name: str) -> tuple[float, float, float]:
    for frag, peak in PEAKS.items():
        if frag in name:
            return peak
    fail(f"no published peak rates for {name!r}")
    raise AssertionError


def flow_work(kargs: dict, h_proj, rows: int, H: int) -> tuple[float, float]:
    """Operations and bytes one K1 call needs for `rows` rows at the
    unpadded hidden width H: each input read once, each output written once."""
    S, size = kargs["an_scale"].shape
    d_a, nh = kargs["w1y"].shape[1], kargs["wm"].shape[1]
    n_out = kargs["wout"].shape[-1]
    flops = rows * (S * 2 * (d_a * H + nh * H * H + H * n_out) + (S - 1) * 2 * size * size)
    weights = S * (2 * size + size * size + d_a * H + H + nh * (H * H + H) + H * n_out + n_out)
    nbytes = 4 * (weights + S * h_proj.shape[1] * H + 2 * rows * size + rows)
    return float(flops), float(nbytes)


def train_work(kargs: dict, h_proj, rows: int, H: int,
               kept: bool = False) -> tuple[tuple[float, float], tuple[float, float]]:
    """(operations, bytes) of one K2a call and of one K2b call for `rows`
    rows with their own conditions, at the unpadded hidden width H. K2a is
    K1's forward plus the (S, rows, size) step inputs it writes. K2b, from
    those inputs, recomputes each step's MLP, multiplies the cotangents back
    through the transposed weights, and forms the weight products: three
    times the forward's matmul work, plus the mixes' transposes; it reads the
    step inputs, h_proj, dz, dld and the weights once and writes dx, dh_proj
    and the weight grads once. `kept` (the strict pair): K2a also writes
    each step's h_l and gelu'(a_l), l = 0 .. nh, and s, and K2b reads them
    and recomputes nothing: twice the forward's matmul work, plus the
    mixes'."""
    S, size = kargs["an_scale"].shape
    d_a, nh = kargs["w1y"].shape[1], kargs["wm"].shape[1]
    n_out = kargs["wout"].shape[-1]
    f_ops, f_bytes = flow_work(kargs, h_proj, rows, H)
    mlp = rows * S * 2 * (d_a * H + nh * H * H + H * n_out)
    mixes = rows * (S - 1) * 2 * size * size
    weights = S * (2 * size + size * size + d_a * H + H + nh * (H * H + H) + H * n_out + n_out)
    b_bytes = 4 * (2 * weights + 2 * S * rows * H + S * rows * size + 2 * rows * size + rows)
    keep = 4.0 * S * rows * (2 * (nh + 1) * H + n_out // 2) if kept else 0.0
    return ((f_ops, f_bytes + 4.0 * S * rows * size + keep),
            (float((2 if kept else 3) * mlp + mixes), float(b_bytes + keep)))


def grad_excess(got, ref, atol: float = GRAD_ATOL, rtol: float = GRAD_RTOL) -> tuple[float, float, float]:
    """(max |got - ref|, max of |got - ref| - (atol' + rtol |ref|),
    max |ref|), with atol' = min(atol, GRAD_REL max |ref|): the second is
    <= 0 when every element is inside the grad bar."""
    d, mag = (got - ref).abs(), ref.abs().max().item()
    cap = min(atol, GRAD_REL * mag)
    return d.max().item(), (d - cap - rtol * ref.abs()).max().item(), mag


def randn_cotangents(z):
    """Standard-normal cotangents (dz, dlogdet) for z's rows, from the seed."""
    import torch

    gen = torch.Generator(device=z.device).manual_seed(SEED)
    return (torch.randn(z.shape, generator=gen, device=z.device),
            torch.randn((z.shape[0],), generator=gen, device=z.device))


def check_grads(what: str, names, got, ref, atol: float = GRAD_ATOL, rtol: float = GRAD_RTOL) -> float:
    """Hold each grad against its plain version at the grad bar. Prints
    max |plain| and max |d| for every grad, then fails where one is outside
    the bar. Returns the largest max |d|."""
    worst, faults = 0.0, []
    for name, a, b in zip(names, got, ref):
        d, excess, mag = grad_excess(a, b, atol, rtol)
        worst = max(worst, d)
        print(f"      {what} {name}: max|plain| {mag:.3e}, max|d| {d:.3e}")
        if excess > 0:
            faults.append(f"{name} is {excess:.3e} past the grad bar")
    if faults:
        fail(f"{what}: " + "; ".join(faults))
    return worst


def kernel_label(ptxas_line: str) -> str:
    """`name<template args>` of the kernel a ptxas "Compiling entry
    function '<mangled name>'" line names (its last name component)."""
    import re

    mangled = ptxas_line.split("'")[1] if "'" in ptxas_line else ""
    pos, name = (3, "") if mangled.startswith("_ZN") else (2, "")
    while pos < len(mangled) and mangled[pos].isdigit():  # <length><name> components
        m = re.match(r"\d+", mangled[pos:])
        n = int(m.group(0))
        pos += len(m.group(0))
        name, pos = mangled[pos: pos + n], pos + n
    m = re.match(r"I((?:L[ib]\d+E)+)E", mangled[pos:])
    args = re.findall(r"L[ib](\d+)E", m.group(1)) if m else []
    return (name or "?") + (f"<{','.join(args)}>" if args else "")


def zero_flow_counts() -> None:
    """K1's launch counts to 0: in all, and by route."""
    from bcnf_tpu_torch.ops.flow_kernel import fused_flow

    fused_flow.launches = 0
    fused_flow.route_launches.clear()


def route_rows(route: str, Hp: int) -> int:
    """Rows a block of K1's kernel on `route` owns at the padded width Hp
    (csrc/flow_wgmma.cu: 64; csrc/flow_rows.cuh: 32, 16 from Hp 768; the
    strict kernel, csrc/flow_fma.cu, is laid out by `fma_layout`)."""
    if route in ("rows", "rows_tf32"):
        return 32 if Hp <= 32 * 17 else 16
    return 64


def strict_sass_check(lib_path: str, what: str = "the strict K1's library") -> int:
    """A strict library (`flow_fma`: the strict K1 and K2a; `flow_train_fma`:
    the strict K2b) holds no tensor-core instruction (`cuobjdump -sass`);
    returns its count of FFMA instructions."""
    import re

    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run([os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump"), "-sass", lib_path],
                          capture_output=True, text=True, check=True).stdout
    found = sorted({m for m in re.findall(r"\b([A-Z]+MMA)\b", sass) if m in TENSOR_CORE_SASS})
    if found:
        fail(f"{what} holds tensor-core instructions: {', '.join(found)}")
    n_ffma = len(re.findall(r"\bFFMA\b", sass))
    if n_ffma == 0:
        fail(f"{what} holds no FFMA instruction: cuobjdump read nothing")
    return n_ffma


# the libraries whose every kernel instance must keep its registers (phase 1):
# K1's 3xTF32 `wgmma` inverses (Hp <= 544, and the wide one at 768/1024), and
# the 3xTF32 `wgmma` forward and K2b route
NO_SPILL = ("flow_wgmma", "flow_wide_wgmma", "flow_fwd_wgmma", "flow_train_wgmma", "flow_wide_train_wgmma")


def wgmma_spill_check() -> None:
    """Phase 1: the registers and spill bytes of each instance of K1's
    `wgmma` inverse (each build, and the wide inverse), the `wgmma` forward
    (K1's, K2a's, K4's) and K2b's `wgmma` route, each in both builds, and
    the wide K2b, from
    this run's ptxas output (where
    this run built the library) and from the built library (`cuobjdump
    -res-usage`: STACK and LOCAL bytes a thread); fails on any spill in the
    3xTF32 libraries (`NO_SPILL`)."""
    import re

    from bcnf_tpu_torch.ops import _build

    for lib in ("flow_wgmma", "flow_wgmma_tf32", "flow_wide_wgmma", "flow_fwd_wgmma", "flow_fwd_wgmma_tf32",
                "flow_train_wgmma", "flow_train_wgmma_tf32", "flow_wide_train_wgmma"):
        ptxas, kernel = {}, "?"
        for ln in _build.build_logs.get(lib, "").splitlines():
            if "Compiling entry function" in ln:
                kernel = kernel_label(ln)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m:
                ptxas[kernel] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                ptxas[kernel + " registers"] = int(m.group(1))
        usage = _build.resource_usage(lib)
        parts = []
        for fn, u in usage.items():
            name = kernel_label(f"'{fn}'")
            spill = ptxas.get(name, "not rebuilt in this run")
            parts.append(f"{name} {u['REG']} registers, stack {u['STACK']} B, local {u['LOCAL']} B, ptxas spill "
                         f"bytes {spill}")
            if lib in NO_SPILL and (u["STACK"] or u["LOCAL"] or (isinstance(spill, int) and spill)):
                fail(f"{lib}'s {name} spills: {parts[-1]}")
        print(f"    {lib} resources: " + "; ".join(parts))
        if not usage:
            fail(f"cuobjdump -res-usage read no kernel from {lib}")


def strict_widths_check(dev) -> None:
    """Phase 2's strict K1 at the padded widths 32, 128, 544 and 1024 and
    with no square hidden layer (nh = 0), random weights from the seed, N
    not dividing B, both directions: within KERNEL_TOL of the plain version,
    equal to the bit between two calls, one launch each on the FMA route."""
    import torch

    from bcnf_tpu_torch.ops.flow_kernel import (MODE_FMA, ROUTE_FMA, fma_card_layout, fused_flow,
                                                fused_flow_reference, pad_hidden)

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    worst, cases = 0.0, []
    for H, nh, S, B, N in ((16, 2, 4, 4099, 7), (100, 4, 4, 4099, 7), (526, 4, 6, 4099, 7), (1000, 2, 4, 1001, 9),
                           (526, 0, 6, 4099, 7), (16, 0, 4, 37, 5)):
        size, d_a = 19, 10
        w = {"an_scale": 1 + 0.1 * randn(S, size), "an_bias": 0.1 * randn(S, size),
             "ortho": torch.linalg.qr(randn(S, size, size))[0].contiguous(),
             "w1y": randn(S, d_a, H, scale=d_a ** -0.5), "b1": randn(S, H, scale=0.1),
             "wm": randn(S, nh, H, H, scale=H ** -0.5), "bm": randn(S, nh, H, scale=0.1),
             "wout": randn(S, H, 2 * (size - d_a), scale=0.3 * H ** -0.5), "bout": randn(S, 2 * (size - d_a), scale=0.1)}
        kargs, h_proj = pad_hidden(w, randn(S, N, H, scale=0.5))
        x = randn(B, size)
        for inverse in (True, False):
            before = fused_flow.route_launches[ROUTE_FMA]
            one = fused_flow(x, h_proj, **kargs, inverse=inverse, n_cond=N, mode=MODE_FMA)
            two = fused_flow(x, h_proj, **kargs, inverse=inverse, n_cond=N, mode=MODE_FMA)
            ref = fused_flow_reference(x, h_proj, **kargs, inverse=inverse, n_cond=N)
            torch.cuda.synchronize()
            if fused_flow.route_launches[ROUTE_FMA] != before + 2:
                fail(f"the strict K1 at H {H}, nh {nh} did not launch on its route twice")
            wrap = (lambda t: (t,)) if inverse else tuple
            err = max((a - b).abs().max().item() for a, b in zip(wrap(one), wrap(ref)))
            bits = all(torch.equal(a, b) for a, b in zip(wrap(one), wrap(two)))
            worst = max(worst, err)
            cases.append(f"Hp {h_proj.shape[-1]} nh {nh} {'inv' if inverse else 'fwd'} {err:.1e}")
            if not err <= KERNEL_TOL or not bits or not all(torch.isfinite(t).all() for t in wrap(one)):
                fail(f"the strict K1 at H {H}, nh {nh}, B {B}, N {N} ({'inverse' if inverse else 'forward'}): "
                     f"max|d| {err:.3e} (tolerance {KERNEL_TOL:g}), equal between calls: {bits}")
        cases[-1] += f" (layout {fma_card_layout(B, h_proj.shape[-1], size, d_a)})"
    print(f"[2 kernels, strict] flow_fma vs plain, size 19, d_a 10, B = 4099/N = 7 (1001/9 at Hp 1024, 37/5 at "
          f"nh 0, Hp 32), each equal to the bit between two calls; max|d|: {'; '.join(cases)} (worst {worst:.3e}, "
          f"tolerance {KERNEL_TOL:g})")


def wgmma_widths_check(dev) -> None:
    """Phase 2's 3xTF32 `wgmma` inverses at TN 1, 4, 16 and 17 (Hp 32, 128,
    512, 544: 2-block clusters splitting the columns, each k-stage folded,
    64-row tiles) and at TN 24 and 32 (Hp 768 and 1024 at H 700, 1000 and
    1024: the wide inverse, clusters of Hp/128 blocks on 128-row tiles),
    random weights from the seed, B over an odd count of tiles with a ragged
    last one, N not dividing B: within KERNEL_TOL of the plain version, from
    the plain version in float64 no further than twice the float32 plain
    version's own distance (plus 4 float32 steps at the largest value),
    equal to the bit between two calls, two launches on its route."""
    import torch

    from bcnf_tpu_torch.ops.flow_kernel import (ROUTE_WGMMA, ROUTE_WIDE, flow_route, fused_flow, fused_flow_reference,
                                                pad_hidden, wgmma_grid, wide_grid)

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    cases, worst = [], 0.0
    for H, B in ((16, 257), (100, 4097), (500, 257), (526, 4097), (700, 257), (1000, 4097), (1024, 1151)):
        S, nh, N, size, d_a = 6, 4, 7, 19, 10
        w = {"an_scale": 1 + 0.1 * randn(S, size), "an_bias": 0.1 * randn(S, size),
             "ortho": torch.linalg.qr(randn(S, size, size))[0].contiguous(),
             "w1y": randn(S, d_a, H, scale=d_a ** -0.5), "b1": randn(S, H, scale=0.1),
             "wm": randn(S, nh, H, H, scale=H ** -0.5), "bm": randn(S, nh, H, scale=0.1),
             "wout": randn(S, H, 2 * (size - d_a), scale=0.3 * H ** -0.5), "bout": randn(S, 2 * (size - d_a), scale=0.1)}
        kargs, h_proj = pad_hidden(w, randn(S, N, H, scale=0.5))
        x = randn(B, size)
        Hp = h_proj.shape[-1]
        route = flow_route(Hp, size, d_a, True)
        if route != (ROUTE_WGMMA if Hp <= 544 else ROUTE_WIDE):
            fail(f"the 3xTF32 inverse at Hp {Hp} takes the route {route}")
        before = fused_flow.route_launches[route]
        one = fused_flow(x, h_proj, **kargs, inverse=True, n_cond=N)
        two = fused_flow(x, h_proj, **kargs, inverse=True, n_cond=N)
        p32 = fused_flow_reference(x, h_proj, **kargs, inverse=True, n_cond=N)
        p64 = fused_flow_reference(x.double(), h_proj.double(), **{k: v.double() for k, v in kargs.items()},
                                   inverse=True, n_cond=N)
        torch.cuda.synchronize()
        err = (one - p32).abs().max().item()
        d32, dk = (p32.double() - p64).abs().max().item(), (one.double() - p64).abs().max().item()
        floor = 4 * float(torch.finfo(torch.float32).eps) * max(1.0, p64.abs().max().item())
        bits = torch.equal(one, two)
        worst = max(worst, err)
        blocks = wgmma_grid(ROUTE_WGMMA, B) if route == ROUTE_WGMMA else wide_grid(B, Hp)
        cases.append(f"Hp {Hp} B {B} ({route}, {blocks} blocks): {err:.1e}, from float64 {dk:.2e} "
                     f"(float32 plain {d32:.2e})")
        if fused_flow.route_launches[route] != before + 2:
            fail(f"the 3xTF32 inverse at Hp {Hp} did not launch twice on {route}")
        if not err <= KERNEL_TOL or not bits or not dk <= 2 * d32 + floor or not torch.isfinite(one).all():
            fail(f"the 3xTF32 {route} inverse at Hp {Hp}, B {B}: max|d| {err:.3e} (tolerance {KERNEL_TOL:g}), from "
                 f"float64 {dk:.3e} against the float32 plain version's {d32:.3e} (bar twice it + {floor:.1e}), equal "
                 f"between calls: {bits}")
    print(f"[2 kernels, wgmma] flow_wgmma (3xTF32, 2-block clusters, k-stages folded; Hp <= 544) and "
          f"flow_wide_wgmma (Hp 768/1024) vs plain, size 19, nh 4, 6 steps, N = 7, each equal to the bit between two "
          f"calls; max|d|: {'; '.join(cases)} (worst {worst:.3e}, tolerance {KERNEL_TOL:g}; from float64 at most twice "
          f"the float32 plain version's)")


def wide_forward_check(dev) -> None:
    """Phase 2's 3xTF32 forwards at Hp 768 and 1024 on the wide forward
    (csrc/flow_wide_wgmma.cu: clusters of Hp/128 blocks, each 8 k-steps
    folded): K1's forward and K2a (its step inputs stored) at H 700, 1000
    and 1024, random weights from the seed, B over odd counts of tiles with
    a ragged last one, on each of the forward's tiles (128 rows, and 64 with
    `WIDE_FWD_HALF_MAX_ROWS` past B), N = 7 not dividing B for K1 (K2a: a
    condition a row): within KERNEL_TOL of the plain version; z, logdet and
    K2a's step inputs from the plain version in float64 no further than the
    larger of the row tiles' distance (forced, `WIDE_FWD_MAX_TN = 0`) and
    twice the float32 plain version's; equal to the bit between two calls;
    two launches on the route each."""
    import torch

    from bcnf_tpu_torch.ops import flow_kernel as fk

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    def from64(outs, ref) -> list[float]:
        return [(a.double() - b).abs().max().item() for a, b in zip(outs, ref)]

    names = ("an_scale", "an_bias", "ortho", "w1y", "b1", "wm", "bm", "wout", "bout")
    cases, worst, share = [], 0.0, 0.0
    half = fk.WIDE_FWD_HALF_MAX_ROWS
    try:
        for H, B in ((700, 257), (1000, 4097), (1024, 1151)):
            S, nh, N, size, d_a = 6, 4, 7, 19, 10
            w = {"an_scale": 1 + 0.1 * randn(S, size), "an_bias": 0.1 * randn(S, size),
                 "ortho": torch.linalg.qr(randn(S, size, size))[0].contiguous(),
                 "w1y": randn(S, d_a, H, scale=d_a ** -0.5), "b1": randn(S, H, scale=0.1),
                 "wm": randn(S, nh, H, H, scale=H ** -0.5), "bm": randn(S, nh, H, scale=0.1),
                 "wout": randn(S, H, 2 * (size - d_a), scale=0.3 * H ** -0.5),
                 "bout": randn(S, 2 * (size - d_a), scale=0.1)}
            kargs, h_proj = fk.pad_hidden(w, randn(S, N, H, scale=0.5))
            hp_rows = fk.pad_hidden(w, randn(S, B, H, scale=0.5))[1]
            args = [kargs[n] for n in names]
            x = randn(B, size)
            Hp = h_proj.shape[-1]
            if fk.flow_route(Hp, size, d_a, False) != fk.ROUTE_WIDE_FWD:
                fail(f"the 3xTF32 forward at Hp {Hp} takes the route {fk.flow_route(Hp, size, d_a, False)}")
            with torch.no_grad():
                k1 = lambda: fk.fused_flow(x, h_proj, **kargs, inverse=False, n_cond=N)
                k2a = lambda: fk.fused_flow_train_fwd(x, hp_rows, *args)
                p32 = {"K1": fk.fused_flow_reference(x, h_proj, **kargs, inverse=False, n_cond=N),
                       "K2a": fk.fused_flow_train_reference(x, hp_rows, *args)}
                p64 = {"K1": fk.fused_flow_reference(x.double(), h_proj.double(),
                                                     **{k: v.double() for k, v in kargs.items()}, inverse=False,
                                                     n_cond=N),
                       "K2a": fk.fused_flow_train_reference(x.double(), hp_rows.double(), *[a.double() for a in args])}
                with row_tiles_forced("WIDE_FWD_MAX_TN"):
                    rows = {"K1": k1(), "K2a": k2a()}
                for rows_max, tile in ((0, fk.kernel_limit("kWwRows")), (B, fk.kernel_limit("kWwHalfRows"))):
                    fk.WIDE_FWD_HALF_MAX_ROWS = rows_max
                    for what, fn, counter in (("K1", k1, fk.fused_flow), ("K2a", k2a, fk.fused_flow_train_fwd)):
                        before = counter.route_launches[fk.ROUTE_WIDE_FWD]
                        one, two = fn(), fn()
                        torch.cuda.synchronize()
                        err = max((a - b).abs().max().item() for a, b in zip(one, p32[what]))
                        bits = all(torch.equal(a, b) for a, b in zip(one, two))
                        d_k, d_r, d_p = (from64(o, p64[what]) for o in (one, rows[what], p32[what]))
                        bars = [max(r, 2 * p) for r, p in zip(d_r, d_p)]
                        worst, share = max(worst, err), max([share] + [k / b for k, b in zip(d_k, bars)])
                        cases.append(f"Hp {Hp} B {B} {what} on {tile}-row tiles: {err:.1e}, from float64 "
                                     f"{'/'.join(f'{d:.2e}' for d in d_k)} (row tiles "
                                     f"{'/'.join(f'{d:.2e}' for d in d_r)}, float32 plain "
                                     f"{'/'.join(f'{d:.2e}' for d in d_p)})")
                        if counter.route_launches[fk.ROUTE_WIDE_FWD] != before + 2:
                            fail(f"the wide forward ({what}) at Hp {Hp} did not launch twice on its route")
                        if (not err <= KERNEL_TOL or not bits or any(k > b for k, b in zip(d_k, bars))
                                or not all(torch.isfinite(t).all() for t in one)):
                            fail(f"the wide forward ({what}) at Hp {Hp}, B {B}, {tile}-row tiles: max|d| {err:.3e} "
                                 f"(tolerance {KERNEL_TOL:g}), from float64 {d_k} against max(row tiles, twice the "
                                 f"float32 plain version) {bars}, equal between calls: {bits}")
    finally:
        fk.WIDE_FWD_HALF_MAX_ROWS = half
    print(f"[2 kernels, wide forward] flow_wide_wgmma's forward (K1; K2a with its step inputs, z/logdet/bound) vs "
          f"plain, size 19, nh 4, 6 steps, each equal to the bit between two calls; max|d|: {'; '.join(cases)} (worst "
          f"{worst:.3e}, tolerance {KERNEL_TOL:g}; from float64 at most {share:.3f} of max(row tiles, twice the float32 "
          f"plain version's))")


def median(xs: list[float]) -> float:
    return sorted(xs)[len(xs) // 2]


def bound_ms(work: tuple[float, float], peaks: tuple[float, float, float], arith: str) -> tuple[float, str]:
    """The least time for the work on this card in the given arithmetic: the
    larger of its operations over that arithmetic's rate and its bytes over
    the memory rate; and which of the two it is."""
    rate = {ARITH_3XTF32: peaks[1] / 3, ARITH_TF32: peaks[1]}.get(arith, peaks[0])
    t_ops, t_bytes = 1e3 * work[0] / rate, 1e3 * work[1] / peaks[2]
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def kernel_row(name: str, source: str, replaces: str, launches: int, err: float, k_times: list[float],
               p_times: list[float], work: tuple[float, float], peaks: tuple[float, float, float],
               library_ms: float | None, arith: str = ARITH_FMA) -> dict:
    """One entry of the kernel table: median times, and the bound from the
    work's operations and bytes over the card's peaks for the kernel's
    arithmetic (`arith`)."""
    bound, by = bound_ms(work, peaks, arith)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": median(k_times), "plain_ms": median(p_times),
            "bound_ms": bound, "bound_by": by, "library_ms": library_ms, "arith": arith}


def cuda_ms(fn, reps: int) -> list[float]:
    """Per-launch times in ms from CUDA events, after one warm-up call."""
    import torch

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
    return times


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, HERE)
    try:
        import bcnf_tpu_torch
    except ImportError as e:
        fail(f"the port's package is not beside this script: {e}")
    if os.path.dirname(os.path.abspath(bcnf_tpu_torch.__file__)) != os.path.join(HERE, "bcnf_tpu_torch"):
        fail(f"imported bcnf_tpu_torch from {bcnf_tpu_torch.__file__}, not from this checkout")
    from bcnf_tpu_torch import CondRealNVP
    from bcnf_tpu_torch.__main__ import main as cli_main
    from bcnf_tpu_torch.bridge import map_tree, params_to_numpy
    from bcnf_tpu_torch.config import load_config
    from bcnf_tpu_torch.models import count_params
    from bcnf_tpu_torch.ops import _build
    from bcnf_tpu_torch.ops.flow_kernel import (
        MODE_3XTF32,
        MODE_FMA,
        ROUTE_FMA,
        ROUTE_FWD_WGMMA,
        ROUTE_ROWS,
        ROUTE_WGMMA,
        WG_COPIES,
        WG_EXCHANGE,
        WG_PRODUCTS,
        _launch_flow,
        fma_card_layout,
        fma_groups,
        flow_route,
        fused_flow,
        fused_flow_reference,
        prepare_weights,
        wgmma_grid,
    )

    # ---- 1. device + build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    peaks = peaks_for(kind)
    print(smi)
    t0 = time.perf_counter()
    _build.build_all()  # one nvcc per source, all started together
    for name in _build.SOURCES:
        _build.load_library(name)
    nvcc_s = ", ".join(f"{name} {sec:.1f} s" for name, sec in _build.build_seconds.items())
    print(f"[1 device] {kind} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"kernels built+loaded in {time.perf_counter() - t0:.1f} s (nvcc: {nvcc_s or 'cached'})")
    for name, log in _build.build_logs.items():
        kernel = "?"
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                kernel = kernel_label(ln)
            elif ("registers" in ln or "wgmma" in ln.lower() or "warning" in ln.lower()
                  or ("spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln)):
                print(f"    ptxas {name} {kernel}: {ln.strip().removeprefix('ptxas info    : ')}")
    wgmma_spill_check()
    for lib, what in (("flow_fma", "the strict K1's and K2a's library"), ("flow_train_fma", "the strict K2b's library")):
        n_ffma = strict_sass_check(str(_build.build(lib)), what)
        print(f"    {lib} SASS (cuobjdump): {n_ffma} FFMA, no tensor-core instruction ({'/'.join(TENSOR_CORE_SASS)})")
    # phases 2-8 and 11-13 run the encoders' time loop (their numbers and
    # checks are the loop's); the phases that run K3a/K3b set the variable
    # themselves, and phase 17 unsets it to drive the default
    fused_lstm(False)

    dev = torch.device("cuda")
    model = CondRealNVP.from_config(load_config(CONFIG))
    params = model.init(torch.Generator().manual_seed(SEED), device=dev)
    n_params = count_params(params)
    if n_params != FLAGSHIP_PARAMS:
        fail(f"flagship has {n_params:,} params, expected {FLAGSHIP_PARAMS:,}")
    H = model.nested_sizes[0]
    rng = np.random.default_rng(SEED)

    # ---- 2. kernel vs plain at flagship widths (ActNorm perturbed so it is exercised)
    an = params["blocks"]["actnorm"]
    k_params = dict(params, blocks=dict(params["blocks"], actnorm={
        "scale": an["scale"] + 0.1 * torch.from_numpy(rng.normal(size=an["scale"].shape).astype(np.float32)).to(dev),
        "bias": 0.1 * torch.from_numpy(rng.normal(size=an["bias"].shape).astype(np.float32)).to(dev),
    }))
    # K1 in both modes: the default 3xTF32 (the inverse on wgmma, the forward
    # on the wgmma forward) and strict (float32 FMA), each against the plain version
    modes = {"": False, " strict": True}
    errs = {f"{d}{m}": 0.0 for m in modes for d in ("inverse", "forward")}
    errs["forward row tiles"] = 0.0  # the 3xTF32 forward's row tiles, forced (Hp 768/1024 and forced runs take them)
    before, tiles_before = fused_flow.launches, fused_flow.route_launches[ROUTE_ROWS]
    for B, N in ((4096, 8), (4099, 7)):
        traj = torch.from_numpy(rng.normal(size=(N, 30, 3)).astype(np.float32)).to(dev)
        with torch.no_grad():
            kargs, h_proj = model._fused_flow_args(k_params, model.encode(k_params, (traj,)))
            x = torch.from_numpy(rng.normal(size=(B, model.size)).astype(np.float32)).to(dev)
            y_r = fused_flow_reference(x, h_proj, **kargs, inverse=True, n_cond=N)
            z_r, ld_r = fused_flow_reference(x, h_proj, **kargs, inverse=False, n_cond=N)
            for m, strict in modes.items():
                y_k = fused_flow(x, h_proj, **kargs, inverse=True, n_cond=N, mode=MODE_FMA if strict else MODE_3XTF32)
                z_k, ld_k = fused_flow(x, h_proj, **kargs, inverse=False, n_cond=N,
                                       mode=MODE_FMA if strict else MODE_3XTF32)
                torch.cuda.synchronize()
                errs[f"inverse{m}"] = max(errs[f"inverse{m}"], (y_k - y_r).abs().max().item())
                errs[f"forward{m}"] = max(errs[f"forward{m}"], (z_k - z_r).abs().max().item(),
                                          (ld_k - ld_r).abs().max().item())
            with row_tiles_forced("FWD_WGMMA_MAX_TN"):
                z_k, ld_k = fused_flow(x, h_proj, **kargs, inverse=False, n_cond=N, mode=MODE_3XTF32)
                torch.cuda.synchronize()
            errs["forward row tiles"] = max(errs["forward row tiles"], (z_k - z_r).abs().max().item(),
                                            (ld_k - ld_r).abs().max().item())
    if fused_flow.launches != before + 10 or fused_flow.route_launches[ROUTE_ROWS] != tiles_before + 2:
        fail("fused_flow did not count its launches, or the forced forward did not run on the row tiles")
    print(f"[2 kernels] fused_flow vs plain at H={H}, B=4096/N=8 and ragged B=4099/N=7: 3xTF32 max|dy| inverse "
          f"(wgmma) {errs['inverse']:.3e}, max|dz|,|dlogdet| forward (wgmma forward) {errs['forward']:.3e}, the "
          f"forward on its row tiles forced {errs['forward row tiles']:.3e}; strict (FMA) inverse "
          f"{errs['inverse strict']:.3e}, forward {errs['forward strict']:.3e} (tolerance {KERNEL_TOL:g})")
    for d, e in errs.items():
        if not e <= KERNEL_TOL:
            fail(f"fused_flow {d} disagrees with its plain version: {e:.3e} > {KERNEL_TOL:g}")
    strict_widths_check(dev)
    wgmma_widths_check(dev)
    wide_forward_check(dev)

    # ---- 3. main path: posterior sampling, then log_prob + round trip, in
    # the default mode (3xTF32) and then in strict mode (float32 FMA)
    traj = torch.from_numpy(rng.normal(size=(N_COND, 30, 3)).astype(np.float32))
    z_all = torch.randn((M_DRAWS, N_COND, model.size), generator=torch.Generator().manual_seed(SEED))
    cpu_params = map_tree(lambda t: t.cpu(), params)
    with torch.no_grad():
        ref = model.inverse_given_h(cpu_params, z_all[:64], model.encode(cpu_params, (traj,)))
    d = LOGPROB_ROWS // N_COND
    cond_lp = traj.to(dev).repeat(d, 1, 1)
    launches, run = {}, {}
    for mode, strict in (("3xtf32", False), ("strict", True)):
        model.pallas_strict = strict
        inv_route, fwd_route = (ROUTE_FMA, ROUTE_FMA) if strict else (ROUTE_WGMMA, ROUTE_FWD_WGMMA)
        with torch.no_grad():
            model.sample(params, torch.Generator().manual_seed(SEED), 16, traj, device=dev)  # warm-up
            torch.cuda.synchronize()
            zero_flow_counts()
            t0 = time.perf_counter()
            out = model.sample(params, torch.Generator().manual_seed(SEED), M_DRAWS, traj, device=dev)
            torch.cuda.synchronize()
            t_sample = time.perf_counter() - t0
            inv_launches = dict(fused_flow.route_launches)
        if inv_launches != {inv_route: 1}:
            fail(f"posterior sampling ({mode}) launched K1 {inv_launches}, not once on {inv_route}")
        if tuple(out.shape) != (M_DRAWS, N_COND, model.size) or not torch.isfinite(out).all():
            fail(f"samples ({mode}) of shape {tuple(out.shape)} are not all finite / not the expected shape")
        # the kernel's samples against the plain path on the CPU, for the first 64 draws
        cpu_err = (out[:64].cpu() - ref).abs().max().item()
        y_lp = out[:d].reshape(LOGPROB_ROWS, model.size)
        with torch.no_grad():
            zero_flow_counts()
            lp = model.log_prob(params, y_lp, cond_lp)
            z_rt, _ = model.forward(params, y_lp, cond_lp)
            torch.cuda.synchronize()
            fwd_launches = dict(fused_flow.route_launches)
        if fwd_launches != {fwd_route: 2}:
            fail(f"log_prob and the round trip ({mode}) launched K1 {fwd_launches}, not twice on {fwd_route}")
        rt_err = (z_rt.cpu() - z_all[:d].reshape(LOGPROB_ROWS, model.size)).abs().max().item()
        if not torch.isfinite(lp).all():
            fail(f"log_prob ({mode}) is not finite")
        print(f"[3 main path, {mode}] {n_params:,} params; sample {M_DRAWS}x{N_COND} in {t_sample:.3f} s = "
              f"{M_DRAWS * N_COND / t_sample:.0f} samples/s, K1 launches {inv_launches}; "
              f"max|d| vs CPU plain path (64 draws) {cpu_err:.3e}; log_prob on {LOGPROB_ROWS} rows "
              f"(K1 launches {fwd_launches}), round trip max|forward(sample) - z| {rt_err:.3e} "
              f"(tolerance {ROUNDTRIP_TOL:g}); mean log_prob {lp.mean().item():.3f}")
        if not cpu_err <= KERNEL_TOL:
            fail(f"samples ({mode}) disagree with the CPU plain path: {cpu_err:.3e} > {KERNEL_TOL:g}")
        if not rt_err <= ROUNDTRIP_TOL:
            fail(f"round trip error ({mode}) {rt_err:.3e} > {ROUNDTRIP_TOL:g}")
        launches[mode] = (inv_launches[inv_route], fwd_launches[fwd_route])
        run[mode] = (out, y_lp)
    model.pallas_strict = False
    samples, y_lp = run["3xtf32"]

    # K1 timed at the main path's shapes: inverse over M*N rows, forward over the log_prob batch
    kernels = []
    with torch.no_grad():
        # where a sample call's time goes: the same steps as CondRealNVP.sample, host clock
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x_inv = torch.randn(z_all.shape, generator=torch.Generator().manual_seed(SEED)).to(dev).reshape(-1, model.size)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        kargs, h_proj = model._fused_flow_args(params, model.encode(params, (traj.to(dev),)))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        fused_flow(x_inv, h_proj, **kargs, inverse=True, n_cond=N_COND)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        prep_ms = median(cuda_ms(lambda: prepare_weights(kargs["wm"]), reps=5))
        wm_mb = 4 * kargs["wm"].numel() / 1e6
        print(f"    sample breakdown (host clock): z draw on CPU + copy {1e3 * (t1 - t0):.1f} ms, encode + "
              f"projections + stacked args {1e3 * (t2 - t1):.1f} ms, K1 call {1e3 * (t3 - t2):.1f} ms, of which "
              f"the wgmma weight preparation {prep_ms:.2f} ms (CUDA events, median of 5; {wm_mb:.0f} MB in, "
              f"{2 * wm_mb:.0f} MB out)")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        wg_lib = _build.load_library("flow_wgmma")
        per_sm = wg_lib.bcnf_flow_wgmma_occupancy(h_proj.shape[-1], model.size, model.coupling.d_a)
        resident = wg_lib.bcnf_flow_wgmma_clusters(h_proj.shape[-1], model.size, model.coupling.d_a)
        blocks = wgmma_grid(ROUTE_WGMMA, x_inv.shape[0])
        if per_sm < 1 or resident < 1:
            fail(f"the wgmma inverse fits no block on an SM ({per_sm}) or no cluster on the card ({resident})")
        print(f"    wgmma inverse layout: {blocks} blocks in clusters of 2 (a cluster a 64-row tile, each block half "
              f"the columns), {per_sm} block an SM on {sms} SMs, {resident} clusters resident at once: "
              f"{blocks / 2 / resident:.2f} waves")
        hl = model.encode(params, (cond_lp,))
        kargs_f, h_proj_f = model._fused_flow_args(params, hl)
        shapes = {
            "inverse": (x_inv, kargs, h_proj, N_COND, launches["3xtf32"][0], True, False),
            "forward": (y_lp.contiguous(), kargs_f, h_proj_f, LOGPROB_ROWS, launches["3xtf32"][1], False, False),
            "inverse, strict": (x_inv, kargs, h_proj, N_COND, launches["strict"][0], True, True),
            "forward, strict": (y_lp.contiguous(), kargs_f, h_proj_f, LOGPROB_ROWS, launches["strict"][1], False, True),
        }
        saved = fused_flow.launches
        for direction, (x, ka, hp, n, n_launches, inv, strict) in shapes.items():
            # the kernel against its plain version at exactly the main path's inputs too
            kmode = MODE_FMA if strict else MODE_3XTF32
            out_k = fused_flow(x, hp, **ka, inverse=inv, n_cond=n, mode=kmode)
            out_p = fused_flow_reference(x, hp, **ka, inverse=inv, n_cond=n)
            err = max((a - b).abs().max().item() for a, b in zip(
                (out_k,) if inv else out_k, (out_p,) if inv else out_p))
            if not err <= KERNEL_TOL:
                fail(f"fused_flow {direction} at the main path's shape disagrees with plain: {err:.3e}")
            key = direction.replace(",", "")
            errs[key] = max(errs[key], err)
            route = flow_route(hp.shape[-1], model.size, ka["w1y"].shape[1], inv, kmode)
            if strict or route in (ROUTE_WGMMA, ROUTE_FWD_WGMMA):  # two calls equal to the bit; the inverse vs float64
                again = fused_flow(x, hp, **ka, inverse=inv, n_cond=n, mode=kmode)
                if not all(torch.equal(a, b) for a, b in zip((out_k,) if inv else out_k, (again,) if inv else again)):
                    fail(f"fused_flow {direction}: two calls differ (the kernel must sum in a fixed order)")
                if inv:
                    p64 = fused_flow_reference(x.double(), hp.double(), **{k: v.double() for k, v in ka.items()},
                                               inverse=True, n_cond=n)
                    d32, dk = (out_p.double() - p64).abs().max().item(), (out_k.double() - p64).abs().max().item()
                    del p64
                    print(f"    fused_flow[{direction}] against the plain version in float64 on the {x.shape[0]} "
                          f"sampling rows: max|d| {dk:.3e}, the float32 plain version's {d32:.3e} (bar: twice it)")
                    if not dk <= 2 * d32:
                        fail(f"fused_flow {direction}: {dk:.3e} from float64, past twice the float32 plain "
                             f"version's {d32:.3e}")
            k_times = cuda_ms(lambda: fused_flow(x, hp, **ka, inverse=inv, n_cond=n, mode=kmode), reps=5)
            p_times = cuda_ms(lambda: fused_flow_reference(x, hp, **ka, inverse=inv, n_cond=n), reps=3)
            flops, nbytes = flow_work(ka, hp, x.shape[0], H)
            arith = ARITH_FMA if strict else ARITH_3XTF32
            src = "bcnf_tpu_torch/ops/csrc/" + {ROUTE_WGMMA: "flow_wgmma.cu", ROUTE_FMA: "flow_fma.cu",
                                                ROUTE_FWD_WGMMA: "flow_fwd_wgmma.cu"}.get(route, "flow_kernel.cu")
            kernels.append(kernel_row(f"fused_flow[{direction}]", src, "bcnf_tpu/ops/flow_kernel.py:162", n_launches,
                                      errs[key], k_times, p_times, (flops, nbytes), peaks, None, arith))
            ms, plain_ms, bound = kernels[-1]["ms"], kernels[-1]["plain_ms"], kernels[-1]["bound_ms"]
            fma_bound = bound_ms((flops, nbytes), peaks, ARITH_FMA)[0]
            weights_gb = 4 * sum(int(v.numel()) for v in ka.values()) / 1e9
            if route == ROUTE_FMA:  # every block streams the weights once a round
                lane_rows, blocks, stages, _, smem = fma_card_layout(x.shape[0], hp.shape[-1], model.size,
                                                                      ka["w1y"].shape[1])
                groups = fma_groups(x.shape[0], lane_rows, blocks)
                rounds = max(-(-(g1 - g0) // 2) for g0, g1 in groups)
                l2_gb, tile = blocks * rounds * weights_gb, 8 * lane_rows
                busy = sum(g1 - g0 for g0, g1 in groups) / (blocks * rounds * 2)
                print(f"    fused_flow[{direction}] layout: {lane_rows} rows a lane ({tile} a round, two groups of "
                      f"{4 * lane_rows}), {blocks} blocks (one an SM, {sms} SMs), {rounds} rounds ({busy:.1%} of the "
                      f"groups' slots busy: {rounds * blocks / sms:.2f} waves of rounds), a {stages}-stage ring, "
                      f"{smem} bytes of shared memory")
            else:
                tile = route_rows(route, hp.shape[-1])
                l2_gb = -(-x.shape[0] // tile) * weights_gb
                if route in (ROUTE_WGMMA, ROUTE_FWD_WGMMA):  # hi and lo of the hidden weights
                    l2_gb += -(-x.shape[0] // tile) * 4 * int(ka["wm"].numel()) / 1e9
            print(f"    fused_flow[{direction}] ({route}, {arith}) rows {x.shape[0]}: {ms:.2f} ms (earlier runs: "
                  f"{K1_EARLIER_MS[direction]} ms; bound {bound:.2f} ms, "
                  f"float32-FMA bound {fma_bound:.2f} ms, {flops / 1e12:.2f} TFLOP -> {flops / ms / 1e9:.1f} TFLOP/s, "
                  f"median of {len(k_times)}, range {min(k_times):.2f}-{max(k_times):.2f}), plain {plain_ms:.2f} ms "
                  f"(range {min(p_times):.2f}-{max(p_times):.2f}); max|d| vs plain {err:.2e}; weights read from L2 "
                  f"per call ~{l2_gb:.0f} GB ({tile}-row {'rounds' if route == ROUTE_FMA else 'blocks'}) -> "
                  f"{l2_gb / ms:.2f} TB/s")
        fused_flow.launches = saved
        # the wgmma inverse's parts alone (uncounted launches): its products on
        # stale weight stages, and the weights' stream from L2 without the products
        staged, wg_args = prepare_weights(kargs["wm"]), dict(kargs, h_proj=h_proj)
        part_ms = {name: median(cuda_ms(lambda: _launch_flow(x_inv, wg_args, inverse=True, n_cond=N_COND, mode=MODE_3XTF32,
                                                             wstages=staged, parts=parts), reps=3))
                   for name, parts in (("all", WG_PRODUCTS | WG_COPIES | WG_EXCHANGE), ("products", WG_PRODUCTS),
                                       ("stream", WG_COPIES), ("no exchange", WG_PRODUCTS | WG_COPIES),
                                       ("neither", 0))}
        stream_gb = -(-x_inv.shape[0] // 64) * 4 * int(staged.numel()) / 1e9
        print(f"    wgmma inverse parts (CUDA events, median of 3, ms): as built {part_ms['all']:.2f}; its products "
              f"alone (stale stages) {part_ms['products']:.2f} ({flow_work(kargs, h_proj, x_inv.shape[0], H)[0] / part_ms['products'] / 1e9:.1f} "
              f"TFLOP/s); the hidden weights' stream alone {part_ms['stream']:.2f} ({stream_gb:.0f} GB of hi and lo from "
              f"L2 -> {stream_gb / part_ms['stream']:.2f} TB/s); both without the cluster's exchange "
              f"{part_ms['no exchange']:.2f}; neither (the FMA layers, the GELU, the hand-offs) {part_ms['neither']:.2f}")

    # ---- 4. the sample CLI on a model directory as `bcnf-tpu train` writes it
    build_dir = os.path.join(HERE, "bcnf_tpu_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        with open(os.path.join(tmp, "params.pkl"), "wb") as f:
            pickle.dump(params_to_numpy(params), f)
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump({"config_path": CONFIG}, f)
        names = list(model.parameter_index_mapping.parameters)
        data = {"trajectories": rng.normal(size=(4, 30, 3)).astype(np.float32)}
        data.update({p: rng.normal(size=4).astype(np.float32) for p in names})
        with open(os.path.join(tmp, "data.pkl"), "wb") as f:
            pickle.dump(data, f)
        out = os.path.join(tmp, "samples.npy")
        fused_flow.launches = 0
        cli_main(["sample", "-m", tmp, "-d", os.path.join(tmp, "data.pkl"), "-n", "100", "-o", out, "--seed", "1"])
        cli = np.load(out)
        cli_launches = fused_flow.launches
    if cli.shape != (100, 4, model.size) or not np.isfinite(cli).all() or cli_launches < 1:
        fail(f"sample CLI gave shape {cli.shape}, finite={np.isfinite(cli).all()}, launches={cli_launches}")
    print(f"[4 entry point] bcnf_tpu_torch sample: {cli.shape} finite, fused_flow launches {cli_launches}")

    check_train_kernels(model, k_params, rng, dev)
    kernels += train_main_path(rng, dev, peaks)
    kernels += strict_training(model, k_params, rng, dev, peaks)
    train_cli(rng, build_dir)
    lstm_times = check_lstm_kernels(rng, dev)
    k2b_ms = next(row["ms"] for row in kernels if row["name"].startswith("K2b"))
    lstm_launches = lstm_path_a(model, params, traj, samples, rng, dev, build_dir, lstm_times, k2b_ms)
    kernels += lstm_rows(lstm_times, lstm_launches, peaks)
    dlstm_path_b(rng, dev, build_dir)
    kernels += coupling_path_c(model, params, traj, samples, z_all, y_lp, cond_lp, rng, dev, peaks)
    eval_path(dev, build_dir, peaks)
    zoo = model_zoo(rng, dev, build_dir, peaks)
    wide_launches, wide_rows = zoo_wide(rng, dev, peaks)
    zoo.update(wide_launches)
    kernels += wide_rows
    video, lstm_video = video_path(rng, dev, build_dir, peaks)
    kernels += precision_path(model, params, rng, dev, build_dir, peaks)
    dp = parallel_path(rng, dev, build_dir)
    card_policies(model, params, rng, dev)
    for row in kernels:  # each kernel's launches on phase 13's, 14's and 16's paths, beside its main-path launches
        key = {"fused_flow[inverse]": "K1 inverse", "fused_flow[forward]": "K1 forward",
               "fused_flow[inverse, wide]": "K1 inverse, wide", "fused_flow[forward, wide]": "K1 forward, wide",
               "K2a[3xtf32, wide] fused_flow_train_fwd": "K2a, wide",
               "K2b[3xtf32, wide] fused_flow_train_bwd": "K2b, wide",
               "K4 fused_affine_coupling[forward, wide]": "K4 forward, wide"}.get(
            row["name"], row["name"].split()[0].removesuffix("[3xtf32]"))
        row["zoo_launches"] = zoo.get(key, 0)
        row["video_launches"] = video.get(key, 0)
        row["dp_launches"] = dp.get(key, 0)
        row.update(lstm_video.get(key, {}))

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


@contextlib.contextmanager
def train_row_tiles():
    """The row tiles of K2a and K2b in place of both `wgmma` routes (either
    mode): `FWD_WGMMA_MAX_TN = TRAIN_WGMMA_MAX_TN = 0`."""
    with row_tiles_forced("FWD_WGMMA_MAX_TN"), row_tiles_forced("TRAIN_WGMMA_MAX_TN"):
        yield


def train_pair_margin(model, weights: dict, x, traj, what: str) -> float:
    """K2a and K2b in 3xTF32 on their `wgmma` routes and on the row tiles
    forced, at `weights` on the rows x with their own trajectories: each
    output's distance from the plain version evaluated in float64 (z and
    logdet; the 10 grads pulled back from seeded standard-normal cotangents,
    on the float32 plain version's step inputs), beside the float32 plain
    version's. Fails where the `wgmma` routes are further from it than the
    larger of the row tiles' distance and twice the float32 plain version's.
    Prints each output's share of that bar, and K2a's distance from the row
    tiles (where the two sum in the same order, their outputs tie). Returns
    the worst share. Launches here are not counted (the counts are
    restored)."""
    import torch

    from bcnf_tpu_torch.ops import flow_kernel as fk

    counters = (fk.fused_flow_train_fwd, fk.fused_flow_train_bwd)
    saved = [(c.launches, dict(c.mode_launches), dict(c.route_launches)) for c in counters]
    saved_prep = fk.prepare_train_weights.launches, dict(fk.prepare_train_weights.pass_launches)
    with torch.no_grad():
        kargs, hp = model._fused_flow_args(weights, model.encode(weights, (traj,)))
        args = [kargs[n].detach() for n in TRAIN_ARGS]
        z, ld, bound = fk.fused_flow_train_reference(x, hp, *args)
        dz, dld = randn_cotangents(z)
        f64 = [t.double() for t in args]
        ref64 = (*fk.fused_flow_train_reference(x.double(), hp.double(), *f64)[:2],
                 *fk.fused_flow_train_backward_reference(bound.double(), hp.double(), dz.double(), dld.double(), *f64))
        outs = {"float32 plain": (z, ld, *fk.fused_flow_train_backward_reference(bound, hp, dz, dld, *args)),
                "wgmma": (*fk.fused_flow_train_fwd(x, hp, *args)[:2], *fk.fused_flow_train_bwd(bound, hp, dz, dld, *args))}
        with train_row_tiles():
            outs["row tiles"] = (*fk.fused_flow_train_fwd(x, hp, *args)[:2],
                                 *fk.fused_flow_train_bwd(bound, hp, dz, dld, *args))
        torch.cuda.synchronize()
    for c, (n, modes, routes) in zip(counters, saved):
        c.launches = n
        c.mode_launches.clear()
        c.mode_launches.update(modes)
        c.route_launches.clear()
        c.route_launches.update(routes)
    fk.prepare_train_weights.launches = saved_prep[0]
    fk.prepare_train_weights.pass_launches.clear()
    fk.prepare_train_weights.pass_launches.update(saved_prep[1])
    worst, lines, faults = 0.0, [], []
    for i, name in enumerate(("z", "logdet", *GRAD_NAMES)):
        d = {k: (v[i].double() - ref64[i]).abs().max().item() for k, v in outs.items()}
        bar = max(d["row tiles"], 2 * d["float32 plain"])
        worst = max(worst, d["wgmma"] / bar)
        lines.append(f"{name} {d['wgmma']:.4e}/{d['row tiles']:.4e}/{d['float32 plain']:.4e} "
                     f"({d['wgmma'] / bar:.4f})")
        if not d["wgmma"] <= bar:
            faults.append(f"{name} {d['wgmma']:.4e} past {bar:.4e}")
    ties = [(outs["wgmma"][i] - outs["row tiles"][i]).abs().max().item() for i in range(2)]
    print(f"    3xTF32 K2a/K2b against the plain version in float64, {what}, {x.shape[0]} rows (wgmma / row tiles / "
          f"float32 plain (share of the bar)): {'; '.join(lines)}; the wgmma routes at most {worst:.4f} of "
          f"max(row tiles, twice the float32 plain version); K2a's z and logdet from the row tiles' max|d| "
          f"{ties[0]:.3e}, {ties[1]:.3e}")
    if faults:
        fail(f"the 3xTF32 wgmma training routes on {what}: " + "; ".join(faults))
    return worst


def check_train_kernels(model, k_params: dict, rng, dev) -> None:
    """Phase 5: K2a and K2b (3xTF32, on their `wgmma` routes at the
    flagship's Hp 544) against their plain versions at the flagship widths,
    on B = 4096 and a ragged B = 4099 (rows with their own conditions), fed
    standard-normal cotangents: against the float32 plain version and the
    plain 3xTF32 version (`mm=matmul_3xtf32`), each at the bars (K2a's z,
    logdet and step inputs 1e-4, K2b's grads `check_grads`); two calls equal
    to the bit; each launched on its `wgmma` route; then against the plain
    version in float64 beside the row tiles forced (`train_pair_margin`).
    Launches here do not count."""
    import numpy as np
    import torch

    from bcnf_tpu_torch.ops.flow_kernel import (
        ROUTE_FWD_WGMMA,
        ROUTE_WGMMA,
        fused_flow_train_backward_reference,
        fused_flow_train_bwd,
        fused_flow_train_fwd,
        fused_flow_train_reference,
    )
    from bcnf_tpu_torch.ops.tf32 import matmul_3xtf32

    saved = fused_flow_train_fwd.launches, fused_flow_train_bwd.launches
    routes = fused_flow_train_fwd.route_launches[ROUTE_FWD_WGMMA], fused_flow_train_bwd.route_launches[ROUTE_WGMMA]
    print(f"[5 training kernels] K2a vs plain at the flagship widths, B=4096 and ragged B=4099; K2b vs plain, "
          f"10 grads from standard-normal cotangents (bar |d| <= min({GRAD_ATOL:g}, "
          f"{GRAD_REL:g} max|plain|) + {GRAD_RTOL:g}|plain|); both on their 3xTF32 wgmma routes, against the float32 "
          f"plain version and the plain 3xTF32 version:")
    fwd_err, fwd3_err, bwd_err, bwd3_err = 0.0, 0.0, 0.0, 0.0
    for B in (4096, 4099):
        traj = torch.from_numpy(rng.normal(size=(B, 30, 3)).astype(np.float32)).to(dev)
        with torch.no_grad():
            kargs, h_proj = model._fused_flow_args(k_params, model.encode(k_params, (traj,)))
            args = [kargs[n] for n in TRAIN_ARGS]
            x = torch.from_numpy(rng.normal(size=(B, model.size)).astype(np.float32)).to(dev)
            out_k = fused_flow_train_fwd(x, h_proj, *args)
            again = fused_flow_train_fwd(x, h_proj, *args)
            z, ld, bound = fused_flow_train_reference(x, h_proj, *args)
            three = fused_flow_train_reference(x, h_proj, *args, mm=matmul_3xtf32)
            fwd_err = max([fwd_err] + [(a - b).abs().max().item() for a, b in zip(out_k, (z, ld, bound))])
            fwd3_err = max([fwd3_err] + [(a - b).abs().max().item() for a, b in zip(out_k, three)])
            dz, dld = randn_cotangents(z)
            grads_k = fused_flow_train_bwd(bound, h_proj, dz, dld, *args)
            grads_again = fused_flow_train_bwd(bound, h_proj, dz, dld, *args)
            grads_p = fused_flow_train_backward_reference(bound, h_proj, dz, dld, *args)
            grads_3 = fused_flow_train_backward_reference(bound, h_proj, dz, dld, *args, mm=matmul_3xtf32)
            torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip((*out_k, *grads_k), (*again, *grads_again))):
            fail(f"K2a/K2b at B={B}: two calls on the same inputs differ")
        bwd_err = max(bwd_err, check_grads(f"K2b B={B}", GRAD_NAMES, grads_k, grads_p))
        bwd3_err = max(bwd3_err, check_grads(f"K2b B={B} vs plain 3xTF32", GRAD_NAMES, grads_k, grads_3))
    if fused_flow_train_fwd.launches != saved[0] + 4 or fused_flow_train_bwd.launches != saved[1] + 4:
        fail("the training kernels did not count their launches")
    moved = (fused_flow_train_fwd.route_launches[ROUTE_FWD_WGMMA] - routes[0],
             fused_flow_train_bwd.route_launches[ROUTE_WGMMA] - routes[1])
    if moved != (4, 4):
        fail(f"K2a/K2b ran {moved} times on their 3xTF32 wgmma routes, not 4 each")
    fused_flow_train_fwd.launches, fused_flow_train_bwd.launches = saved
    fused_flow_train_fwd.route_launches[ROUTE_FWD_WGMMA], fused_flow_train_bwd.route_launches[ROUTE_WGMMA] = routes
    print(f"    K2a max|d| over z, logdet, step inputs {fwd_err:.3e} vs float32 plain, {fwd3_err:.3e} vs plain 3xTF32 "
          f"(tolerance {KERNEL_TOL:g}); K2b max|d| over the 10 grads {bwd_err:.3e} / {bwd3_err:.3e}; two calls of "
          f"each equal to the bit")
    if not (fwd_err <= KERNEL_TOL and fwd3_err <= KERNEL_TOL):
        fail(f"K2a disagrees with its plain versions: {fwd_err:.3e} / {fwd3_err:.3e} > {KERNEL_TOL:g}")
    x = torch.from_numpy(rng.normal(size=(4096, model.size)).astype(np.float32)).to(dev)
    traj = torch.from_numpy(rng.normal(size=(4096, 30, 3)).astype(np.float32)).to(dev)
    train_pair_margin(model, k_params, x, traj, "the flagship's random weights")


def _flagship_train_config(batch_size: int, n_epochs: int) -> dict:
    """The flagship's run config with coupling dropout 0 (so the training
    kernels' gate is open, as bench.py's flagship has it)."""
    from bcnf_tpu_torch.config import load_config

    cfg = load_config(CONFIG).to_dict()
    cfg["model"]["kwargs"]["dropout"] = 0.0
    cfg["training"].update(batch_size=batch_size, n_epochs=n_epochs, timeout=None)
    return cfg


def train_counts() -> dict:
    """The training kernels' launches: K2a and K2b by route and by mode, and
    the hidden weights' preparations by passes."""
    from bcnf_tpu_torch.ops.flow_kernel import fused_flow_train_bwd, fused_flow_train_fwd, prepare_train_weights

    return {"K2a": dict(fused_flow_train_fwd.route_launches), "K2b": dict(fused_flow_train_bwd.route_launches),
            "K2a modes": dict(fused_flow_train_fwd.mode_launches), "K2b modes": dict(fused_flow_train_bwd.mode_launches),
            "prepared": dict(prepare_train_weights.pass_launches)}


def zero_train_counts() -> None:
    from bcnf_tpu_torch.ops.flow_kernel import fused_flow_train_bwd, fused_flow_train_fwd, prepare_train_weights

    for fn in (fused_flow_train_fwd, fused_flow_train_bwd):
        fn.launches = 0
        fn.route_launches.clear()
        fn.mode_launches.clear()
    prepare_train_weights.launches = 0
    prepare_train_weights.pass_launches.clear()


def train_main_path(rng, dev, peaks: tuple[float, float, float]) -> list[dict]:
    """Phase 6: the training main path on the full flagship at float32: K2a
    and K2b in 3xTF32 on their `wgmma` routes, then the same runs with the
    row tiles forced beside them; returns the kernel table's rows: K2a and
    K2b on `wgmma`, the row tiles beside them, and the hi/lo weight
    preparation."""
    import numpy as np
    import torch

    from bcnf_tpu_torch.bridge import map_tree, tree_leaves
    from bcnf_tpu_torch.models import CondRealNVP
    from bcnf_tpu_torch.ops import _build
    from bcnf_tpu_torch.ops import flow_kernel as fk
    from bcnf_tpu_torch.ops.flow_kernel import (
        BWD_ACTNORM,
        BWD_ROWS,
        BWD_WEIGHT_GRADS,
        ROUTE_FWD_WGMMA,
        ROUTE_ROWS,
        ROUTE_WGMMA,
        _train_bwd_parts,
        fused_flow,
        fused_flow_train,
        fused_flow_train_backward_reference,
        fused_flow_train_bwd,
        fused_flow_train_fwd,
        fused_flow_train_reference,
        prepare_train_weights,
        prepare_train_weights_reference,
    )
    from bcnf_tpu_torch.train import Trainer, make_optimizer
    from bcnf_tpu_torch.utils.misc import inn_nll_loss

    def trainable(p):
        return map_tree(lambda t: t.detach().clone().requires_grad_(True), p)

    launches = {"K2a": 0, "K2b": 0, "prep": 0}
    rates, plain_rates, tile_rates, shapes = {}, {}, {}, None
    for B, n_epochs in ((4096, 2), (256, 1)):
        cfg = _flagship_train_config(B, n_epochs)
        model = CondRealNVP.from_config(cfg)
        n = int(round(3 * B / (1 - cfg["training"]["validation_split"])))  # 3 training batches an epoch
        y = rng.normal(size=(n, model.size)).astype(np.float32)  # random y and trajectories, as bench.py
        traj = rng.normal(size=(n, 30, 3)).astype(np.float32)
        params0 = model.init(torch.Generator().manual_seed(SEED), device=dev)
        steps = 3 * n_epochs
        runs = {}
        for side in ("wgmma", "row tiles"):  # the same run, then with the row tiles forced
            trainer = Trainer(cfg, data=(y, [traj]), device=dev, seed=SEED)
            torch.cuda.synchronize()
            zero_train_counts()
            zero_flow_counts()
            t0 = time.perf_counter()
            with train_row_tiles() if side == "row tiles" else contextlib.nullcontext():
                trained = trainer.train(model, map_tree(lambda t: t.detach().clone(), params0))
            torch.cuda.synchronize()
            hist = trainer.meta_scheduler.parameter_history
            runs[side] = (time.perf_counter() - t0, train_counts(), dict(fused_flow.route_launches),
                          [v for _, v in hist["train_loss"]] + [v for _, v in hist["val_loss"]], trained, trainer)
        t_train, counts, k1, losses, trained, trainer = runs["wgmma"]
        k2a, k2b = sum(counts["K2a"].values()), sum(counts["K2b"].values())
        launches["K2a"] += k2a
        launches["K2b"] += k2b
        launches["prep"] += steps
        # the hidden weights prepared once a step, and once a validation call of K1's 3xTF32 wgmma forward
        # (which prepares its own at every call)
        want = {"K2a": {ROUTE_FWD_WGMMA: steps}, "K2b": {ROUTE_WGMMA: steps}, "K2a modes": {"3xtf32": steps},
                "K2b modes": {"3xtf32": steps}, "prepared": {3: steps + k1.get(ROUTE_FWD_WGMMA, 0)}}
        if counts != want:
            fail(f"Trainer.train at batch {B} counted {counts} for {steps} steps, not {want}")
        tile_counts = runs["row tiles"][1]
        if (tile_counts["K2a"], tile_counts["K2b"], tile_counts["prepared"], set(runs["row tiles"][2])) != (
                {ROUTE_ROWS: steps}, {ROUTE_ROWS: steps}, {}, {ROUTE_ROWS}):
            fail(f"Trainer.train at batch {B} with the row tiles forced counted {tile_counts}")
        if not (np.all(np.isfinite(losses)) and all(torch.isfinite(t).all() for t in tree_leaves(trained))):
            fail(f"Trainer.train at batch {B} gave non-finite losses or params: {losses}")
        tile_losses = runs["row tiles"][3]
        loss_d = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(losses, tile_losses))
        if len(losses) != len(tile_losses) or not loss_d <= KERNEL_TOL:
            fail(f"Trainer.train at batch {B}: the wgmma routes' losses {losses} and the row tiles' {tile_losses} "
                 f"differ by {loss_d:.3e} (bar {KERNEL_TOL:g} of max(1, |loss|))")

        # train samples/s: training steps alone, host clock around synchronised work
        params = trainable(trained)
        opt = make_optimizer("Adam", lr=2e-4).init(params)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        yb = torch.from_numpy(y[:B]).to(dev)
        cb = [torch.from_numpy(traj[:B]).to(dev)]
        saved = fused_flow_train_fwd.launches, fused_flow_train_bwd.launches
        trainer.train_step(model, [params], opt, yb, cb, [gen])
        torch.cuda.synchronize()
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            metrics = trainer.train_step(model, [params], opt, yb, cb, [gen])
        torch.cuda.synchronize()
        rates[B] = reps * B / (time.perf_counter() - t0)
        # the same steps on the row tiles, then with the kernel gate closed: the plain autograd composition
        with train_row_tiles():
            trainer.train_step(model, [params], opt, yb, cb, [gen])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                trainer.train_step(model, [params], opt, yb, cb, [gen])
            torch.cuda.synchronize()
            tile_rates[B] = reps * B / (time.perf_counter() - t0)
        model.use_pallas = False
        trainer.train_step(model, [params], opt, yb, cb, [gen])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            trainer.train_step(model, [params], opt, yb, cb, [gen])
        torch.cuda.synchronize()
        plain_rates[B] = reps * B / (time.perf_counter() - t0)
        model.use_pallas = True
        print(f"[6 training, batch {B}] Trainer.train at float32: {n_epochs} epoch(s) x 3 steps + validation in "
              f"{t_train:.2f} s; launches {counts}, K1 (validation) {k1} (each K1 call prepares its own weights); "
              f"losses "
              f"{', '.join(f'{v:.5f}' for v in losses)}; with the row tiles forced ({runs['row tiles'][0]:.2f} s, "
              f"launches {tile_counts['K2a']} / {tile_counts['K2b']}): losses within {loss_d:.2e} of max(1, |loss|); "
              f"{rates[B]:.0f} train samples/s through the wgmma routes, {tile_rates[B]:.0f} through the row tiles "
              f"({rates[B] / tile_rates[B]:.3f}x), {plain_rates[B]:.0f} with the gate closed (plain autograd) (last "
              f"step loss {metrics[0].item():.3f})")
        if B != 4096:
            fused_flow_train_fwd.launches, fused_flow_train_bwd.launches = saved
            continue

        # one step's forward and backward through the kernels against the
        # plain autograd ones on the same batch: the NLL's value, and the
        # grads of every param pulled back from standard-normal cotangents
        losses, grads, used = [], [], []
        for use_kernels in (True, False):
            model.use_pallas = use_kernels
            p = trainable(trained)
            before = fused_flow_train_fwd.launches + fused_flow_train_bwd.launches
            z, ld = model.forward(p, yb, *cb, train=True)
            dz, dld = randn_cotangents(z)
            ((z * dz).sum() + (ld * dld).sum()).backward()
            used.append(fused_flow_train_fwd.launches + fused_flow_train_bwd.launches - before)
            losses.append(inn_nll_loss(z, ld).item())
            grads.append([t.grad for t in tree_leaves(p)])
        model.use_pallas = True
        if used != [2, 0]:
            fail(f"the step check launched the training kernels {used} times (kernel side, plain side)")
        loss_k, loss_p = losses
        worst, max_d, mags = -1.0, 0.0, []
        for a, b in zip(*grads):
            if a is not None and b is not None:
                d, excess, mag = grad_excess(a, b)
                worst, max_d = max(worst, excess), max(max_d, d)
                mags.append(mag)
        loss_d = abs(loss_k - loss_p)
        print(f"    step through K2a/K2b vs plain autograd step (batch {B}): loss {loss_k:.5f} vs {loss_p:.5f}; "
              f"{len(mags)} param grads from standard-normal cotangents, max|d| {max_d:.3e} (bar |d| <= "
              f"min({GRAD_ATOL:g}, {GRAD_REL:g} max|plain|) + {GRAD_RTOL:g}|plain|), max|plain| per grad from {min(mags):.3e} to {max(mags):.3e}")
        if not loss_d <= KERNEL_TOL * max(1.0, abs(loss_p)) or worst > 0:
            fail(f"the kernels' training step disagrees with the plain one: loss |d| {loss_d:.3e}, "
                 f"grads {worst:.3e} past the bar")

        # CUDA-event split of one step: the same calls as Trainer.train_step
        splits = []
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
            opt.zero_grad()
            ev[0].record()
            h = model.encode(params, cb, gen, train=True)
            ev[1].record()
            kargs, h_proj = model._fused_flow_args(params, h)
            ev[2].record()
            z, ld = fused_flow_train(yb, h_proj, *[kargs[k] for k in TRAIN_ARGS])
            ev[3].record()
            loss = inn_nll_loss(z, ld)
            ev[4].record()
            loss.backward()
            ev[5].record()
            opt.step()
            ev[6].record()
            torch.cuda.synchronize()
            splits.append([ev[i].elapsed_time(ev[i + 1]) for i in range(6)])
        split = [sorted(c)[1] for c in zip(*splits)]
        shapes = (yb.detach(), h_proj.detach(), [kargs[k].detach() for k in TRAIN_ARGS], model)
        copies = weight_copies_ms(model, params, dev)
        device_profile(lambda: trainer.train_step(model, [params], opt, yb, cb, [gen]))
        fused_flow_train_fwd.launches, fused_flow_train_bwd.launches = saved

    # K2a/K2b at the main path's batch-4096 inputs, on their wgmma routes and on
    # the row tiles forced: plain versions, bits, times, parts, bound, layout
    x, h_proj, args, model = shapes
    H = model.nested_sizes[0]
    named = dict(zip(TRAIN_ARGS, args))
    B, Hp, size, d_a, nh = x.shape[0], h_proj.shape[-1], x.shape[1], named["w1y"].shape[1], named["wm"].shape[1]
    S = h_proj.shape[0]
    saved = train_counts()
    with torch.no_grad():
        ws = prepare_train_weights(named["wm"], passes=3)
        z, ld, bound = fused_flow_train_fwd(x, h_proj, *args, wstages=ws)
        z_r, ld_r, bound_r = fused_flow_train_reference(x, h_proj, *args)
        fwd_err = max((a - b).abs().max().item() for a, b in zip((z, ld, bound), (z_r, ld_r, bound_r)))
        dz, dld = randn_cotangents(z)
        grads_k = fused_flow_train_bwd(bound, h_proj, dz, dld, *args, wstages=ws)
        grads_p = fused_flow_train_backward_reference(bound, h_proj, dz, dld, *args)
        with train_row_tiles():
            tiles_fwd = fused_flow_train_fwd(x, h_proj, *args)
            tiles_bwd = fused_flow_train_bwd(bound, h_proj, dz, dld, *args)
        if not fwd_err <= KERNEL_TOL:
            fail(f"K2a at the main path's inputs disagrees with plain: {fwd_err:.3e} > {KERNEL_TOL:g}")
        tiles_fwd_err = max((a - b).abs().max().item() for a, b in zip(tiles_fwd, (z_r, ld_r, bound_r)))
        if not tiles_fwd_err <= KERNEL_TOL:
            fail(f"K2a's row tiles at the main path's inputs disagree with plain: {tiles_fwd_err:.3e} > {KERNEL_TOL:g}")
        print(f"    K2a/K2b at the main path's batch-{B} inputs: K2a max|d| {fwd_err:.3e} (row tiles "
              f"{tiles_fwd_err:.3e}); K2b (wgmma, then the row tiles):")
        bwd_err = check_grads("K2b main path", GRAD_NAMES, grads_k, grads_p)
        tiles_bwd_err = check_grads("K2b main path, row tiles", GRAD_NAMES, tiles_bwd, grads_p)
        p_times = {"K2a": cuda_ms(lambda: fused_flow_train_reference(x, h_proj, *args), reps=3),
                   "K2b": cuda_ms(lambda: fused_flow_train_backward_reference(bound, h_proj, dz, dld, *args), reps=3)}
        times, part_ms = {}, {}
        outs = tuple(torch.empty_like(t) for t in grads_k)
        for side in ("wgmma", "row tiles", "row tiles", "wgmma"):  # in turns
            w = ws if side == "wgmma" else None
            with train_row_tiles() if side == "row tiles" else contextlib.nullcontext():
                times.setdefault(("K2a", side), []).extend(
                    cuda_ms(lambda: fused_flow_train_fwd(x, h_proj, *args, wstages=w), reps=3))
                times.setdefault(("K2b", side), []).extend(
                    cuda_ms(lambda: fused_flow_train_bwd(bound, h_proj, dz, dld, *args, wstages=w), reps=3))
                for part, bits in (("rows", BWD_ROWS), ("weight grads", BWD_WEIGHT_GRADS), ("rest", BWD_ACTNORM)):
                    part_ms.setdefault((part, side), []).extend(cuda_ms(
                        lambda: _train_bwd_parts(bound, h_proj, dz, dld, named, outs, bits, fk.MODE_3XTF32, w), reps=3))
        ws_plain = prepare_train_weights_reference(named["wm"], passes=3)
        if not torch.equal(ws.view(torch.int32), ws_plain.view(torch.int32)):
            fail("the 3xTF32 weight preparation on the card differs from its plain version")
        prep_times = cuda_ms(lambda: prepare_train_weights(named["wm"], passes=3), reps=5)
        prep_plain = cuda_ms(lambda: prepare_train_weights_reference(named["wm"], passes=3), reps=3)
        del ws_plain
    zero_train_counts()
    for fn, key in ((fused_flow_train_fwd, "K2a"), (fused_flow_train_bwd, "K2b")):
        fn.route_launches.update(saved[key])
        fn.mode_launches.update(saved[key + " modes"])
        fn.launches = sum(saved[key].values())
    prepare_train_weights.pass_launches.update(saved["prepared"])
    prepare_train_weights.launches = sum(saved["prepared"].values())
    part_ms = {k: median(v) for k, v in part_ms.items()}
    work = dict(zip(("K2a", "K2b"), train_work(named, h_proj, B, H)))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks, resident, gw_blocks, gw_per_sm = fk.train_bwd_wgmma_layout(Hp, size, d_a, nh, B, fk.MODE_3XTF32)
    ring, smem, fblocks, fresident = fk.fwd_wgmma_card_layout(Hp, size, d_a, B, fk.MODE_3XTF32)
    tile_blocks = -(-B // (32 if Hp <= 32 * 17 else 16))  # the rows kernels' tiles (csrc/flow_rows.cuh)
    layouts = {
        ("K2a", "wgmma"): f"{fblocks} blocks in clusters of 2, {fresident} clusters resident: "
                          f"{fblocks / 2 / fresident:.2f} waves; a {ring}-stage ring of one k-step's hi and lo, "
                          f"{smem} bytes of shared memory",
        ("K2b", "wgmma"): f"rows kernel {blocks} blocks in clusters of 2, {resident} clusters resident: "
                          f"{blocks / 2 / resident:.2f} waves; weight-grad pass {gw_blocks} blocks, {gw_per_sm} an SM: "
                          f"{gw_blocks / (gw_per_sm * sms):.2f} waves",
    }
    for kernel in ("K2a", "K2b"):
        layouts[(kernel, "row tiles")] = f"{tile_blocks} blocks of 32 rows, one an SM: {tile_blocks / sms:.2f} waves"
    for lib, marks in (("flow_fwd_wgmma", ("<17,",)), ("flow_train_wgmma", ("bwd_rows_wgmma<17>", "dwm_wgmma<17>"))):
        kernel = "?"
        for line in _build.build_logs.get(lib, "").splitlines():
            if "Compiling entry function" in line:
                kernel = kernel_label(line)
            elif ("registers" in line or "spill" in line) and any(m in kernel for m in marks):
                print(f"    ptxas {lib} {kernel}: {line.strip().removeprefix('ptxas info    : ')}")
    rows = []
    for name, side, err, src, replaces, fn in (
        ("K2a[3xtf32]", "wgmma", fwd_err, "flow_fwd_wgmma.cu", "bcnf_tpu/ops/flow_kernel.py:558", "fused_flow_train_fwd"),
        ("K2b[3xtf32]", "wgmma", bwd_err, "flow_train_wgmma.cu", "bcnf_tpu/ops/flow_kernel.py:600",
         "fused_flow_train_bwd"),
        ("K2a[3xtf32, row tiles]", "row tiles", tiles_fwd_err, "flow_kernel.cu", "bcnf_tpu/ops/flow_kernel.py:558",
         "fused_flow_train_fwd"),
        ("K2b[3xtf32, row tiles]", "row tiles", tiles_bwd_err, "flow_train_kernel.cu",
         "bcnf_tpu/ops/flow_kernel.py:600", "fused_flow_train_bwd"),
    ):
        kernel = name[:3]
        k_times = times[(kernel, side)]
        flops = work[kernel][0]
        rows.append(kernel_row(f"{name} {fn}", "bcnf_tpu_torch/ops/csrc/" + src, replaces,
                               launches[kernel] if side == "wgmma" else 0, err, k_times, p_times[kernel], work[kernel],
                               peaks, None, ARITH_3XTF32))
        ms, plain_ms, bound = rows[-1]["ms"], rows[-1]["plain_ms"], rows[-1]["bound_ms"]
        fma_bound = bound_ms(work[kernel], peaks, ARITH_FMA)[0]
        parts = ""
        if kernel == "K2b":
            rows[-1]["parts_ms"] = {p: part_ms[(p, side)] for p in ("rows", "weight grads", "rest")}
            parts = (f"; parts alone: {S} rows kernels {part_ms[('rows', side)]:.2f}, {S} weight-grad passes "
                     f"{part_ms[('weight grads', side)]:.2f}, the rest {part_ms[('rest', side)]:.2f}")
        print(f"    {name} ({src}) rows {B}: {ms:.2f} ms ({flops / ms / 1e9:.1f} TFLOP/s; bound {bound:.2f} ms "
              f"({rows[-1]['bound_by']}), float32-FMA bound {fma_bound:.2f} ms; median of {len(k_times)} in turns, "
              f"range {min(k_times):.2f}-{max(k_times):.2f}), plain {plain_ms:.2f} ms; max|d| vs plain {err:.2e}"
              f"{parts}; {layouts[(kernel, side)]}")
    w_bytes = 4.0 * named["wm"].numel()
    prep_row = kernel_row("K2b[3xtf32] prepare_train_weights", "bcnf_tpu_torch/ops/csrc/flow_train_wgmma.cu",
                          "bcnf_tpu/ops/flow_kernel.py:600", launches["prep"], 0.0, prep_times, prep_plain,
                          (0.0, 5 * w_bytes), peaks, None, ARITH_3XTF32)
    print(f"    the hi/lo weight preparation (prepare_kernel, 3 passes: both directions' hi and lo, once a step, "
          f"{launches['prep']} on the main path; equal to its plain version to the bit): {prep_row['ms']:.3f} ms, "
          f"bound {prep_row['bound_ms']:.3f} ms ({prep_row['bound_by']}: {5 * w_bytes / 1e6:.0f} MB), plain "
          f"{prep_row['plain_ms']:.3f} ms")
    for kernel in ("K2a", "K2b"):
        wg, tiles = median(times[(kernel, "wgmma")]), median(times[(kernel, "row tiles")])
        print(f"    {kernel} 3xTF32: wgmma {wg:.3f} ms against the row tiles' {tiles:.3f} ms on the same inputs "
              f"({tiles / wg:.2f}x)")
        if not wg < tiles:
            fail(f"{kernel}'s 3xTF32 wgmma route ({wg:.3f} ms) is not faster than the row tiles ({tiles:.3f} ms) at "
                 f"the flagship's batch-{B} inputs")
    rows.append(prep_row)
    k2b_ms = rows[1]["ms"]
    print(f"    step split at batch 4096 (CUDA events, median of 3, ms): encoder forward {split[0]:.2f}, "
          f"condition projections + stacking {split[1]:.2f}, K2a with the weight preparation {split[2]:.2f}, loss "
          f"{split[3]:.2f}, backward {split[4]:.2f} (K2b alone {k2b_ms:.2f}, so the rest of autograd "
          f"~{split[4] - k2b_ms:.2f}), clip + Adam {split[5]:.2f}; step {sum(split):.2f} = "
          f"{4096 / sum(split) * 1e3:.0f} samples/s")
    print(f"    per-step weight copies (stack_flow_params + pad_hidden, {copies[2] / 1e6:.0f} MB of kernel "
          f"arguments; CUDA events, median of 5): forward {copies[0]:.2f} ms, its backward (grads sliced back "
          f"to the param tree) {copies[1]:.2f} ms")
    print(f"    train samples/s at float32: {rates[4096]:.0f} at batch 4096, {rates[256]:.0f} at batch 256 on the "
          f"wgmma routes; {tile_rates[4096]:.0f} and {tile_rates[256]:.0f} on the row tiles "
          f"({rates[4096] / tile_rates[4096]:.3f}x, {rates[256] / tile_rates[256]:.3f}x); with the gate closed "
          f"(plain autograd): {plain_rates[4096]:.0f} and {plain_rates[256]:.0f}")
    return rows


def _strict_f64(x, h_proj, args: list, dz, dld) -> tuple:
    """The strict K2a's and K2b's plain versions in float64 on the card, on
    the float32 inputs cast: (z, logdet, bound), then the 10 grads."""
    from bcnf_tpu_torch.ops.flow_kernel import fused_flow_train_backward_reference, fused_flow_train_reference

    a64 = [t.double() for t in args]
    out = fused_flow_train_reference(x.double(), h_proj.double(), *a64)
    return out, fused_flow_train_backward_reference(out[2], h_proj.double(), dz.double(), dld.double(), *a64)


def _rel_from(got, ref) -> float:
    """The largest of each output's max |got - ref| over its max |ref|."""
    return max((g.double() - r).abs().max().item() / max(r.abs().max().item(), 1e-30) for g, r in zip(got, ref))


def strict_training(model, k_params: dict, rng, dev, peaks: tuple[float, float, float]) -> list[dict]:
    """Phase 6b: strict training (`pallas_strict`, K2a and K2b in float32
    FMA: csrc/flow_fma.cu's `fma_flow_train_kernel`, csrc/flow_train_fma.cu).
    (a) Both at the flagship's widths on B = 4096 and a ragged 4099 against
    their plain versions (TF32 off), each on the plain version's inputs: K2a
    (z, logdet, the step inputs, and what it keeps for K2b against
    `train_keep_reference`) within KERNEL_TOL; K2b on the plain step inputs
    and the plain keep at the grad bar; each no further from the plain
    version in float64 than twice the float32 plain version (K2a over z,
    logdet and the step inputs; K2b over its grads, each relative to its
    largest value); each equal to the bit between two calls; and the chain,
    K2b on K2a's step inputs and keep, at the grad bar. (b) The flagship
    built with `pallas_strict` at dropout 0:
    `Trainer.train` for 3 steps at batch 4096, counts zeroed before and read
    after (K2a and K2b 3 each, all float32 FMA on the FMA route, nothing of
    another mode); one step through the kernels against the plain float32
    autograd step; train samples/s both ways. (c) Their times at the main
    path's inputs beside their bounds (the work each does: K2a writes the
    keep, K2b reads it and recomputes nothing) and plain versions, K2b's
    parts, the keep's and the scratch's bytes beside the card's memory, and
    the strict step's peak memory; ptxas's registers and spill bytes of each
    `fma_flow_train_kernel<TN>`. (d) The strict backward in row chunks: at
    4096 rows none (`strict_chunks`), and forced into chunks of 1024 (K2a
    again a chunk into a chunk's keep, then K2b on the chunk) against the
    whole batch's on K2a's step inputs and keep: dx and dh_proj equal to the
    bit, every grad no further from float64 than twice the float32 plain
    version, equal between calls, launches exact; then the strict
    flagship's training step at 65,536 rows (past what one keep holds on an
    80 GB card): its chunks' launches and its peak memory beside the card's.
    Returns the "K2a, strict" and "K2b, strict" rows of the kernel table."""
    import numpy as np
    import torch

    from bcnf_tpu_torch.bridge import map_tree, tree_leaves
    from bcnf_tpu_torch.models import CondRealNVP
    from bcnf_tpu_torch.ops.flow_kernel import (
        BWD_ROWS,
        BWD_WEIGHT_GRADS,
        MODE_FMA,
        ROUTE_FMA,
        _train_bwd_parts,
        fma_card_layout,
        fma_keep_floats,
        fma_train_card_layout,
        fma_train_scratch_floats,
        fused_flow_train_backward_reference,
        fused_flow_train_bwd,
        fused_flow_train_fwd,
        fused_flow_train_reference,
        row_chunks,
        strict_chunks,
        train_keep,
        train_keep_reference,
    )
    from bcnf_tpu_torch.train import Trainer, make_optimizer
    from bcnf_tpu_torch.utils.misc import inn_nll_loss

    counters = (fused_flow_train_fwd, fused_flow_train_bwd)

    def counts() -> list[tuple[int, dict, dict]]:
        return [(c.launches, dict(c.mode_launches), dict(c.route_launches)) for c in counters]

    def zero() -> None:
        for c in counters:
            c.launches = 0
            c.mode_launches.clear()
            c.route_launches.clear()

    def restore(found: list) -> None:  # the counts as this phase found them
        for c, (n_l, modes, routes) in zip(counters, found):
            c.launches = n_l
            c.mode_launches.clear()
            c.mode_launches.update(modes)
            c.route_launches.clear()
            c.route_launches.update(routes)

    saved = counts()
    # (a) the kernels against their plain versions, float32 and float64
    print("[6b strict training: kernels] K2a and K2b in float32 FMA at the flagship widths, B=4096 and ragged "
          "B=4099, against their plain versions (TF32 off) and the plain versions in float64:")
    fwd_err, bwd_err = 0.0, 0.0
    cases = {}  # each batch's inputs, step inputs, keep and cotangents, for (c) and (d)
    for B in (4096, 4099):
        traj = torch.from_numpy(rng.normal(size=(B, 30, 3)).astype(np.float32)).to(dev)
        with torch.no_grad():
            kargs, h_proj = model._fused_flow_args(k_params, model.encode(k_params, (traj,)))
            args = [kargs[n] for n in TRAIN_ARGS]
            x = torch.from_numpy(rng.normal(size=(B, model.size)).astype(np.float32)).to(dev)
            keep, again = (train_keep(x, h_proj, args[5], args[3].shape[1], MODE_FMA) for _ in range(2))
            one = fused_flow_train_fwd(x, h_proj, *args, mode=MODE_FMA, keep=keep)  # K2a keeping for K2b
            two = fused_flow_train_fwd(x, h_proj, *args, mode=MODE_FMA, keep=again)
            ref = fused_flow_train_reference(x, h_proj, *args)
            plain_keep = train_keep_reference(ref[2], h_proj, *args)
            dz, dld = randn_cotangents(ref[0])
            g1 = fused_flow_train_bwd(ref[2], h_proj, dz, dld, *args, mode=MODE_FMA, keep=plain_keep)
            g2 = fused_flow_train_bwd(ref[2], h_proj, dz, dld, *args, mode=MODE_FMA, keep=plain_keep)
            g_c = fused_flow_train_bwd(one[2], h_proj, dz, dld, *args, mode=MODE_FMA, keep=keep)  # the chain
            g_p = fused_flow_train_backward_reference(ref[2], h_proj, dz, dld, *args)
            out64, g64 = _strict_f64(x, h_proj, args, dz, dld)
            torch.cuda.synchronize()
        e = max((a - b).abs().max().item() for a, b in zip(one, ref))
        e_keep = (keep - plain_keep).abs().max().item()
        fwd_err = max(fwd_err, e, e_keep)
        bwd_err = max(bwd_err, check_grads(f"K2b strict B={B}", GRAD_NAMES, g1, g_p))
        check_grads(f"K2b strict B={B} on K2a's step inputs and keep", GRAD_NAMES, g_c, g_p)
        bits = (all(torch.equal(a, b) for a, b in zip((*one, keep), (*two, again)))
                and all(torch.equal(a, b) for a, b in zip(g1, g2)))
        f_k, f_p = _rel_from(one, out64), _rel_from(ref, out64)
        b_k, b_p = _rel_from(g1, g64), _rel_from(g_p, g64)
        print(f"    B={B}: K2a max|d| vs plain over z, logdet, step inputs {e:.3e}, over its keep {e_keep:.3e} "
              f"(tolerance {KERNEL_TOL:g}); from float64 (max |d| / max |ref| over the outputs): K2a {f_k:.3e}, "
              f"float32 plain {f_p:.3e}; K2b on the plain inputs and keep {b_k:.3e}, float32 plain {b_p:.3e} (bar: "
              f"twice the plain's); equal to the bit between two calls: {bits}")
        if not max(e, e_keep) <= KERNEL_TOL or not f_k <= 2 * f_p or not b_k <= 2 * b_p or not bits:
            fail(f"the strict K2a/K2b at B={B}: K2a {e:.3e} from plain, its keep {e_keep:.3e} (tolerance "
                 f"{KERNEL_TOL:g}); from float64 K2a {f_k:.3e} vs plain {f_p:.3e}, K2b {b_k:.3e} vs plain {b_p:.3e}; "
                 f"equal between calls: {bits}")
        cases[B] = (x, h_proj, args, one[2], keep, dz, dld, e, max((a - b).abs().max().item() for a, b in zip(g1, g_p)))
        del keep, again, plain_keep
    after = counts()
    if [a[0] - b[0] for a, b in zip(after, saved)] != [4, 6] or [a[1].get(MODE_FMA, 0) - b[1].get(MODE_FMA, 0)
                                                                 for a, b in zip(after, saved)] != [4, 6]:
        fail(f"the strict kernels' checks did not count 4 launches of K2a and 6 of K2b in float32 FMA: {after} "
             f"after {saved}")

    # (b) the flagship with pallas_strict: Trainer.train, counts zeroed before and read after
    cfg = _flagship_train_config(4096, 1)
    smodel = CondRealNVP.from_config(cfg)
    smodel.pallas_strict = True
    B = 4096
    n = int(round(3 * B / (1 - cfg["training"]["validation_split"])))
    y = rng.normal(size=(n, smodel.size)).astype(np.float32)
    traj = rng.normal(size=(n, 30, 3)).astype(np.float32)
    params0 = smodel.init(torch.Generator().manual_seed(SEED), device=dev)
    trainer = Trainer(cfg, data=(y, [traj]), device=dev, seed=SEED)
    torch.cuda.synchronize()
    zero()
    t0 = time.perf_counter()
    trained = trainer.train(smodel, params0)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    run = counts()
    hist = trainer.meta_scheduler.parameter_history
    losses = [v for _, v in hist["train_loss"]] + [v for _, v in hist["val_loss"]]
    want = (3, {MODE_FMA: 3}, {ROUTE_FMA: 3})
    if run != [want, want]:
        fail(f"Trainer.train of the strict flagship launched K2a, K2b as {run}, not 3 each in float32 FMA")
    if not (np.all(np.isfinite(losses)) and all(torch.isfinite(t).all() for t in tree_leaves(trained))):
        fail(f"Trainer.train of the strict flagship gave non-finite losses or params: {losses}")
    yb, cb = torch.from_numpy(y[:B]).to(dev), [torch.from_numpy(traj[:B]).to(dev)]
    step_losses, grads, used = [], [], []
    for kernels in (True, False):  # one step through the kernels, then plain float32 autograd (TF32 off)
        smodel.use_pallas = kernels
        p = map_tree(lambda t: t.detach().clone().requires_grad_(True), trained)
        before = fused_flow_train_fwd.launches + fused_flow_train_bwd.launches
        z, ld = smodel.forward(p, yb, *cb, train=True)
        dzs, dlds = randn_cotangents(z)
        ((z * dzs).sum() + (ld * dlds).sum()).backward()
        used.append(fused_flow_train_fwd.launches + fused_flow_train_bwd.launches - before)
        step_losses.append(inn_nll_loss(z, ld).item())
        grads.append([t.grad for t in tree_leaves(p)])
    smodel.use_pallas = True
    worst, max_d = -1.0, 0.0
    for a, b in zip(*grads):
        if a is not None and b is not None:
            d, excess, _ = grad_excess(a, b)
            worst, max_d = max(worst, excess), max(max_d, d)
    loss_d = abs(step_losses[0] - step_losses[1])
    rates = {}
    params = map_tree(lambda t: t.detach().clone().requires_grad_(True), trained)
    opt = make_optimizer("Adam", lr=2e-4).init(params)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for kernels in (True, False):
        smodel.use_pallas = kernels
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        trainer.train_step(smodel, [params], opt, yb, cb, [gen])
        torch.cuda.synchronize()
        if kernels:  # the strict step's own allocations at its peak, beyond what the phase already held
            step_gb = (torch.cuda.max_memory_allocated(dev) - held) / 1e9
        t0 = time.perf_counter()
        for _ in range(5):
            trainer.train_step(smodel, [params], opt, yb, cb, [gen])
        torch.cuda.synchronize()
        rates[kernels] = 5 * B / (time.perf_counter() - t0)
    smodel.use_pallas = True
    print(f"[6b strict training, batch {B}] Trainer.train of the flagship with pallas_strict (dropout 0): 1 epoch x 3 "
          f"steps + validation in {t_train:.2f} s; launches K2a {run[0][0]} {run[0][1]} {run[0][2]}, K2b {run[1][0]} "
          f"{run[1][1]} {run[1][2]}; losses {', '.join(f'{v:.3f}' for v in losses)}; a step through the strict "
          f"K2a/K2b vs the plain float32 autograd step: loss {step_losses[0]:.5f} vs {step_losses[1]:.5f}, grads "
          f"max|d| {max_d:.3e} (launches {used}); {rates[True]:.0f} train samples/s through the strict kernels, "
          f"{rates[False]:.0f} on plain float32 autograd (cuBLAS SGEMM)")
    if used != [2, 0] or not loss_d <= KERNEL_TOL * max(1.0, abs(step_losses[1])) or worst > 0:
        fail(f"the strict training step disagrees with the plain one: launches {used}, loss |d| {loss_d:.3e}, "
             f"grads {worst:.3e} past the bar")

    # (c) times at the main path's batch-4096 inputs
    x, h_proj, args, bound, keep, dz, dld, e_fwd, e_bwd = cases[4096]
    H = model.nested_sizes[0]
    with torch.no_grad():  # as the training step runs them: K2a keeping for K2b, K2b on that keep
        times = {
            "K2a": (cuda_ms(lambda: fused_flow_train_fwd(x, h_proj, *args, mode=MODE_FMA, keep=keep), reps=5),
                    cuda_ms(lambda: fused_flow_train_reference(x, h_proj, *args), reps=3)),
            "K2b": (cuda_ms(lambda: fused_flow_train_bwd(bound, h_proj, dz, dld, *args, mode=MODE_FMA, keep=keep),
                            reps=5),
                    cuda_ms(lambda: fused_flow_train_backward_reference(bound, h_proj, dz, dld, *args), reps=3)),
        }
        outs = tuple(torch.empty_like(t) for t in (dz, h_proj, *args[:2], *args[3:]))
        part_ms = {name: median(cuda_ms(lambda: _train_bwd_parts(bound, h_proj, dz, dld, dict(zip(TRAIN_ARGS, args)),
                                                                 outs, part, MODE_FMA, None, keep), reps=3))
                   for name, part in (("rows", BWD_ROWS), ("weight grads", BWD_WEIGHT_GRADS))}
    restore(saved)
    work = dict(zip(("K2a", "K2b"), train_work(dict(zip(TRAIN_ARGS, args)), h_proj, B, H, kept=True)))
    recompute = train_work(dict(zip(TRAIN_ARGS, args)), h_proj, B, H)[1]  # the function with the MLP recomputed
    S, Hp, d_a, nh = h_proj.shape[0], h_proj.shape[-1], args[3].shape[1], args[5].shape[1]
    layouts = {"K2a": fma_card_layout(B, Hp, model.size, d_a),
               "K2b": fma_train_card_layout(B, S, Hp, model.size, d_a, nh)}
    rows = []
    for name, err, src, replaces in (
        ("K2a", e_fwd, "bcnf_tpu_torch/ops/csrc/flow_fma.cu", "bcnf_tpu/ops/flow_kernel.py:558"),
        ("K2b", e_bwd, "bcnf_tpu_torch/ops/csrc/flow_train_fma.cu", "bcnf_tpu/ops/flow_kernel.py:600"),
    ):
        k_times, p_times = times[name]
        rows.append(kernel_row(f"{name}[fma] fused_flow_train_{'fwd' if name == 'K2a' else 'bwd'}", src, replaces,
                               run[0 if name == "K2a" else 1][0], err, k_times, p_times, work[name], peaks, None,
                               ARITH_FMA))
        r = rows[-1]
        print(f"    {name}, strict, rows {B} (layout: rows a lane, blocks, ring stages, floats a stage, smem "
              f"{layouts[name]}): {r['ms']:.2f} ms (float32-FMA bound {r['bound_ms']:.2f} ms, {r['bound_by']}; "
              f"{work[name][0] / 1e12:.3f} TFLOP -> {work[name][0] / r['ms'] / 1e9:.1f} TFLOP/s, median of "
              f"{len(k_times)}, range {min(k_times):.2f}-{max(k_times):.2f}), plain float32 {r['plain_ms']:.2f} ms; "
              f"max|d| vs plain {err:.2e}")
    k2b_ms = rows[1]["ms"]
    print(f"    K2b, strict, parts (CUDA events, median of 3, ms; layout above: the rows kernel's, then the "
          f"weight-grad pass's blocks): the rows kernel over {S} steps (with the transposed weights' copies) "
          f"{part_ms['rows']:.2f}, the weight-grad pass over {S} steps {part_ms['weight grads']:.2f}, the rest "
          f"{k2b_ms - part_ms['rows'] - part_ms['weight grads']:.2f}; the function with the MLP recomputed "
          f"(no keep) would be {recompute[0] / 1e12:.3f} TFLOP, {bound_ms(recompute, peaks, ARITH_FMA)[0]:.2f} ms "
          f"at the float32-FMA rate")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    keep_gb = 4 * fma_keep_floats(B, S, model.size, d_a, nh, Hp) / 1e9
    scratch_gb = 4 * fma_train_scratch_floats(B, S, model.size, d_a, nh, Hp) / 1e9
    card_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    print(f"    K2b, strict, memory at {B} rows: K2a's keep {keep_gb:.3f} GB and K2b's scratch {scratch_gb:.3f} GB "
          f"of the card's {card_gb:.1f} GB ({smi}); the strict training step's own peak {step_gb:.3f} GB beyond "
          f"what the phase held (the keep and the scratch grow with the rows)")
    from bcnf_tpu_torch.ops import _build

    spills, current = [], ""
    for ln in _build.build_logs.get("flow_fma", "").splitlines():  # this run's ptxas lines of K2a's instances
        if "Compiling entry function" in ln:
            current = kernel_label(ln)
        elif current.startswith("fma_flow_train_kernel") and ("spill" in ln or "registers" in ln):
            spills.append(f"{current}: {ln.split(':', 1)[-1].strip()}")
    usage = [f"{kernel_label(f"'{fn}'")} {u['REG']} registers, stack {u['STACK']} B"
             for fn, u in _build.resource_usage("flow_fma").items() if "fma_flow_train_kernel" in fn]
    print("    K2a, strict, ptxas: " + ("; ".join(spills) if spills else "flow_fma not rebuilt in this run")
          + "; cuobjdump -res-usage: " + "; ".join(usage))

    # (d) the strict backward in row chunks, at the main path's batch and at a ragged one whose chunks end past a
    # row group's rows (1024, 1024, 1024 and 1027 rows): K2a again a chunk, on that chunk's rows of h_proj alone
    for B, (x, h_proj, args, bound, keep, dz, dld, *_) in cases.items():
        if strict_chunks(x, h_proj, args[5], d_a, MODE_FMA) is not None:
            fail(f"the strict backward would chunk {B} rows: the main path's batch takes the whole keep")
        n = len(row_chunks(B, 1024))
        saved = counts()
        zero()
        with torch.no_grad():
            g_whole = fused_flow_train_bwd(bound, h_proj, dz, dld, *args, mode=MODE_FMA, keep=keep)
            g_chunk = fused_flow_train_bwd(bound, h_proj, dz, dld, *args, mode=MODE_FMA, chunk_rows=1024)
            g_again = fused_flow_train_bwd(bound, h_proj, dz, dld, *args, mode=MODE_FMA, chunk_rows=1024)
            g32 = fused_flow_train_backward_reference(bound, h_proj, dz, dld, *args)
            g64 = _strict_f64(x, h_proj, args, dz, dld)[1]
            torch.cuda.synchronize()
        got = counts()
        want = [(2 * n, {MODE_FMA: 2 * n}, {ROUTE_FMA: 2 * n}),
                (1 + 2 * n, {MODE_FMA: 1 + 2 * n}, {ROUTE_FMA: 1 + 2 * n})]

        def from64(grads) -> list[float]:
            return [((a.double() - r).abs().max() / r.abs().max()).item() for a, r in zip(grads, g64)]

        rel, rel_whole, rel_plain = from64(g_chunk), from64(g_whole), from64(g32)
        rows_equal = torch.equal(g_chunk[0], g_whole[0]) and torch.equal(g_chunk[1], g_whole[1])
        calls_equal = all(torch.equal(a, b) for a, b in zip(g_chunk, g_again))
        sizes = [end - first for first, end in row_chunks(B, 1024)]
        print(f"[6b strict training: row chunks] the backward at {B} rows in {n} chunks of {sizes} rows (K2a again "
              f"a chunk) against the whole batch's on K2a's step inputs and keep: dx and dh_proj equal to the bit "
              f"{rows_equal}; from float64 (max |d| / max |ref|) chunked / whole / float32 plain: "
              + ", ".join(f"{nm} {c:.2e}/{w:.2e}/{q:.2e}" for nm, c, w, q in zip(GRAD_NAMES, rel, rel_whole, rel_plain))
              + f"; equal between calls {calls_equal}; launches K2a {got[0]}, K2b {got[1]}")
        if not rows_equal or not calls_equal or got != want or any(c > 2 * q for c, q in zip(rel, rel_plain)):
            fail(f"the chunked strict backward at {B} rows: rows equal {rows_equal}, calls equal {calls_equal}, "
                 f"launches {got} (want {want}), from float64 {rel} against twice {rel_plain}")
        restore(saved)
    del g_whole, g_chunk, g_again, g32, g64, cases, x, h_proj, args, bound, keep, dz, dld
    torch.cuda.empty_cache()

    big = 65_536  # the strict flagship's step past one keep's memory: Trainer.train_step on random rows
    y_big = torch.from_numpy(rng.normal(size=(big, smodel.size)).astype(np.float32)).to(dev)
    c_big = [torch.from_numpy(rng.normal(size=(big, 30, 3)).astype(np.float32)).to(dev)]
    trainer.train_step(smodel, [params], opt, y_big, c_big, [gen])  # a warm-up step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    zero()
    t0 = time.perf_counter()
    trainer.train_step(smodel, [params], opt, y_big, c_big, [gen])
    torch.cuda.synchronize()
    big_s = time.perf_counter() - t0
    big_run = counts()
    big_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    finite = all(torch.isfinite(t).all().item() for t in tree_leaves(params))
    n_big = big_run[1][0]
    print(f"[6b strict training, batch {big}] one Trainer.train_step of the strict flagship: {big_s * 1e3:.1f} ms "
          f"({big / big_s:.0f} train samples/s); launches K2a {big_run[0]}, K2b {big_run[1]} ({n_big} row chunks); "
          f"peak memory {big_peak:.2f} GB ({big_peak - held / 1e9:.2f} GB beyond what the phase held) of the "
          f"card's {card_gb:.1f} GB ({smi}); params finite {finite}")
    if (n_big < 2 or big_run[0] != (n_big + 1, {MODE_FMA: n_big + 1}, {ROUTE_FMA: n_big + 1})
            or big_run[1] != (n_big, {MODE_FMA: n_big}, {ROUTE_FMA: n_big}) or not finite):
        fail(f"the strict step at {big} rows: launches K2a {big_run[0]}, K2b {big_run[1]} (the backward should run "
             f"in row chunks, K2a once more a chunk), params finite {finite}")
    restore(saved)
    del y_big, c_big
    torch.cuda.empty_cache()
    return rows


def weight_copies_ms(model, params: dict, dev) -> tuple[float, float, int]:
    """Time the stacking and padding of the flow's weights into the kernels'
    arguments, forward and backward, alone: (forward ms, backward ms, bytes)."""
    import torch

    from bcnf_tpu_torch.ops.flow_kernel import pad_hidden, stack_flow_params

    h_proj = torch.zeros((1, 1, model.nested_sizes[0]), device=dev)
    fwd, bwd = [], []
    for _ in range(6):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        kargs, _ = pad_hidden(stack_flow_params(model, params), h_proj)
        ev[1].record()
        outs = [v for v in kargs.values() if v.requires_grad]
        torch.autograd.backward(outs, [torch.ones_like(v) for v in outs])
        ev[2].record()
        torch.cuda.synchronize()
        fwd.append(ev[0].elapsed_time(ev[1]))
        bwd.append(ev[1].elapsed_time(ev[2]))
    nbytes = sum(4 * v.numel() for v in kargs.values())
    return sorted(fwd[1:])[2], sorted(bwd[1:])[2], nbytes


def device_profile(step, what: str = "one step at batch 4096") -> None:
    """One call of `step` (a training step, a rank batch) under
    `torch.profiler`: the device's busy share and the kernels that take most
    of its time. Prints what the profiler saw; a profiler that records no
    device time is reported, not a failure."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # kernels only: the host-side ops' entries repeat their kernels' device time
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    if not kernels:
        print("    profiler: no device time recorded; the CUDA-event split stands alone")
        return
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"    profiler, {what}: kernels busy {busy_ms:.1f} ms of {wall_ms:.1f} ms wall "
          f"(device idle share {max(0.0, 1 - busy_ms / wall_ms):.1%}, profiler on); top kernels by device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"      {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:90]}")


def train_cli(rng, build_dir: str) -> None:
    """Phase 7: `python -m bcnf_tpu_torch train` on a written dataset with a
    copy of the flagship config (coupling dropout 0, 2 epochs of 2 batches of
    256), then `sample` from the model directory it wrote."""
    import numpy as np
    import yaml

    from bcnf_tpu_torch.__main__ import main as cli_main
    from bcnf_tpu_torch.ops.flow_kernel import fused_flow, fused_flow_train_bwd, fused_flow_train_fwd

    cfg = _flagship_train_config(256, 2)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        cfg_path, data_path = os.path.join(tmp, "run.yaml"), os.path.join(tmp, "data.pkl")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f)
        n = 640  # 512 training rows (2 batches) + 128 validation rows
        data = {"trajectories": rng.normal(size=(n, 30, 3)).astype(np.float32)}
        data.update({p: rng.normal(size=n).astype(np.float32) for p in cfg["global"]["parameter_selection"]})
        with open(data_path, "wb") as f:
            pickle.dump(data, f)
        model_dir, out = os.path.join(tmp, "model"), os.path.join(tmp, "samples.npy")
        fused_flow_train_fwd.launches = fused_flow_train_bwd.launches = 0
        cli_main(["train", "-c", cfg_path, "-d", data_path, "-o", model_dir, "--seed", "1"])
        k2a, k2b = fused_flow_train_fwd.launches, fused_flow_train_bwd.launches
        fused_flow.launches = 0
        cli_main(["sample", "-m", model_dir, "-d", data_path, "-n", "20", "-o", out, "--seed", "2"])
        samples, k1 = np.load(out), fused_flow.launches
    if k2a != 4 or k2b != 4:
        fail(f"the train CLI launched K2a {k2a} and K2b {k2b} times for 4 steps")
    if samples.shape != (20, n, 19) or not np.isfinite(samples).all() or k1 != 1:
        fail(f"sample after train gave shape {samples.shape}, finite={np.isfinite(samples).all()}, K1 launches {k1}")
    print(f"[7 entry point] bcnf_tpu_torch train (2 epochs x 2 steps of 256): K2a {k2a}, K2b {k2b} launches; "
          f"then sample from its model directory: {samples.shape} finite, K1 launches {k1}")


# ---------------------------------------------------------------------------
# phases 8-11: the LSTM recurrence kernels (K3a/K3b) and the per-coupling
# kernel (K4)
# ---------------------------------------------------------------------------

LSTM_GRADS = ("dxp", "dW_hh")


def lstm_work(T: int, B: int, H: int) -> tuple[tuple[float, float], tuple[float, float]]:
    """(operations, bytes) of one K3a and of one K3b call for one direction
    of B rows and T steps at hidden size H: K3a does the step products
    h W_hh (8 H^2 FLOP a row and step), reads xp and W_hh once and writes hs
    and cs; K3b recomputes those products, multiplies dgates back through
    W_hh^T and forms dW_hh over the (T - 1) B rows that have an h_prev, reads
    xp, W_hh, hs, cs and dhs and writes dxp and dW_hh."""
    step = 2.0 * B * H * 4 * H
    seq, gates, w = T * B * H, T * B * 4 * H, H * 4 * H
    fwd = (T * step, 4.0 * (gates + w + 2 * seq))
    bwd = ((2 * T + T - 1) * step, 4.0 * (gates + w + 3 * seq + gates + w))
    return fwd, bwd


def cudnn_lstm(p: dict, F: int, H: int, reverse: bool, dev):
    """cuDNN's one-layer, one-direction LSTM carrying the same weights
    (`weight_ih_l0 = w_ih^T`, ...; gate order i, f, g, o as the port's): the
    library yardstick, run on the time-reversed input for the reverse
    direction. Never on the port's path."""
    import torch

    lstm = torch.nn.LSTM(F, H, num_layers=1, batch_first=True).to(dev)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(p["w_ih"].T)
        lstm.weight_hh_l0.copy_(p["w_hh"].T)
        lstm.bias_ih_l0.copy_(p["b_ih"])
        lstm.bias_hh_l0.copy_(p["b_hh"])

    def run(x):
        out = lstm(x.flip(1) if reverse else x)[0]
        return out.flip(1) if reverse else out

    return run


def check_lstm_kernels(rng, dev) -> dict:
    """Phase 8: K3a and K3b against their plain versions at the encoders'
    shapes, then their times at the flagship encoder's batch-4096 shape
    beside the plain versions and cuDNN. Launches here do not count."""
    import numpy as np
    import torch

    from bcnf_tpu_torch.ops.lstm import lstm_cell_init
    from bcnf_tpu_torch.ops.lstm_kernel import (
        BWD_DW,
        BWD_RECURRENCE,
        _bwd_parts,
        fused_direction,
        fwd_layout,
        lstm_direction_bwd,
        lstm_direction_bwd_reference,
        lstm_direction_fwd,
        lstm_direction_fwd_reference,
    )

    saved = lstm_direction_fwd.launches, lstm_direction_bwd.launches
    gen = torch.Generator().manual_seed(SEED)
    print(f"[8 LSTM kernels] K3a vs plain (hs, cs; tolerance {LSTM_TOL:g}) and K3b vs plain (grads from "
          f"standard-normal dhs; bar |d| <= min({LSTM_GRAD_ATOL:g}, {GRAD_REL:g} max|plain|) + "
          f"{LSTM_GRAD_RTOL:g}|plain|), B=4096 and ragged B=4099, both directions:")
    worst = {"K3a": 0.0, "K3b": 0.0}
    cells = {}
    for label, T, F, H in (("flagship layer 1", 30, 3, 140), ("flagship layer 2", 30, 280, 140),
                           ("t_DLSTM_large time layer 1", 30, 3, 128), ("t_DLSTM_large freq layer 1", 16, 6, 128)):
        p = {k: v.to(dev) for k, v in lstm_cell_init(gen, F, H).items()}
        cells[label] = (p, T, F, H)
        for B in (4096, 4099):
            x = torch.from_numpy(rng.normal(size=(B, T, F)).astype(np.float32)).to(dev)
            with torch.no_grad():
                xp = (torch.matmul(x.transpose(0, 1), p["w_ih"]) + p["b_ih"] + p["b_hh"]).contiguous()
                for reverse in (False, True):
                    hs, cs = lstm_direction_fwd(xp, p["w_hh"], reverse)
                    hs_r, cs_r = lstm_direction_fwd_reference(xp, p["w_hh"], reverse)
                    err = max((hs - hs_r).abs().max().item(), (cs - cs_r).abs().max().item())
                    dhs = torch.randn(hs.shape, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
                    got = lstm_direction_bwd(xp, p["w_hh"], hs, cs, dhs, reverse)
                    ref = lstm_direction_bwd_reference(xp, p["w_hh"], hs, cs, dhs, reverse)
                    torch.cuda.synchronize()
                    what = f"K3b {label} B={B} {'reverse' if reverse else 'forward'}"
                    print(f"      K3a {label} B={B} {'reverse' if reverse else 'forward'}: max|d| hs, cs {err:.3e}")
                    if not err <= LSTM_TOL:
                        fail(f"K3a ({label}, B={B}, reverse={reverse}) disagrees with plain: {err:.3e} > {LSTM_TOL:g}")
                    worst["K3a"] = max(worst["K3a"], err)
                    worst["K3b"] = max(worst["K3b"], check_grads(what, LSTM_GRADS, got, ref, LSTM_GRAD_ATOL,
                                                                 LSTM_GRAD_RTOL))
    if (lstm_direction_fwd.launches - saved[0], lstm_direction_bwd.launches - saved[1]) != (16, 16):
        fail("the LSTM kernels did not count their launches")
    for label, H in (("flagship", 140), ("t_DLSTM_large", 128)):
        lay = fwd_layout(4096, H, dev)
        print(f"    K3a layout, {label} H={H}, B=4096: clusters of 8 blocks own {lay['rows']} rows each; "
              f"{lay['clusters']} clusters, {lay['resident_clusters']} resident at once: {lay['waves']} wave(s)")

    # times at the main path's shapes: the flagship encoder's layer 2 at
    # batch 4096 (the kernels do not depend on the input width), and
    # t_DLSTM_large's time LSTM at its batch 256
    times = {}
    for key, label, B in (("flagship", "flagship layer 2", 4096), ("t_DLSTM_large", "t_DLSTM_large time layer 1", 256)):
        p, T, F, H = cells[label]
        x = torch.from_numpy(rng.normal(size=(B, T, F)).astype(np.float32)).to(dev)
        with torch.no_grad():
            xp = (torch.matmul(x.transpose(0, 1), p["w_ih"]) + p["b_ih"] + p["b_hh"]).contiguous()
            hs, cs = lstm_direction_fwd(xp, p["w_hh"], False)
            dhs = torch.randn(hs.shape, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
            t = {
                "K3a": cuda_ms(lambda: lstm_direction_fwd(xp, p["w_hh"], False), reps=5),
                "K3a plain": cuda_ms(lambda: lstm_direction_fwd_reference(xp, p["w_hh"], False), reps=3),
                "projection + K3a": cuda_ms(lambda: fused_direction(p, x, H, False), reps=5),
                "K3b": cuda_ms(lambda: lstm_direction_bwd(xp, p["w_hh"], hs, cs, dhs, False), reps=5),
                "K3b plain": cuda_ms(lambda: lstm_direction_bwd_reference(xp, p["w_hh"], hs, cs, dhs, False), reps=3),
            }
            # K3b's two parts alone: the cluster recurrence, and the dW_hh pass over its dxp
            dxp_b, dw_b = lstm_direction_bwd(xp, p["w_hh"], hs, cs, dhs, False)
            for part, bit in (("K3b recurrence", BWD_RECURRENCE), ("K3b dW_hh pass", BWD_DW)):
                t[part] = cuda_ms(lambda: _bwd_parts(xp, p["w_hh"], hs, cs, dhs, False, dxp_b, dw_b, bit), reps=5)
            run = cudnn_lstm(p, F, H, False, dev)
            t["cuDNN forward"] = cuda_ms(lambda: run(x), reps=5)
        xg = x.clone().requires_grad_(True)
        dy = dhs.transpose(0, 1).contiguous()
        t["cuDNN forward, autograd on"] = cuda_ms(lambda: run(xg), reps=5)

        def fwd_bwd():
            run(xg).backward(dy)

        t["cuDNN forward + backward"] = cuda_ms(fwd_bwd, reps=5)
        med = {k: median(v) for k, v in t.items()}
        (f_ops, f_bytes), (b_ops, b_bytes) = lstm_work(T, B, H)
        times[key] = dict(med, T=T, B=B, H=H, work=((f_ops, f_bytes), (b_ops, b_bytes)), ranges={
            k: (min(v), max(v)) for k, v in t.items()})
        print(f"    times, {label}, B={B}, T={T}, H={H} (CUDA events, median; ms): K3a {med['K3a']:.3f} "
              f"(range {min(t['K3a']):.3f}-{max(t['K3a']):.3f}; {f_ops / 1e9:.1f} GFLOP -> "
              f"{f_ops / med['K3a'] / 1e9:.1f} TFLOP/s), plain {med['K3a plain']:.3f}; projection + K3a "
              f"{med['projection + K3a']:.3f} vs cuDNN forward {med['cuDNN forward']:.3f} (with autograd on "
              f"{med['cuDNN forward, autograd on']:.3f}); K3b {med['K3b']:.3f} "
              f"(range {min(t['K3b']):.3f}-{max(t['K3b']):.3f}; {b_ops / 1e9:.1f} GFLOP -> "
              f"{b_ops / med['K3b'] / 1e9:.1f} TFLOP/s; recurrence {med['K3b recurrence']:.3f}, dW_hh pass "
              f"{med['K3b dW_hh pass']:.3f}), plain {med['K3b plain']:.3f}; cuDNN backward "
              f"(forward + backward - forward) {med['cuDNN forward + backward'] - med['cuDNN forward']:.3f}")
    lstm_direction_fwd.launches, lstm_direction_bwd.launches = saved
    times["err"] = worst
    return times


def lstm_rows(times: dict, launches: dict, peaks: tuple[float, float, float]) -> list[dict]:
    """The K3a/K3b entries of the kernel table, at the flagship encoder's
    batch-4096 shape; launches are phase 9's (path A's main-path run)."""
    t = times["flagship"]
    (fwd_work, bwd_work) = t["work"]
    src, rep = "bcnf_tpu_torch/ops/csrc/lstm_kernel.cu", "bcnf_tpu/ops/lstm_kernel.py"
    rows = [
        kernel_row("K3a lstm_direction_fwd", src, f"{rep}:129", launches["K3a"], times["err"]["K3a"], [t["K3a"]],
                   [t["K3a plain"]], fwd_work, peaks, t["cuDNN forward"], ARITH_3XTF32),
        kernel_row("K3b lstm_direction_bwd", src, f"{rep}:150", launches["K3b"], times["err"]["K3b"], [t["K3b"]],
                   [t["K3b plain"]], bwd_work, peaks, t["cuDNN forward + backward"] - t["cuDNN forward"],
                   ARITH_3XTF32),
    ]
    for row, work, what in ((rows[0], fwd_work, "forward"), (rows[1], bwd_work, "backward")):
        print(f"    {row['name'].split()[0]} (3xtf32) at B={t['B']}: {row['ms']:.3f} ms against its bound "
              f"{row['bound_ms']:.3f} ms ({row['bound_by']}; float32-FMA bound {bound_ms(work, peaks, ARITH_FMA)[0]:.3f} ms) "
              f"and cuDNN's {what} {row['library_ms']:.3f} ms: "
              f"{'faster' if row['ms'] < row['library_ms'] else 'not faster'} than cuDNN")
    return rows


def lstm_counts() -> dict:
    from bcnf_tpu_torch.ops.flow_kernel import fused_flow, fused_flow_train_bwd, fused_flow_train_fwd
    from bcnf_tpu_torch.ops.lstm_kernel import lstm_direction_bwd, lstm_direction_fwd

    return {"K3a": lstm_direction_fwd.launches, "K3b": lstm_direction_bwd.launches, "K1": fused_flow.launches,
            "K2a": fused_flow_train_fwd.launches, "K2b": fused_flow_train_bwd.launches}


def zero_counts() -> None:
    from bcnf_tpu_torch.ops.flow_kernel import fused_flow, fused_flow_train_bwd, fused_flow_train_fwd
    from bcnf_tpu_torch.ops.lstm_kernel import lstm_direction_bwd, lstm_direction_fwd

    for fn in (lstm_direction_fwd, lstm_direction_bwd, fused_flow, fused_flow_train_fwd, fused_flow_train_bwd):
        fn.launches = 0
    fused_flow.route_launches.clear()


def fused_lstm(on: bool) -> None:
    os.environ["BCNF_FUSED_LSTM"] = "1" if on else "0"


def train_with_counts(cfg: dict, model, rng, dev, dirs: int, what: str,
                      val_batches: int | None = None) -> tuple[dict, int, dict, list]:
    """`Trainer.train` on random data (3 batches an epoch) with the fused
    LSTM on; checks K3b = dirs a step and K3a = dirs a step, validation
    batch and the ActNorm data init. The validation batches are K1's
    launches, or `val_batches` where K1 does not cover the flow. Returns
    (counts, steps, trained, data)."""
    import numpy as np
    import torch

    from bcnf_tpu_torch.bridge import tree_leaves
    from bcnf_tpu_torch.train import Trainer

    B, n_epochs = cfg["training"]["batch_size"], cfg["training"]["n_epochs"]
    n = int(round(3 * B / (1 - cfg["training"]["validation_split"])))
    y = rng.normal(size=(n, model.size)).astype(np.float32)
    traj = rng.normal(size=(n, 30, 3)).astype(np.float32)
    params0 = model.init(torch.Generator().manual_seed(SEED), device=dev)
    trainer = Trainer(cfg, data=(y, [traj]), device=dev, seed=SEED)
    fused_lstm(True)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    trained = trainer.train(model, params0)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    c = lstm_counts()
    steps = 3 * n_epochs
    hist = trainer.meta_scheduler.parameter_history
    losses = [v for _, v in hist["train_loss"]] + [v for _, v in hist["val_loss"]]
    n_val = c["K1"] if val_batches is None else val_batches
    if c["K3b"] != dirs * steps or c["K3a"] != dirs * (steps + n_val + 1):
        fail(f"{what}: Trainer.train launched K3a {c['K3a']} and K3b {c['K3b']} times for {steps} steps, "
             f"{c['K1']} validation batches and the ActNorm init ({dirs} directions)")
    if not (np.all(np.isfinite(losses)) and all(torch.isfinite(t).all() for t in tree_leaves(trained))):
        fail(f"{what}: Trainer.train gave non-finite losses or params: {losses}")
    print(f"    {what}: Trainer.train, {n_epochs} epoch(s) x 3 steps of {B} + validation in {t_train:.2f} s; "
          f"launches K3a {c['K3a']}, K3b {c['K3b']}, K2a {c['K2a']}, K2b {c['K2b']}, K1 {c['K1']}; losses "
          f"{', '.join(f'{v:.3f}' for v in losses)}")
    return c, steps, trained, (y, traj, trainer)


def step_against_loop(model, trained, yb, cb, dev, what: str, expect: tuple[int, int]) -> None:
    """One training step's loss and grads (from standard-normal cotangents)
    with the fused LSTM against the same step with the time loop, dropout
    masks from the same seeded generator."""
    import torch

    from bcnf_tpu_torch.bridge import map_tree, tree_leaves
    from bcnf_tpu_torch.utils.misc import inn_nll_loss

    losses, grads = [], []
    for on in (True, False):
        fused_lstm(on)
        p = map_tree(lambda t: t.detach().clone().requires_grad_(True), trained)
        before = lstm_counts()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        z, ld = model.forward(p, yb, *cb, generator=gen, train=True)
        dz, dld = randn_cotangents(z)
        ((z * dz).sum() + (ld * dld).sum()).backward()
        after = lstm_counts()
        used = (after["K3a"] - before["K3a"], after["K3b"] - before["K3b"])
        if used != (expect if on else (0, 0)):
            fail(f"{what}: the step launched K3a/K3b {used} times (fused LSTM {on})")
        losses.append(inn_nll_loss(z, ld).item())
        grads.append([t.grad for t in tree_leaves(p)])
    worst, max_d, mags = -1.0, 0.0, []
    for a, b in zip(*grads):
        if a is not None and b is not None:
            d, excess, mag = grad_excess(a, b)
            worst, max_d = max(worst, excess), max(max_d, d)
            mags.append(mag)
    loss_d = abs(losses[0] - losses[1])
    print(f"    {what}: step through K3a/K3b vs the time-loop encoder's: loss {losses[0]:.5f} vs {losses[1]:.5f}; "
          f"{len(mags)} param grads, max|d| {max_d:.3e} (bar |d| <= min({GRAD_ATOL:g}, {GRAD_REL:g} max|plain|) + "
          f"{GRAD_RTOL:g}|plain|), max|plain| per grad from {min(mags):.3e} to {max(mags):.3e}")
    if not loss_d <= KERNEL_TOL * max(1.0, abs(losses[1])) or worst > 0:
        fail(f"{what}: the fused-LSTM step disagrees with the time loop's: loss |d| {loss_d:.3e}, grads {worst:.3e} "
             f"past the bar")


def train_rates(model, trainer, trained, yb, cb, dev, reps: int = 5) -> tuple[float, float]:
    """Train samples/s of `Trainer.train_step` with the fused LSTM and with
    the time loop (host clock around synchronised work, after a warm-up)."""
    import torch

    from bcnf_tpu_torch.bridge import map_tree
    from bcnf_tpu_torch.train import make_optimizer

    rates = []
    for on in (True, False):
        fused_lstm(on)
        params = map_tree(lambda t: t.detach().clone().requires_grad_(True), trained)
        opt = make_optimizer("Adam", lr=2e-4).init(params)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        trainer.train_step(model, [params], opt, yb, cb, [gen])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            trainer.train_step(model, [params], opt, yb, cb, [gen])
        torch.cuda.synchronize()
        rates.append(reps * yb.shape[0] / (time.perf_counter() - t0))
    fused_lstm(True)
    return rates[0], rates[1]


def cli_round_trip(cfg: dict, rng, build_dir: str, dirs: int, what: str) -> dict:
    """`train` (2 epochs of 2 batches) on a written dataset, then `sample`
    from its model directory, with the fused LSTM on; launch counts checked
    and returned."""
    import numpy as np
    import yaml

    from bcnf_tpu_torch.__main__ import main as cli_main

    B = cfg["training"]["batch_size"]
    fused_lstm(True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        cfg_path, data_path = os.path.join(tmp, "run.yaml"), os.path.join(tmp, "data.pkl")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f)
        n = int(round(2 * B / (1 - cfg["training"]["validation_split"])))
        data = {"trajectories": rng.normal(size=(n, 30, 3)).astype(np.float32)}
        data.update({p: rng.normal(size=n).astype(np.float32) for p in cfg["global"]["parameter_selection"]})
        with open(data_path, "wb") as f:
            pickle.dump(data, f)
        model_dir, out = os.path.join(tmp, "model"), os.path.join(tmp, "samples.npy")
        zero_counts()
        cli_main(["train", "-c", cfg_path, "-d", data_path, "-o", model_dir, "--seed", "1"])
        tr = lstm_counts()
        zero_counts()
        cli_main(["sample", "-m", model_dir, "-d", data_path, "-n", "20", "-o", out, "--seed", "2"])
        samples, sa = np.load(out), lstm_counts()
    size = len(cfg["global"]["parameter_selection"])
    if tr["K3b"] != dirs * 4 or tr["K3a"] < dirs * 5:
        fail(f"{what}: the train CLI launched K3a {tr['K3a']} and K3b {tr['K3b']} times for 4 steps")
    if samples.shape != (20, n, size) or not np.isfinite(samples).all() or (sa["K3a"], sa["K1"]) != (dirs, 1):
        fail(f"{what}: sample after train gave shape {samples.shape}, finite={np.isfinite(samples).all()}, "
             f"launches K3a {sa['K3a']}, K1 {sa['K1']}")
    print(f"    {what}: bcnf_tpu_torch train (2 epochs x 2 steps of {B}): K3a {tr['K3a']}, K3b {tr['K3b']}, K2a "
          f"{tr['K2a']}, K2b {tr['K2b']} launches; then sample: {samples.shape} finite, K3a {sa['K3a']}, K1 {sa['K1']}")
    return {k: tr[k] + sa[k] for k in tr}


def lstm_path_a(model, params, traj, samples, rng, dev, build_dir: str, lstm_times: dict, k2b_ms: float) -> dict:
    """Phase 9: the flagship with BCNF_FUSED_LSTM=1. Returns the K3a/K3b
    launches of its sampling call, its two `Trainer.train` runs and its CLI
    round trip (the step checks and the rates time other calls)."""
    import torch

    from bcnf_tpu_torch.models import CondRealNVP
    from bcnf_tpu_torch.bridge import map_tree
    from bcnf_tpu_torch.ops.flow_kernel import fused_flow_train
    from bcnf_tpu_torch.train import make_optimizer
    from bcnf_tpu_torch.utils.misc import inn_nll_loss

    totals = {"K3a": 0, "K3b": 0}

    def add(c):
        totals["K3a"] += c["K3a"]
        totals["K3b"] += c["K3b"]

    fused_lstm(True)
    with torch.no_grad():
        zero_counts()
        t0 = time.perf_counter()
        out = model.sample(params, torch.Generator().manual_seed(SEED), M_DRAWS, traj, device=dev)
        torch.cuda.synchronize()
        t_sample = time.perf_counter() - t0
    c = lstm_counts()
    add(c)
    err = (out - samples).abs().max().item()
    print(f"[9 path A] flagship, BCNF_FUSED_LSTM=1: sample {M_DRAWS}x{N_COND} in {t_sample:.3f} s = "
          f"{M_DRAWS * N_COND / t_sample:.0f} samples/s; launches K3a {c['K3a']}, K1 {c['K1']}; max|d| vs the "
          f"time-loop encoder's samples (phase 3) {err:.3e} (tolerance {KERNEL_TOL:g})")
    if (c["K3a"], c["K1"], c["K3b"]) != (4, 1, 0) or not torch.isfinite(out).all():
        fail(f"fused-LSTM sampling launched K3a {c['K3a']}, K1 {c['K1']}, K3b {c['K3b']} or is not finite")
    if not err <= KERNEL_TOL:
        fail(f"fused-LSTM samples disagree with the time loop's: {err:.3e} > {KERNEL_TOL:g}")

    rates = {}
    for B in (4096, 256):
        cfg = _flagship_train_config(B, 1)
        m = CondRealNVP.from_config(cfg)
        c, steps, trained, (y, tr, trainer) = train_with_counts(cfg, m, rng, dev, 4, f"batch {B}")
        add(c)
        if (c["K2a"], c["K2b"]) != (steps, steps):
            fail(f"path A batch {B}: K2a {c['K2a']}, K2b {c['K2b']} for {steps} steps")
        yb = torch.from_numpy(y[:B]).to(dev)
        cb = [torch.from_numpy(tr[:B]).to(dev)]
        step_against_loop(m, trained, yb, cb, dev, f"batch {B}", (4, 4))
        rates[B] = train_rates(m, trainer, trained, yb, cb, dev)
        if B != 4096:
            continue
        # CUDA-event split of one step with the fused LSTM, as in phase 6
        fused_lstm(True)
        p = map_tree(lambda t: t.detach().clone().requires_grad_(True), trained)
        opt = make_optimizer("Adam", lr=2e-4).init(p)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        splits = []
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
            opt.zero_grad()
            ev[0].record()
            h = m.encode(p, cb, gen, train=True)
            ev[1].record()
            kargs, h_proj = m._fused_flow_args(p, h)
            ev[2].record()
            z, ld = fused_flow_train(yb, h_proj, *[kargs[k] for k in TRAIN_ARGS])
            ev[3].record()
            loss = inn_nll_loss(z, ld)
            ev[4].record()
            loss.backward()
            ev[5].record()
            opt.step()
            ev[6].record()
            torch.cuda.synchronize()
            splits.append([ev[i].elapsed_time(ev[i + 1]) for i in range(6)])
        split = [sorted(col)[1] for col in zip(*splits)]
        k3b4 = 4 * lstm_times["flagship"]["K3b"]
        print(f"    step split at batch 4096 with the fused LSTM (CUDA events, median of 3, ms): encoder forward "
              f"{split[0]:.2f} (4 x K3a alone ~{4 * lstm_times['flagship']['K3a']:.2f}), projections + stacking "
              f"{split[1]:.2f}, K2a {split[2]:.2f}, loss {split[3]:.2f}, backward {split[4]:.2f} (4 x K3b alone "
              f"~{k3b4:.2f}, K2b alone {k2b_ms:.2f}), clip + Adam {split[5]:.2f}; step {sum(split):.2f} = "
              f"{4096 / sum(split) * 1e3:.0f} samples/s")
    print(f"    train samples/s, flagship: {rates[4096][0]:.0f} at batch 4096 and {rates[256][0]:.0f} at 256 with the "
          f"fused LSTM; {rates[4096][1]:.0f} and {rates[256][1]:.0f} with the time loop (same call)")
    for B in (4096, 256):
        LSTM_TABLE[f"flagship (dropout 0), train step at {B}"] = (*rates[B], "train samples/s")
    add(cli_round_trip(_flagship_train_config(256, 2), rng, build_dir, 4, "flagship CLI"))
    fused_lstm(False)
    return totals


def dlstm_path_b(rng, dev, build_dir: str) -> None:
    """Phase 10: t_DLSTM_large at its published widths with
    BCNF_FUSED_LSTM=1: sampling, training at batch 256 and 4096, the CLI."""
    import numpy as np
    import torch

    from bcnf_tpu_torch.config import load_config
    from bcnf_tpu_torch.models import CondRealNVP, DualDomainLSTM, count_params

    cfg = load_config(DLSTM_CONFIG).to_dict()
    model = CondRealNVP.from_config(cfg)
    if not isinstance(model.features.feature_networks[1], DualDomainLSTM):
        fail("t_DLSTM_large did not build a DualDomainLSTM encoder")
    params = model.init(torch.Generator().manual_seed(SEED), device=dev)
    n_params = count_params(params)
    if n_params != DLSTM_PARAMS:
        fail(f"t_DLSTM_large has {n_params:,} params, expected {DLSTM_PARAMS:,}")
    traj = torch.from_numpy(rng.normal(size=(N_COND, 30, 3)).astype(np.float32))
    outs, secs, counts = {}, {}, {}
    with torch.no_grad():
        for on in (True, False):
            fused_lstm(on)
            model.sample(params, torch.Generator().manual_seed(SEED), 16, traj, device=dev)  # warm-up
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            outs[on] = model.sample(params, torch.Generator().manual_seed(SEED), M_DRAWS, traj, device=dev)
            torch.cuda.synchronize()
            secs[on], counts[on] = time.perf_counter() - t0, lstm_counts()
    err = (outs[True] - outs[False]).abs().max().item()
    print(f"[10 path B] t_DLSTM_large ({n_params:,} params), BCNF_FUSED_LSTM=1: sample {M_DRAWS}x{N_COND} in "
          f"{secs[True]:.3f} s = {M_DRAWS * N_COND / secs[True]:.0f} samples/s (time loop: "
          f"{M_DRAWS * N_COND / secs[False]:.0f}); launches K3a {counts[True]['K3a']}, K1 {counts[True]['K1']}; "
          f"max|d| vs the time loop's samples {err:.3e} (tolerance {KERNEL_TOL:g})")
    if (counts[True]["K3a"], counts[True]["K1"]) != (16, 1) or counts[False]["K3a"] != 0:
        fail(f"t_DLSTM_large sampling launched K3a {counts[True]['K3a']}, K1 {counts[True]['K1']} "
             f"(time loop: K3a {counts[False]['K3a']})")
    if not torch.isfinite(outs[True]).all() or not err <= KERNEL_TOL:
        fail(f"t_DLSTM_large fused-LSTM samples not finite or off the time loop's: {err:.3e}")

    rates = {}
    for B in (256, 4096):
        tcfg = load_config(DLSTM_CONFIG).to_dict()
        tcfg["training"].update(batch_size=B, n_epochs=1, timeout=None)
        m = CondRealNVP.from_config(tcfg)
        c, steps, trained, (y, tr, trainer) = train_with_counts(tcfg, m, rng, dev, 16, f"t_DLSTM_large batch {B}")
        if (c["K2a"], c["K2b"]) != (0, 0):
            fail(f"t_DLSTM_large batch {B}: the training kernels ran ({c['K2a']}, {c['K2b']}) with coupling dropout 0.5")
        yb = torch.from_numpy(y[:B]).to(dev)
        cb = [torch.from_numpy(tr[:B]).to(dev)]
        if B == 256:
            step_against_loop(m, trained, yb, cb, dev, f"t_DLSTM_large batch {B}", (16, 16))
        rates[B] = train_rates(m, trainer, trained, yb, cb, dev)
    LSTM_TABLE["t_DLSTM_large, published config, train step at 256"] = (*rates[256], "train samples/s")
    print(f"    train samples/s, t_DLSTM_large: {rates[256][0]:.0f} at batch 256 and {rates[4096][0]:.0f} at 4096 with "
          f"the fused LSTM; {rates[256][1]:.0f} and {rates[4096][1]:.0f} with the time loop (same call)")
    ccfg = load_config(DLSTM_CONFIG).to_dict()
    ccfg["training"].update(n_epochs=2, timeout=None)
    cli_round_trip(ccfg, rng, build_dir, 16, "t_DLSTM_large CLI")
    fused_lstm(False)


def coupling_work(args: dict, rows: int, n_cond: int, H: int, inverse: bool) -> tuple[float, float]:
    """Operations and bytes of one K4 call at the unpadded hidden width H:
    the MLP's products for every row, each weight and condition row read
    once, x_a and x_b read and the output (and the forward's logdet) written."""
    d_a, nh = args["w1y"].shape[0], len(args["wm"])
    n_out = args["wout"].shape[1]
    d_b = n_out // 2
    flops = rows * 2.0 * (d_a * H + nh * H * H + H * n_out)
    weights = d_a * H + H + nh * (H * H + H) + H * n_out + n_out
    nbytes = 4.0 * (weights + n_cond * H + rows * (d_a + 2 * d_b + (0 if inverse else 1)))
    return flops, nbytes


def coupling_path_c(model, params, traj, samples, z_all, y_lp, cond_lp, rng, dev,
                    peaks: tuple[float, float, float]) -> list[dict]:
    """Phase 11: K4 against its plain version at the flagship widths; the
    flagship with `use_pallas_coupling` (26 K4 launches a pass) against K1.
    Returns the K4 entries of the kernel table."""
    import numpy as np
    import torch

    from bcnf_tpu_torch.bridge import map_tree
    from bcnf_tpu_torch.ops import coupling_kernel
    from bcnf_tpu_torch.ops.coupling_kernel import (
        coupling_flow_args,
        fused_affine_coupling,
        fused_affine_coupling_reference,
        mlp_params_to_kernel_args,
    )
    from bcnf_tpu_torch.ops.flow_kernel import (
        FWD_WGMMA_ROUTES,
        MODE_3XTF32,
        ROUTE_ROWS,
        _launch_flow,
        flow_route,
        fused_flow,
        padded_width,
        prepare_train_weights,
        prepare_weights,
    )

    cp = model.coupling
    fwd_route = flow_route(padded_width(model.nested_sizes[0]), model.size, cp.d_a, False, MODE_3XTF32)
    fwd_staged = fwd_route in FWD_WGMMA_ROUTES  # K4's forward keeps a wgmma layout of its hidden weights too
    blk0 = map_tree(lambda t: t[0], params["blocks"]["coupling"])
    args = mlp_params_to_kernel_args(blk0["a"], cp.d_a)
    H = model.nested_sizes[0]
    saved = fused_affine_coupling.launches
    errs = {False: 0.0, True: 0.0}
    tiles_err = 0.0  # the forward's row tiles, forced
    k4_64 = []
    with torch.no_grad():
        for B, N in ((4096, 8), (4099, 7)):
            h = model.encode(params, (torch.from_numpy(rng.normal(size=(N, 30, 3)).astype(np.float32)).to(dev),))
            h_proj = cp.cond_proj(blk0, h)["a"][0]
            x = torch.from_numpy(rng.normal(size=(B, model.size)).astype(np.float32)).to(dev)
            x_a, x_b = x[:, : cp.d_a].contiguous(), x[:, cp.d_a:].contiguous()
            for inverse in (False, True):
                out = fused_affine_coupling(x_a, x_b, h_proj, **args, inverse=inverse)
                ref = fused_affine_coupling_reference(x_a, x_b, h_proj, **args, inverse=inverse, n_cond=N)
                torch.cuda.synchronize()
                errs[inverse] = max([errs[inverse]] + [(a - b).abs().max().item() for a, b in zip(
                    (out,) if inverse else out, (ref,) if inverse else ref)])
                if not inverse:
                    with row_tiles_forced("FWD_WGMMA_MAX_TN"):
                        if flow_route(padded_width(H), model.size, cp.d_a, False, MODE_3XTF32) != ROUTE_ROWS:
                            fail("K4's forward with FWD_WGMMA_MAX_TN = 0 is not on the row tiles")
                        tiles = fused_affine_coupling(x_a, x_b, h_proj, **args, inverse=False)
                        torch.cuda.synchronize()
                    tiles_err = max([tiles_err] + [(a - b).abs().max().item() for a, b in zip(tiles, ref)])
                if inverse:  # K1's 3xTF32 wgmma inverse at one step: bit-equal between calls, near float64
                    again = fused_affine_coupling(x_a, x_b, h_proj, **args, inverse=True)
                    p64 = fused_affine_coupling_reference(x_a.double(), x_b.double(), h_proj.double(),
                                                          **map_tree(lambda v: v.double(), args), inverse=True,
                                                          n_cond=N)
                    d32, dk = (ref.double() - p64).abs().max().item(), (out.double() - p64).abs().max().item()
                    floor = 4 * float(torch.finfo(torch.float32).eps) * max(1.0, p64.abs().max().item())
                    k4_64.append(f"B={B}: {dk:.2e} (float32 plain {d32:.2e})")
                    if not torch.equal(out, again) or not dk <= 2 * d32 + floor:
                        fail(f"K4's 3xTF32 inverse (B={B}): equal between calls {torch.equal(out, again)}, from float64 "
                             f"{dk:.3e} against twice the float32 plain version's {d32:.3e} + {floor:.1e}")
                # the prepared (cached) weights against weights prepared for this launch alone
                _, y_u, ld_u = _launch_flow(x, coupling_flow_args(h_proj, **args), inverse=inverse, n_cond=N,
                                            mode=MODE_3XTF32)
                if not (torch.equal(out if inverse else out[0], y_u[:, cp.d_a:])
                        and (inverse or torch.equal(out[1], ld_u))):
                    fail(f"K4 on its prepared weights is not bit-equal to K4 on weights prepared for the launch "
                         f"({'inverse' if inverse else 'forward'}, B={B})")
    if fused_affine_coupling.launches != saved + 8:
        fail("fused_affine_coupling did not count its launches")
    print(f"[11 path C] K4 vs plain at H={H}, B=4096/N=8 and ragged B=4099/N=7: max|d| forward (z_b, logdet) "
          f"{errs[False]:.3e}, on its row tiles forced {tiles_err:.3e}, inverse {errs[True]:.3e} (tolerance "
          f"{KERNEL_TOL:g}); the inverse equal to the bit "
          f"between two calls, from the plain version in float64 {'; '.join(k4_64)} (bar: twice the float32 plain "
          f"version's)")
    for what, e in (("forward", errs[False]), ("inverse", errs[True]), ("forward on the row tiles", tiles_err)):
        if not e <= KERNEL_TOL:
            fail(f"K4 {what} disagrees with its plain version: {e:.3e}")

    # path C: the flagship's inverse over phase 3's sampling rows, and its
    # no-grad forward over the log_prob batch, through K4 in every coupling
    h = model.encode(params, (traj.to(dev),))
    model.use_pallas_coupling = True
    launches, preps = {}, []

    def prepared() -> tuple[int, int]:  # (padded stacks, wgmma stage layouts) since the last call
        got = (fused_affine_coupling.preparations, fused_affine_coupling.stage_preparations)
        fused_affine_coupling.preparations = fused_affine_coupling.stage_preparations = 0
        return got

    with torch.no_grad():
        fused_affine_coupling.launches = fused_flow.launches = 0
        coupling_kernel._prepared.clear()
        prepared()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y4 = model.inverse_given_h(params, z_all.to(dev), h)
        torch.cuda.synchronize()
        t_inv = time.perf_counter() - t0
        preps.append(prepared())
        launches[True], k1_inv = fused_affine_coupling.launches, fused_flow.launches
        fused_affine_coupling.launches = 0
        z4, ld4 = model.forward(params, y_lp, cond_lp)
        torch.cuda.synchronize()
        preps.append(prepared())
        launches[False], k1_fwd = fused_affine_coupling.launches, fused_flow.launches - k1_inv
        t0 = time.perf_counter()
        y4_again = model.inverse_given_h(params, z_all.to(dev), h)
        torch.cuda.synchronize()
        t_inv_again = time.perf_counter() - t0
        preps.append(prepared())
        model.use_pallas_coupling = False
        z1, ld1 = model.forward(params, y_lp, cond_lp)
    inv_err = (y4 - samples).abs().max().item()
    fwd_err = max((z4 - z1).abs().max().item(), (ld4 - ld1).abs().max().item())
    print(f"    flagship with use_pallas_coupling: inverse of {z_all.shape[0] * z_all.shape[1]} rows in {t_inv:.3f} s "
          f"(K4 launches {launches[True]}, K1 {k1_inv}), max|d| vs K1's samples {inv_err:.3e}; no-grad forward on "
          f"{y_lp.shape[0]} rows (K4 launches {launches[False]}, K1 {k1_fwd}), max|d| z, logdet vs K1's {fwd_err:.3e}")
    n_couplings = model.n_blocks
    want = [(n_couplings, n_couplings), (0, n_couplings if fwd_staged else 0), (0, 0)]
    print(f"    K4's weight preparations (padded stacks, wgmma stage layouts): the first inverse pass {preps[0]}, "
          f"the forward pass {preps[1]} (its route {fwd_route}), a second inverse pass {preps[2]} ({t_inv_again:.3f} "
          f"s, first {t_inv:.3f} s); expected {', '.join(map(str, want))}: each coupling's stack prepared once, and "
          f"each layout a route reads once")
    if (launches[True], k1_inv, launches[False], k1_fwd) != (n_couplings, 0, n_couplings, 0):
        fail(f"path C launched K4 {launches[True]}/{launches[False]} and K1 {k1_inv}/{k1_fwd} times")
    if preps != want or not torch.equal(y4, y4_again):
        fail(f"K4 prepared its weights {preps} times over three passes with unchanged weights, or the second "
             f"inverse pass differs from the first")
    if not (inv_err <= KERNEL_TOL and fwd_err <= KERNEL_TOL) or not torch.isfinite(y4).all():
        fail(f"path C disagrees with K1: inverse {inv_err:.3e}, forward {fwd_err:.3e}")

    # K4 timed at the main path's shapes: block 0's coupling over the
    # 80,000 sampling rows (inverse) and the 4096 log_prob rows (forward)
    rows = []
    with torch.no_grad():
        x_inv = z_all.to(dev).reshape(-1, model.size)
        shapes = {True: (x_inv, cp.cond_proj(blk0, h)["a"][0], N_COND),
                  False: (y_lp.contiguous(), cp.cond_proj(blk0, model.encode(params, (cond_lp,)))["a"][0], LOGPROB_ROWS)}
        for inverse, (x, hp, n) in shapes.items():
            x_a, x_b = x[:, : cp.d_a].contiguous(), x[:, cp.d_a:].contiguous()
            out = fused_affine_coupling(x_a, x_b, hp, **args, inverse=inverse)
            ref = fused_affine_coupling_reference(x_a, x_b, hp, **args, inverse=inverse, n_cond=n)
            err = max((a - b).abs().max().item() for a, b in zip((out,) if inverse else out, (ref,) if inverse else ref))
            if not err <= KERNEL_TOL:
                fail(f"K4 at the main path's shape disagrees with plain: {err:.3e}")
            k_times = cuda_ms(lambda: fused_affine_coupling(x_a, x_b, hp, **args, inverse=inverse), reps=5)
            p_times = cuda_ms(lambda: fused_affine_coupling_reference(x_a, x_b, hp, **args, inverse=inverse, n_cond=n),
                              reps=3)
            work = coupling_work(args, x.shape[0], n, H, inverse)
            direction = "inverse" if inverse else "forward"
            # what the wrapper prepares once per parameter version: the padded one-step
            # stack, and for a wgmma route the hi/lo layout of its hidden weights
            prep = (lambda: prepare_weights(coupling_flow_args(hp, **args)["wm"])) if inverse else (
                (lambda: prepare_train_weights(coupling_flow_args(hp, **args)["wm"], passes=3)) if fwd_staged else
                (lambda: coupling_flow_args(hp, **args)))
            prep_ms = median(cuda_ms(prep, reps=5))
            before_ms, before_plain_ms = K4_EARLIER_MS[direction]
            src = "bcnf_tpu_torch/ops/csrc/" + ("flow_wgmma.cu" if inverse else
                                                "flow_fwd_wgmma.cu" if fwd_staged else "flow_kernel.cu")
            rows.append(kernel_row(f"K4 fused_affine_coupling[{direction}]", src,
                                   "bcnf_tpu/ops/coupling_kernel.py:69", launches[inverse], max(errs[inverse], err),
                                   k_times, p_times, work, peaks, None, ARITH_3XTF32))
            fma_bound = bound_ms(work, peaks, ARITH_FMA)[0]
            if not inverse and fwd_staged:  # the forward's row tiles forced on the same inputs, in turns
                tiles_ms = []
                for side in ("row tiles", "wgmma", "wgmma", "row tiles"):
                    with row_tiles_forced("FWD_WGMMA_MAX_TN") if side == "row tiles" else contextlib.nullcontext():
                        t = cuda_ms(lambda: fused_affine_coupling(x_a, x_b, hp, **args, inverse=False), reps=5)
                    (tiles_ms if side == "row tiles" else k_times).extend(t)
                rows[-1]["ms"], rows[-1]["row_tiles_ms"] = median(k_times), median(tiles_ms)
                print(f"    K4[forward] on the 3xTF32 wgmma forward {median(k_times):.3f} ms against the row tiles' "
                      f"{median(tiles_ms):.3f} ms (in turns, medians of {len(k_times)} and {len(tiles_ms)})")
                if not median(k_times) < median(tiles_ms):
                    fail(f"K4's forward on the 3xTF32 wgmma forward ({median(k_times):.3f} ms) is not faster than "
                         f"the row tiles ({median(tiles_ms):.3f} ms)")
            print(f"    K4[{direction}] ({'wgmma' if inverse else fwd_route}, 3xtf32) rows {x.shape[0]}: "
                  f"{median(k_times):.3f} ms (bound {rows[-1]['bound_ms']:.3f} ms, float32-FMA bound {fma_bound:.3f} ms, "
                  f"{work[0] / 1e9:.1f} GFLOP -> {work[0] / median(k_times) / 1e9:.1f} TFLOP/s, range "
                  f"{min(k_times):.3f}-{max(k_times):.3f}; on its prepared weights, whose preparation takes "
                  f"{prep_ms:.3f} ms once per parameter version), plain {median(p_times):.3f} ms; before the "
                  f"weights were kept (earlier runs): {before_ms} ms against plain {before_plain_ms} ms; max|d| vs plain "
                  f"{err:.2e}; x {n_couplings} couplings a pass")
    fused_affine_coupling.launches = saved
    return rows


# ---------------------------------------------------------------------------
# phase 12: the evaluation path (simulator, training at the published
# config, calibration ranks, resimulation)
# ---------------------------------------------------------------------------

PRIOR_CONFIG = "{{BCNF_ROOT}}/configs/data_prior.yaml"
# trajectories on the card against the CPU: the CPU tests' bar
# (tests/test_torch_port_simulation.py), |d| <= TRAJ_REL (1 + max|row|)
TRAJ_REL = 1e-5
# a draw this close to the true value may rank on the other side of it in
# the kernel and the plain version (K1's bar)
TIE = KERNEL_TOL


def trajectories_agree(card, cpu) -> tuple[bool, float, int]:
    """(agree, worst |d| / (1 + max|row|), rows finite) for trajectory
    arrays `(..., T, 3)`: the same rows finite, and those within TRAJ_REL."""
    import numpy as np

    card, cpu = card.reshape(-1, *card.shape[-2:]), cpu.reshape(-1, *cpu.shape[-2:])
    fin_card, fin_cpu = np.isfinite(card).all(axis=(1, 2)), np.isfinite(cpu).all(axis=(1, 2))
    if not np.array_equal(fin_card, fin_cpu):
        return False, float("inf"), int(fin_cpu.sum())
    scale = 1.0 + np.abs(cpu[fin_cpu]).max(axis=(1, 2))
    worst = float((np.abs(card[fin_cpu] - cpu[fin_cpu]).max(axis=(1, 2)) / scale).max()) if fin_cpu.any() else 0.0
    return worst <= TRAJ_REL, worst, int(fin_cpu.sum())


class K1Recorder:
    """Records each launch of K1 with its direction, route and rows: while
    active, `ops.flow_kernel.fused_flow` (which the model looks up from its
    module at every call) is a wrapper that shares the kernel's counters."""

    def __init__(self) -> None:
        from bcnf_tpu_torch.ops import flow_kernel

        self.module, self.real, self.calls = flow_kernel, flow_kernel.fused_flow, []

    def __enter__(self) -> "K1Recorder":
        real, routes = self.real, self.real.route_launches

        def recorded(x, h_proj, *args, inverse: bool, **kw):
            before = dict(routes)
            out = real(x, h_proj, *args, inverse=inverse, **kw)
            for route, n in routes.items():
                if n != before.get(route, 0):
                    self.calls.append(("inverse" if inverse else "forward", route, int(x.shape[0])))
            return out

        # the kernel's wrapper counts through its module's name, which is this wrapper now
        recorded.launches, recorded.route_launches = real.launches, routes
        self.module.fused_flow = recorded
        return self

    def __exit__(self, *exc) -> None:
        self.real.launches = self.module.fused_flow.launches
        self.module.fused_flow = self.real

    def summary(self) -> dict:
        from collections import Counter

        return dict(Counter(self.calls))


def step_split(model, params: dict, opt, yb, cb: list, gen) -> list[float]:
    """CUDA-event split of one training step on the plain flow (ms, median
    of 3): encoder forward, flow forward on that step's condition, backward
    of the NLL, clip + Adam."""
    import torch

    from bcnf_tpu_torch.utils.misc import inn_nll_loss

    splits = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        opt.zero_grad()
        ev[0].record()
        h = model.encode(params, cb, gen, train=True)
        ev[1].record()
        model.encode = lambda *_a, **_k: h  # the flow alone, on this step's condition
        z, ld = model.forward(params, yb, *cb, generator=gen, train=True)
        del model.encode
        ev[2].record()
        inn_nll_loss(z, ld).backward()
        ev[3].record()
        opt.step()
        ev[4].record()
        torch.cuda.synchronize()
        splits.append([ev[i].elapsed_time(ev[i + 1]) for i in range(4)])
    return [sorted(c)[1] for c in zip(*splits)]


def run_eval(argv: list[str]) -> tuple[tuple[dict, dict, dict], float]:
    """The `eval` CLI with `argv`, where matplotlib is installed; else its
    computation alone (`eval_report`, no figure). Returns what
    `eval_report` returned (report, arrays, stage seconds) and the seconds."""
    import importlib.util

    import bcnf_tpu_torch.__main__ as cli

    captured = {}
    compute = cli.eval_report

    def recording(args):
        captured["out"] = compute(args)
        return captured["out"]

    cli.eval_report = recording
    t0 = time.perf_counter()
    try:
        if importlib.util.find_spec("matplotlib") is not None:
            cli.main(argv)
        else:
            print("    figures not drawn: matplotlib is not installed here; eval_report (the eval CLI's "
                  "computation) runs alone")
            cli.eval_report(cli.build_parser().parse_args(argv))
    finally:
        cli.eval_report = compute
    return captured["out"], time.perf_counter() - t0


def eval_path(dev, build_dir: str, peaks: tuple[float, float, float], n_generate: int = 128,
              n_test: int = 200, m_samples: int = 10_000, resim_samples: int = 1000) -> None:
    """Phase 12: `generate` (filter, MC renderer), the flagship trained by the
    `train` CLI from its published config with no dataset (generated on the
    card), then `eval` with its defaults on a held-out generated set; the
    card's NLL, ranks and resimulation held against the plain and CPU
    results."""
    import numpy as np
    import torch
    import yaml

    import bcnf_tpu_torch.__main__ as cli
    from bcnf_tpu_torch.bridge import map_tree, params_from_numpy, tree_leaves
    from bcnf_tpu_torch.config import load_config, load_yaml, sub_root_path
    from bcnf_tpu_torch.models import CondRealNVP
    from bcnf_tpu_torch.ops.flow_kernel import (
        fused_flow,
        fused_flow_reference,
        fused_flow_train_bwd,
        fused_flow_train_fwd,
    )
    from bcnf_tpu_torch.simulation import physics
    from bcnf_tpu_torch.simulation.physics import point_of_impact, simulate_trajectory
    from bcnf_tpu_torch.simulation.priors import sample_ballistic_parameters
    from bcnf_tpu_torch.simulation.resimulation import resimulate
    from bcnf_tpu_torch.simulation.sampling import generate_data
    from bcnf_tpu_torch.train import Trainer, make_optimizer
    from bcnf_tpu_torch.train.data import TrainerDataHandler
    from bcnf_tpu_torch.utils.io import load_data
    from bcnf_tpu_torch.utils.misc import inn_nll_loss

    def sim_args(p: dict) -> list:
        vec = [torch.as_tensor(np.stack([np.asarray(p[f"{k}_{c}"], np.float32) for c in "xyz"], -1))
               for k in ("x0", "v0", "g", "w", "a")]
        sc = [torch.as_tensor(np.asarray(p[k], np.float32)) for k in ("b", "m", "rho", "r")]
        return [vec[0], vec[1], vec[2], vec[3], *sc, vec[4]]

    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        # -- 12.1: generate with the filter and the MC renderer, the CLI's defaults (dt 1/30, T 2)
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data = generate_data(config_file=PRIOR_CONFIG, n=n_generate, output_type="trajectories", dt=1 / 30, T=2.0,
                             do_filter=True, renderer="mc", seed=SEED, device=dev, stats=stats)
        t_gen = time.perf_counter() - t0
        traj = np.asarray(data["trajectories"])
        if traj.shape != (n_generate, 60, 3) or not np.isfinite(traj).all():
            fail(f"generate gave trajectories of shape {traj.shape}, finite={np.isfinite(traj).all()}")
        if any(len(v) != n_generate for v in data.values()) or np.asarray(data["cam_radian_array"]).shape != (
                n_generate, 2):
            fail("generate's dataset does not have the JAX package's schema")
        cpu_traj = simulate_trajectory(*sim_args(data), n_steps=60, dt=1 / 30, break_on_impact=True,
                                       n_substeps=4).numpy()
        ok, worst, _ = trajectories_agree(traj, cpu_traj)
        # the impact loop alone on one filter batch of 128 prior draws
        p = sample_ballistic_parameters(torch.Generator(device=dev).manual_seed(SEED), 128,
                                        load_yaml(PRIOR_CONFIG).to_dict())
        x0, v0, g, w, b, m, rho, r, a = (t.to(dev) for t in sim_args({k: v.cpu().numpy() for k, v in p.items()}))
        poi_stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        point_of_impact(x0, v0, g, w, b, m, rho, r, a, dt=1 / 30, stats=poi_stats)
        torch.cuda.synchronize()
        t_poi = time.perf_counter() - t0
        # the CUDA-graph replays against the eager loop (every step launched from the host), 640 steps
        t0 = time.perf_counter()
        poi_graph = point_of_impact(x0, v0, g, w, b, m, rho, r, a, dt=1 / 30, max_steps=640)
        torch.cuda.synchronize()
        t_graph = time.perf_counter() - t0
        check_every, physics.IMPACT_CHECK_EVERY = physics.IMPACT_CHECK_EVERY, 10**9  # one eager run of 640 steps
        t0 = time.perf_counter()
        poi_eager = point_of_impact(x0, v0, g, w, b, m, rho, r, a, dt=1 / 30, max_steps=640)
        torch.cuda.synchronize()
        t_eager = time.perf_counter() - t0
        physics.IMPACT_CHECK_EVERY = check_every
        if not torch.equal(poi_graph, poi_eager):
            fail("the impact loop's CUDA-graph replays disagree with its eager loop")
        print(f"[12 eval path: generate] {n_generate} accepted, {stats['rejected']} rejected in {stats['batches']} "
              f"batches of 128 (filter on, MC renderer, dt 1/30, T 2) in {t_gen:.2f} s = "
              f"{n_generate / t_gen:.1f} accepted trajectories/s; impact loop steps per batch "
              f"{stats['impact_steps']} of 3600 (early exit, exact); one impact loop of 128 rows: "
              f"{poi_stats['steps']} steps in {1e3 * t_poi:.1f} ms ({1e3 * t_poi / poi_stats['steps']:.3f} ms a step); "
              f"640 steps as CUDA-graph replays {1e3 * t_graph:.1f} ms, eager {1e3 * t_eager:.1f} ms, equal to the bit; "
              f"accepted trajectories vs the CPU integration of their parameters: worst |d|/(1+max|row|) "
              f"{worst:.2e} (bar {TRAJ_REL:g})")
        if not ok:
            fail(f"generated trajectories disagree with the CPU integration: {worst:.3e} > {TRAJ_REL:g}")

        # -- 12.2: train from the published flagship config, with no dataset on disk
        with open(sub_root_path(CONFIG)) as f:
            cfg = yaml.safe_load(f)
        cfg["data"]["path"] = os.path.join(tmp, "train_data")
        cfg["training"]["n_epochs"] = 1
        cfg_path, model_dir = os.path.join(tmp, "run.yaml"), os.path.join(tmp, "model")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f)
        zero_flow_counts()
        fused_flow_train_fwd.launches = fused_flow_train_bwd.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.main(["train", "-c", cfg_path, "-o", model_dir])
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        k2a, k2b, k1_val = fused_flow_train_fwd.launches, fused_flow_train_bwd.launches, fused_flow.launches
        if k2a or k2b:
            fail(f"training at the published dropout launched K2a {k2a} and K2b {k2b} times (its gate is closed)")
        with open(os.path.join(model_dir, "params.pkl"), "rb") as f:
            trained_np = pickle.load(f)
        if not all(np.isfinite(t).all() for t in tree_leaves(trained_np)):
            fail("the train CLI wrote non-finite params")
        run_cfg = load_config(cfg_path)
        y_all, conds_all = TrainerDataHandler().get_data_for_training(
            {k.lower(): v for k, v in run_cfg.items()}, CondRealNVP.from_config(run_cfg).parameter_index_mapping)
        if y_all.shape != (cfg["data"]["n_samples"], 19) or conds_all[0].shape[1:] != (30, 3):
            fail(f"the generated training set has shapes {y_all.shape}, {conds_all[0].shape}")
        # train samples/s and a CUDA-event split of one step at the published batch and dropout
        model = CondRealNVP.from_config(run_cfg)
        B = int(cfg["training"]["batch_size"])
        trainer = Trainer({k.lower(): v for k, v in run_cfg.items()}, data=(y_all, conds_all), device=dev, seed=SEED)
        params = params_from_numpy(trained_np, dev, requires_grad=True)
        opt = make_optimizer("Adam", lr=2e-4).init(params)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        yb, cb = torch.from_numpy(y_all[:B]).to(dev), [torch.from_numpy(conds_all[0][:B]).to(dev)]
        rates = {}
        for on in (True, False):  # the encoder on K3a/K3b, then on the time loop
            fused_lstm(on)
            trainer.train_step(model, [params], opt, yb, cb, [gen])
            torch.cuda.synchronize()
            reps = 5
            t0 = time.perf_counter()
            for _ in range(reps):
                trainer.train_step(model, [params], opt, yb, cb, [gen])
            torch.cuda.synchronize()
            rates[on] = reps * B / (time.perf_counter() - t0)
        rate = rates[False]
        LSTM_TABLE[f"flagship, published config (dropout {cfg['model']['kwargs']['dropout']}), train step at {B}"] = (
            rates[True], rates[False], "train samples/s")
        split = step_split(model, params, opt, yb, cb, gen)
        if fused_flow_train_fwd.launches or fused_flow_train_bwd.launches:
            fail("the published-dropout training steps launched the training kernels")
        print(f"[12 eval path: train] flagship from its published config (coupling dropout {cfg['model']['kwargs']['dropout']}, "
              f"batch {B}, 1 epoch), {len(y_all)} trajectories generated on the card (no filter, dt "
              f"{cfg['data']['dt']}, T {cfg['data']['T']}): train CLI {t_train:.2f} s; K2a {k2a}, K2b {k2b} launches "
              f"(gate closed), K1 (validation) {k1_val}; {rate:.0f} train samples/s (batch {B}, plain autograd flow, "
              f"time-loop encoder); step split (CUDA events, median of 3, ms): encoder forward {split[0]:.2f}, "
              f"flow forward {split[1]:.2f}, backward {split[2]:.2f}, clip + Adam {split[3]:.2f} "
              f"(sum {sum(split):.2f})")
        # the 3xTF32 training pair on these trained weights and the first 4096 training rows, against the
        # plain version in float64 beside the row tiles (the kernels called directly: the published dropout
        # closes their gate in training)
        fused_lstm(False)
        rows_12 = min(4096, len(y_all))
        train_pair_margin(model, params_from_numpy(trained_np, dev),
                          torch.from_numpy(np.ascontiguousarray(y_all[:rows_12], dtype=np.float32)).to(dev),
                          torch.from_numpy(np.ascontiguousarray(conds_all[0][:rows_12], dtype=np.float32)).to(dev),
                          "phase 12's trained weights")

        # -- 12.3: eval with its defaults on a held-out generated set
        test_set = os.path.join(tmp, "test.pkl")
        cli.main(["generate", "-c", PRIOR_CONFIG, "-o", test_set, "-n", str(n_test), "--no-filter",
                  "--dt", str(cfg["data"]["dt"]), "-T", str(cfg["data"]["T"]), "--seed", str(SEED + 1)])
        argv = ["eval", "-m", model_dir, "-d", test_set, "-o", os.path.join(tmp, "report"),
                "-M", str(m_samples), "--resim-samples", str(resim_samples), "--max-points", str(n_test)]
        zero_flow_counts()
        with K1Recorder() as k1:
            (report, figs, stages), t_eval = run_eval(argv)
        launches = k1.summary()
        # the same eval with the encoder on K3a/K3b, then on the time loop again (timed only)
        again = {}
        for on in (True, False):
            fused_lstm(on)
            again[on] = run_eval(argv[:6] + [os.path.join(tmp, f"report_{on}")] + argv[7:])[1]
        LSTM_TABLE[f"flagship eval at its defaults ({n_test} points, M {m_samples})"] = (
            again[True], min(t_eval, again[False]), "s")
        rank_batches = -(-n_test // 100)
        expected = {("inverse", "wgmma", min(100, n_test) * 1000): rank_batches * -(-m_samples // 1000),
                    ("inverse", "wgmma", min(100, n_test) * 128): rank_batches * 4,
                    ("inverse", "wgmma", n_test * 250): -(-resim_samples // 250),
                    ("forward", "fwd_wgmma", n_test): 1}
        if launches != expected:
            fail(f"eval launched K1 {launches}, expected {expected}")
        keys = {"test_nll", "n_points", "M_samples", "rank_mean_frac", "max_scaled_cdf_residual",
                "calibration_verdict_by_dim", "resim_finite_frac", "impact_median_dist"}
        if not keys <= set(report) or not np.isfinite(report["test_nll"]) or report["n_points"] != n_test:
            fail(f"eval's report lacks keys or values: {sorted(report)}")
        ranks, X_resim = figs["ranks"], figs["X_resim"]
        if ranks.shape != (n_test, 19) or ranks.min() < 0 or ranks.max() > m_samples:
            fail(f"eval's ranks have shape {ranks.shape} and range {ranks.min()}-{ranks.max()}")
        if X_resim.shape != (n_test, resim_samples, 30, 3):
            fail(f"eval's resimulation has shape {X_resim.shape}")
        print(f"[12 eval path: eval] {n_test} points, M {m_samples}, {resim_samples} resimulation draws: {t_eval:.2f} s; "
              f"stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()) +
              f"; K1 launches (direction, route, rows): {launches}; test NLL {report['test_nll']:.3f}, rank mean "
              f"fraction {report['rank_mean_frac']:.3f}, max scaled CDF residual {report['max_scaled_cdf_residual']:.2f}, "
              f"resimulation finite {report['resim_finite_frac']:.3f}")

        # -- 12.4: the card's results against the plain and CPU versions
        params = params_from_numpy(trained_np, dev)
        cpu_params = map_tree(lambda t: t.cpu(), params)
        y_test, conds_test = TrainerDataHandler().get_data_for_training(
            {k.lower(): v for k, v in dict(run_cfg, data=dict(run_cfg["data"], path=test_set)).items()},
            model.parameter_index_mapping)
        y_test, cond = y_test[:n_test], torch.from_numpy(conds_test[0][:n_test])
        with torch.no_grad():
            z_cpu, ld_cpu = model.forward(cpu_params, torch.from_numpy(y_test), cond)
        nll_cpu = inn_nll_loss(z_cpu, ld_cpu).item()
        # K1's bar is 1e-4 on each z and on the logdet, so the mean NLL
        # (0.5 |z|^2 - logdet) may move by 1e-4 (mean sum |z| + 1) + its square terms
        nll_bar = KERNEL_TOL * (z_cpu.abs().sum(dim=1).mean().item() + 1) + 19 * KERNEL_TOL**2
        nll_d = abs(report["test_nll"] - nll_cpu)
        # one rank batch (100 conditions x 1000 draws) through K1 against the plain version on the same z
        cond_b, y_b = cond[:100].to(dev), torch.from_numpy(y_test[:100]).to(dev)
        z = torch.randn((1000, cond_b.shape[0], 19), generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
        with torch.no_grad():
            kargs, h_proj = model._fused_flow_args(params, model.encode(params, (cond_b,)))
            saved = fused_flow.launches, dict(fused_flow.route_launches)
            x = z.reshape(-1, 19).contiguous()
            y_k = fused_flow(x, h_proj, **kargs, inverse=True, n_cond=cond_b.shape[0]).reshape(z.shape)
            y_p = fused_flow_reference(x, h_proj, **kargs, inverse=True, n_cond=cond_b.shape[0]).reshape(z.shape)
            # the truth K1 is held to: the plain version in float64 on the same rows, weights,
            # projections and z (cast on the card); the float32 plain version's own distance beside it
            y_64 = fused_flow_reference(x.double(), h_proj.double(), **{k: v.double() for k, v in kargs.items()},
                                        inverse=True, n_cond=cond_b.shape[0]).reshape(z.shape)
            err_64, err_p64 = (y_k - y_64).abs().max().item(), (y_p - y_64).abs().max().item()
            torch.cuda.synchronize()
            k_ms = median(cuda_ms(lambda: fused_flow(x, h_proj, **kargs, inverse=True, n_cond=cond_b.shape[0]), reps=3))
            p_ms = median(cuda_ms(lambda: fused_flow_reference(x, h_proj, **kargs, inverse=True,
                                                               n_cond=cond_b.shape[0]), reps=3))
            fused_flow.launches = saved[0]
            fused_flow.route_launches.clear()
            fused_flow.route_launches.update(saved[1])
        rk, rp = (y_k < y_b[None]).sum(dim=0), (y_p < y_b[None]).sum(dim=0)
        ties = ((y_p - y_b[None]).abs() < TIE).sum(dim=0)
        rank_d, err = (rk - rp).abs(), (y_k - y_p).abs().max().item()  # err: printed beside the bar
        flops, nbytes = flow_work(kargs, h_proj, x.shape[0], model.nested_sizes[0])
        bound = bound_ms((flops, nbytes), peaks, ARITH_3XTF32)[0]
        # resimulation on the card against the CPU: 64 draws x 64 points
        data_dict = load_data(test_set, keep_output_type="trajectories")
        data_dict = {k: v[:64] for k, v in data_dict.items()}
        with torch.no_grad():
            y_hat = model.sample(params, torch.Generator(device=dev).manual_seed(SEED), resim_samples,
                                 cond.to(dev), device=dev)
        full_dict = load_data(test_set, keep_output_type="trajectories")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        X_card_all = resimulate(model, params, cfg["data"]["T"], cfg["data"]["dt"], full_dict, y_hat, device=dev)
        t_resim = time.perf_counter() - t0
        n_traj = y_hat.shape[0] * y_hat.shape[1]
        X_card = resimulate(model, params, cfg["data"]["T"], cfg["data"]["dt"], data_dict, y_hat[:64, :64], device=dev)
        X_cpu = resimulate(model, params, cfg["data"]["T"], cfg["data"]["dt"], data_dict, y_hat[:64, :64].cpu(),
                           device="cpu")
        ok_resim, worst_resim, n_finite = trajectories_agree(X_card, X_cpu)
        print(f"    held: test NLL on the card {report['test_nll']:.6f} vs the CPU plain path {nll_cpu:.6f}: |d| "
              f"{nll_d:.2e} (bar {nll_bar:.2e} = 1e-4 (mean sum|z| + 1) + 19e-8); rank batch {tuple(z.shape)} through "
              f"K1 vs the plain version in float64 on the same z: max|dy| {err_64:.2e} ({err_64 / KERNEL_TOL:.1%} of the bar "
              f"{KERNEL_TOL:g}, held to {RANK_MARGIN:.0%} of it and to twice the float32 plain version's own distance "
              f"from float64, {err_p64:.2e}: each k-stage folded into a float32 sum; K1 vs float32 plain {err:.2e}); "
              f"ranks vs the float32 plain version's: {int((rank_d > 0).sum())} of {rank_d.numel()} ranks "
              f"differ, by at most {int(rank_d.max())}, near-ties (|y_hat - y| < {TIE:g}) {int(ties.sum())}; "
              f"{X_card.shape[0] * X_card.shape[1]} resimulated trajectories vs the CPU: worst |d|/(1+max|row|) "
              f"{worst_resim:.2e} (bar {TRAJ_REL:g}), {n_finite} finite")
        print(f"    K1 inverse at the rank batch's {x.shape[0]:,} rows: {k_ms:.2f} ms (bound {bound:.2f} ms, 3xTF32), "
              f"plain {p_ms:.2f} ms; resimulation of {n_traj:,} trajectories ({cfg['data']['T']} s at dt "
              f"{cfg['data']['dt']}, 4 RK4 substeps) from given draws: {t_resim:.3f} s = {n_traj / t_resim:.0f} "
              f"trajectories/s (with the copy to the host)")
        if X_card_all.shape != (n_test, resim_samples, 30, 3):
            fail(f"resimulate gave shape {X_card_all.shape}")
        if not nll_d <= nll_bar:
            fail(f"test NLL on the card is {nll_d:.3e} from the CPU plain path's (bar {nll_bar:.3e})")
        if not err_64 <= min(RANK_MARGIN * KERNEL_TOL, 2 * err_p64) or bool((rank_d > ties).any()):
            fail(f"the rank batch through K1 disagrees with the float64 plain version: max|dy| {err_64:.3e} (bar "
                 f"{RANK_MARGIN:.0%} of {KERNEL_TOL:g} and twice the float32 plain version's {err_p64:.3e}), ranks "
                 f"beyond their near-ties at {int((rank_d > ties).sum())} places")
        if not ok_resim:
            fail(f"resimulation on the card disagrees with the CPU: {worst_resim:.3e} > {TRAJ_REL:g}")


# ---------------------------------------------------------------------------
# phase 13: the model zoo (the Transformer, FrExp and dual-domain encoders,
# two-way AnyGLU couplings, the RQS coupling)
# ---------------------------------------------------------------------------

PTRF_CONFIG = "{{BCNF_ROOT}}/configs/runs/nll/t_PTRF_large.yaml"
PTRF_PARAMS = 37_046_525
SIGLU_CONFIG = "{{BCNF_ROOT}}/configs/runs/dev/trajectory_SFrExp_LSTM_SiGLU_2_large.yaml"
SIGLU_PARAMS = 48_543_591
CALIB7_CONFIG = "{{BCNF_ROOT}}/configs/runs/trajectory_LSTM_noisy_calib7.yaml"
CALIB7_PARAMS = 337_201
HYBRIDS = {  # config: (encoder, params)
    "{{BCNF_ROOT}}/configs/runs/hybrid/t_DPTRF_large_hybrid.yaml": ("DualDomainTransformer", 37_121_818),
    "{{BCNF_ROOT}}/configs/runs/hybrid/t_DFC_large_hybrid.yaml": ("DualDomainFC", 37_678_738),
}


def frames(cfg: dict) -> int:
    """Frames of the config's trajectories, T / dt (the simulator's grid)."""
    return int(round(cfg["data"]["T"] / cfg["data"]["dt"]))


def zoo_model(config: str, n_expected: int, encoder: str, dev) -> tuple[dict, object, dict]:
    """(config, model, params): the run config built at its published
    widths, random weights from the seed on the card; fails on another
    parameter count or encoder."""
    import torch

    from bcnf_tpu_torch.config import load_config
    from bcnf_tpu_torch.models import CondRealNVP, count_params

    cfg = load_config(config).to_dict()
    model = CondRealNVP.from_config(cfg)
    kinds = [type(fn).__name__ for fn in model.features.feature_networks]
    if encoder not in kinds:
        fail(f"{os.path.basename(config)} built the encoders {kinds}, not {encoder}")
    params = model.init(torch.Generator().manual_seed(SEED), device=dev)
    n_params = count_params(params)
    if n_params != n_expected:
        fail(f"{os.path.basename(config)} has {n_params:,} params, expected {n_expected:,}")
    return cfg, model, params


def zoo_sample(model, params: dict, traj, dev, n: int = M_DRAWS) -> tuple[object, float, dict, dict]:
    """`sample` of n draws for the trajectories after a warm-up, with the
    counts set to 0 just before: (samples, seconds, counts, K1 routes)."""
    import torch

    from bcnf_tpu_torch.ops.flow_kernel import fused_flow

    with torch.no_grad():
        model.sample(params, torch.Generator().manual_seed(SEED), 16, traj, device=dev)  # warm-up
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        out = model.sample(params, torch.Generator().manual_seed(SEED), n, traj, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    counts, routes = lstm_counts(), dict(fused_flow.route_launches)
    if tuple(out.shape) != (n, traj.shape[0], model.size) or not torch.isfinite(out).all():
        fail(f"samples of shape {tuple(out.shape)} are not all finite / not the expected shape")
    return out, secs, counts, routes


def zoo_cpu_check(model, params: dict, traj, out, z) -> tuple[float, object]:
    """max |d| of the first 64 draws against the CPU plain path on the same
    z, and the condition vector encoded on the CPU."""
    import torch

    from bcnf_tpu_torch.bridge import map_tree

    cpu_params = map_tree(lambda t: t.cpu(), params)
    with torch.no_grad():
        h_cpu = model.encode(cpu_params, (traj,))
        ref = model.inverse_given_h(cpu_params, z[:64], h_cpu)
    return (out[:64].cpu() - ref).abs().max().item(), h_cpu


def zoo_round_trip(model, params: dict, out, traj, z, dev) -> tuple[float, dict, dict]:
    """`log_prob` and the forward of 4096 samples (counts from 0): the round
    trip's max |forward(sample) - z|, the counts and K1's routes."""
    import torch

    from bcnf_tpu_torch.ops.flow_kernel import fused_flow

    d = LOGPROB_ROWS // traj.shape[0]
    y_lp = out[:d].reshape(-1, model.size)
    cond_lp = traj.to(dev).repeat(d, 1, 1)
    with torch.no_grad():
        zero_counts()
        lp = model.log_prob(params, y_lp, cond_lp)
        z_rt, _ = model.forward(params, y_lp, cond_lp)
        torch.cuda.synchronize()
    counts, routes = lstm_counts(), dict(fused_flow.route_launches)
    if not torch.isfinite(lp).all():
        fail("log_prob is not finite")
    return (z_rt.cpu() - z[:d].reshape(-1, model.size)).abs().max().item(), counts, routes


def zoo_path_d(rng, dev, build_dir: str, peaks: tuple[float, float, float]) -> dict:
    """Path D: t_PTRF_large (the Transformer of the NLL comparison) at its
    published widths: sampling through K1 against the plain path, `log_prob`
    and the round trip, the encoder against the CPU, K1's time at the
    sampling shape, `Trainer.train` at batch 256 with the published dropout
    (plain autograd), train samples/s and a step split, the CLI. Returns
    K1's launches on the path by direction."""
    import numpy as np
    import torch

    from bcnf_tpu_torch.bridge import map_tree
    from bcnf_tpu_torch.config import load_config
    from bcnf_tpu_torch.ops.flow_kernel import ROUTE_FWD_WGMMA, ROUTE_WGMMA, fused_flow, fused_flow_reference
    from bcnf_tpu_torch.train import Trainer, make_optimizer

    cfg, model, params = zoo_model(PTRF_CONFIG, PTRF_PARAMS, "Transformer", dev)
    T, H = frames(cfg), model.nested_sizes[0]
    traj = torch.from_numpy(rng.normal(size=(N_COND, T, 3)).astype(np.float32))
    z = torch.randn((M_DRAWS, N_COND, model.size), generator=torch.Generator().manual_seed(SEED))
    launches = {"inverse": 0, "forward": 0}
    out, secs, _, routes = zoo_sample(model, params, traj, dev)
    if routes != {ROUTE_WGMMA: 1}:
        fail(f"t_PTRF_large sampling launched K1 {routes}, not once on {ROUTE_WGMMA}")
    launches["inverse"] += 1
    model.use_pallas = False
    with torch.no_grad():
        plain = model.sample(params, torch.Generator().manual_seed(SEED), M_DRAWS, traj, device=dev)
    model.use_pallas = True
    plain_err = (out - plain).abs().max().item()
    cpu_err, h_cpu = zoo_cpu_check(model, params, traj, out, z)
    with torch.no_grad():
        h = model.encode(params, (traj.to(dev),))
    enc_err = (h.cpu() - h_cpu).abs().max().item()
    rt_err, _, fwd_routes = zoo_round_trip(model, params, out, traj, z, dev)
    if fwd_routes != {ROUTE_FWD_WGMMA: 2}:
        fail(f"t_PTRF_large log_prob and round trip launched K1 {fwd_routes}, not twice on {ROUTE_FWD_WGMMA}")
    launches["forward"] += 2
    enc = model.features.feature_networks[-1]
    print(f"[13 model zoo, path D] t_PTRF_large ({PTRF_PARAMS:,} params; Transformer {enc.n_blocks} x {enc.trf_size}, "
          f"{enc.n_heads} heads, positional embeddings {enc.add_positional_embeddings}; flow {model.n_blocks} blocks "
          f"of {len(model.nested_sizes)} x {H}): sample {M_DRAWS}x{N_COND} in {secs:.3f} s = "
          f"{M_DRAWS * N_COND / secs:.0f} samples/s, K1 launches {routes}; max|d| vs the plain path on the same z "
          f"{plain_err:.3e}, vs the CPU plain path (64 draws) {cpu_err:.3e}; encoder on the card vs the CPU "
          f"{enc_err:.3e}; log_prob + round trip on {LOGPROB_ROWS} rows (K1 {fwd_routes}): max|forward(sample) - z| "
          f"{rt_err:.3e} (tolerances {KERNEL_TOL:g}, round trip {ROUNDTRIP_TOL:g})")
    for what, err, tol in (("plain path", plain_err, KERNEL_TOL), ("CPU plain path", cpu_err, KERNEL_TOL),
                           ("CPU encoder", enc_err, KERNEL_TOL), ("round trip", rt_err, ROUNDTRIP_TOL)):
        if not err <= tol:
            fail(f"t_PTRF_large disagrees with the {what}: {err:.3e} > {tol:g}")

    # K1 at the sampling shape, beside its bound and its plain version (uncounted launches)
    with torch.no_grad():
        x_inv = z.to(dev).reshape(-1, model.size)
        kargs, h_proj = model._fused_flow_args(params, h)
        saved = fused_flow.launches, dict(fused_flow.route_launches)
        k_times = cuda_ms(lambda: fused_flow(x_inv, h_proj, **kargs, inverse=True, n_cond=N_COND), reps=5)
        p_times = cuda_ms(lambda: fused_flow_reference(x_inv, h_proj, **kargs, inverse=True, n_cond=N_COND), reps=3)
        # at Hp 512 (TN 16): two calls equal to the bit, and against the plain version in float64
        one, two = (fused_flow(x_inv, h_proj, **kargs, inverse=True, n_cond=N_COND) for _ in range(2))
        p32 = fused_flow_reference(x_inv, h_proj, **kargs, inverse=True, n_cond=N_COND)
        p64 = fused_flow_reference(x_inv.double(), h_proj.double(), **{k: v.double() for k, v in kargs.items()},
                                   inverse=True, n_cond=N_COND)
        d32, dk = (p32.double() - p64).abs().max().item(), (one.double() - p64).abs().max().item()
        bits = torch.equal(one, two)
        del p64
        fused_flow.launches = saved[0]
        fused_flow.route_launches.clear()
        fused_flow.route_launches.update(saved[1])
    work = flow_work(kargs, h_proj, x_inv.shape[0], H)
    bound, by = bound_ms(work, peaks, ARITH_3XTF32)
    print(f"    K1 inverse (wgmma, 3xtf32) at t_PTRF_large's {x_inv.shape[0]:,} rows (size {model.size}, hidden {H}, "
          f"{kargs['an_scale'].shape[0]} steps): {median(k_times):.2f} ms (range {min(k_times):.2f}-{max(k_times):.2f}; "
          f"bound {bound:.2f} ms, {by}; {work[0] / 1e12:.2f} TFLOP -> {work[0] / median(k_times) / 1e9:.1f} TFLOP/s), "
          f"plain {median(p_times):.2f} ms; equal to the bit between two calls: {bits}; from the plain version in "
          f"float64 {dk:.3e}, the float32 plain version's {d32:.3e} (bar: twice it)")
    if not bits or not dk <= 2 * d32:
        fail(f"t_PTRF_large's K1 inverse: equal between calls {bits}, from float64 {dk:.3e} against twice the float32 "
             f"plain version's {d32:.3e}")

    # Trainer.train at batch 256 with the published dropout 0.5: the flow on plain autograd
    B = 256
    tcfg = load_config(PTRF_CONFIG).to_dict()
    tcfg["training"].update(batch_size=B, n_epochs=1, timeout=None)
    n = int(round(3 * B / (1 - tcfg["training"]["validation_split"])))
    y = rng.normal(size=(n, model.size)).astype(np.float32)
    tr = rng.normal(size=(n, T, 3)).astype(np.float32)
    trainer = Trainer(tcfg, data=(y, [tr]), device=dev, seed=SEED)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    trained = trainer.train(model, model.init(torch.Generator().manual_seed(SEED), device=dev))
    torch.cuda.synchronize()
    t_train, c = time.perf_counter() - t0, lstm_counts()
    losses = [v for _, v in trainer.meta_scheduler.parameter_history["train_loss"]]
    if (c["K2a"], c["K2b"]) != (0, 0) or c["K1"] < 1 or not np.all(np.isfinite(losses)):
        fail(f"t_PTRF_large Trainer.train: K2a {c['K2a']}, K2b {c['K2b']} (gate closed by dropout), K1 (validation) "
             f"{c['K1']}, losses {losses}")
    launches["forward"] += c["K1"]
    yb, cb = torch.from_numpy(y[:B]).to(dev), [torch.from_numpy(tr[:B]).to(dev)]
    p = map_tree(lambda t: t.detach().clone().requires_grad_(True), trained)
    opt = make_optimizer("Adam", lr=2e-4).init(p)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    trainer.train_step(model, [p], opt, yb, cb, [gen])
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        trainer.train_step(model, [p], opt, yb, cb, [gen])
    torch.cuda.synchronize()
    rate = reps * B / (time.perf_counter() - t0)
    split = step_split(model, p, opt, yb, cb, gen)
    print(f"    t_PTRF_large Trainer.train (batch {B}, coupling dropout {tcfg['model']['kwargs']['dropout']}, 1 epoch of "
          f"3 steps + validation) in {t_train:.2f} s: K2a {c['K2a']}, K2b {c['K2b']}, K1 (validation) {c['K1']}; "
          f"{rate:.0f} train samples/s (plain autograd flow); step split (CUDA events, median of 3, ms): encoder "
          f"forward {split[0]:.2f}, flow forward {split[1]:.2f}, backward {split[2]:.2f}, clip + Adam {split[3]:.2f} "
          f"(sum {sum(split):.2f})")

    ccfg = load_config(PTRF_CONFIG).to_dict()
    ccfg["training"].update(n_epochs=2, timeout=None)
    cc = cli_round_trip(ccfg, rng, build_dir, 0, "t_PTRF_large CLI")
    launches["inverse"] += 1  # the sample CLI's one launch (checked there)
    launches["forward"] += cc["K1"] - 1  # the train CLI's validation
    return launches


def zoo_path_e(rng, dev) -> dict:
    """Path E: the signed-FrExp -> LSTM encoder with a two-way AnyGLU
    (Sigmoid gate) flow, with BCNF_FUSED_LSTM=1: sampling through the plain
    flow (K1 closed, K3a 4) against the CPU, the round trip, `Trainer.train`
    at batch 256 (K3a/K3b), a step against the time-loop encoder's, train
    samples/s both ways. Returns K3a's and K3b's launches on the path."""
    import numpy as np
    import torch

    from bcnf_tpu_torch.config import load_config

    cfg, model, params = zoo_model(SIGLU_CONFIG, SIGLU_PARAMS, "FrExpFeatureNetwork", dev)
    cp = model.coupling
    if not (cp.two_way and cp.nn_a.family.name == "AnyGLU") or cp.fusable:
        fail("trajectory_SFrExp_LSTM_SiGLU_2_large did not build a two-way AnyGLU coupling outside K1")
    T = frames(cfg)
    traj = torch.from_numpy(rng.normal(size=(N_COND, T, 3)).astype(np.float32))
    z = torch.randn((M_DRAWS, N_COND, model.size), generator=torch.Generator().manual_seed(SEED))
    fused_lstm(True)
    out, secs, c, routes = zoo_sample(model, params, traj, dev)
    if (c["K1"], c["K3a"], c["K3b"]) != (0, 4, 0):
        fail(f"two-way AnyGLU sampling launched K1 {c['K1']}, K3a {c['K3a']}, K3b {c['K3b']} (expected 0, 4, 0)")
    launches = {"K3a": c["K3a"], "K3b": 0}
    cpu_err, _ = zoo_cpu_check(model, params, traj, out, z)
    rt_err, rc, _ = zoo_round_trip(model, params, out, traj, z, dev)
    if (rc["K1"], rc["K3a"]) != (0, 8):
        fail(f"two-way AnyGLU log_prob and round trip launched K1 {rc['K1']}, K3a {rc['K3a']} (expected 0, 8)")
    launches["K3a"] += rc["K3a"]
    lstm = model.features.feature_networks[-1]
    print(f"[13 model zoo, path E] trajectory_SFrExp_LSTM_SiGLU_2_large ({SIGLU_PARAMS:,} params; signed FrExp -> "
          f"LSTM H {lstm.hidden_size}, two-way AnyGLU flow {model.n_blocks} blocks of {len(model.nested_sizes)} x "
          f"{model.nested_sizes[0]}), BCNF_FUSED_LSTM=1: sample {M_DRAWS}x{N_COND} in "
          f"{secs:.3f} s = {M_DRAWS * N_COND / secs:.0f} samples/s through the plain flow, launches K1 {c['K1']}, K3a "
          f"{c['K3a']}; max|d| vs the CPU plain path (64 draws) {cpu_err:.3e} (tolerance {KERNEL_TOL:g}); round trip "
          f"on {LOGPROB_ROWS} rows {rt_err:.3e} (tolerance {ROUNDTRIP_TOL:g})")
    if not cpu_err <= KERNEL_TOL or not rt_err <= ROUNDTRIP_TOL:
        fail(f"the two-way AnyGLU model disagrees: CPU {cpu_err:.3e}, round trip {rt_err:.3e}")

    B = 256
    tcfg = load_config(SIGLU_CONFIG).to_dict()
    tcfg["training"].update(batch_size=B, n_epochs=1, timeout=None)
    c, steps, trained, (y, tr, trainer) = train_with_counts(tcfg, model, rng, dev, 4, "SiGLU batch 256",
                                                            val_batches=1)
    if (c["K1"], c["K2a"], c["K2b"]) != (0, 0, 0):
        fail(f"two-way AnyGLU training launched K1 {c['K1']}, K2a {c['K2a']}, K2b {c['K2b']}")
    launches["K3a"] += c["K3a"]
    launches["K3b"] += c["K3b"]
    yb, cb = torch.from_numpy(y[:B]).to(dev), [torch.from_numpy(tr[:B]).to(dev)]
    step_against_loop(model, trained, yb, cb, dev, "SiGLU batch 256", (4, 4))
    rates = train_rates(model, trainer, trained, yb, cb, dev)
    print(f"    train samples/s, SiGLU at batch 256: {rates[0]:.0f} with the fused LSTM, {rates[1]:.0f} with the time "
          f"loop (same call; the flow on plain autograd)")
    fused_lstm(False)
    return launches


def zoo_path_f(dev, build_dir: str) -> None:
    """Path F: calib7 (the RQS coupling) from its published config: the
    `train` CLI with its data generated on the card (1 epoch), `eval` at its
    defaults on a held-out generated set (the same observation noise), each
    stage's seconds; its test NLL against the CPU plain path."""
    import numpy as np
    import torch
    import yaml

    import bcnf_tpu_torch.__main__ as cli
    from bcnf_tpu_torch.bridge import params_from_numpy, tree_leaves
    from bcnf_tpu_torch.config import load_config, sub_root_path
    from bcnf_tpu_torch.models import CondRealNVP, RQSCoupling, count_params
    from bcnf_tpu_torch.train.data import TrainerDataHandler
    from bcnf_tpu_torch.utils.misc import inn_nll_loss

    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        with open(sub_root_path(CALIB7_CONFIG)) as f:
            cfg = yaml.safe_load(f)
        cfg["data"]["path"] = os.path.join(tmp, "train_data")
        cfg["training"]["n_epochs"] = 1
        cfg_path, model_dir = os.path.join(tmp, "run.yaml"), os.path.join(tmp, "model")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        cli.main(["train", "-c", cfg_path, "-o", model_dir])
        torch.cuda.synchronize()
        t_train, c_train = time.perf_counter() - t0, lstm_counts()
        with open(os.path.join(model_dir, "params.pkl"), "rb") as f:
            trained_np = pickle.load(f)
        run_cfg = load_config(cfg_path)
        model = CondRealNVP.from_config(run_cfg)
        if not isinstance(model.coupling, RQSCoupling) or count_params(params_from_numpy(trained_np, "cpu")) != CALIB7_PARAMS:
            fail(f"calib7 did not build its RQS coupling with {CALIB7_PARAMS:,} params")
        if not all(np.isfinite(t).all() for t in tree_leaves(trained_np)) or any(c_train.values()):
            fail(f"calib7's train CLI wrote non-finite params or launched kernels: {c_train}")
        data = cfg["data"]
        test_set = os.path.join(tmp, "test.pkl")
        t0 = time.perf_counter()
        cli.main(["generate", "-c", PRIOR_CONFIG, "-o", test_set, "-n", "200", "--no-filter", "--dt", str(data["dt"]),
                  "-T", str(data["T"]), "--observation-noise", str(data["observation_noise"]), "--seed", str(SEED + 1)])
        t_gen = time.perf_counter() - t0
        zero_counts()
        (report, figs, stages), t_eval = run_eval(["eval", "-m", model_dir, "-d", test_set, "-o",
                                                   os.path.join(tmp, "report")])
        c_eval = lstm_counts()
        if any(c_eval.values()) or not np.isfinite(report["test_nll"]) or report["n_points"] != 200:
            fail(f"calib7's eval launched kernels {c_eval} or reported {report.get('test_nll')} on "
                 f"{report.get('n_points')} points")
        ranks = figs["ranks"]
        if ranks.shape != (200, 19) or ranks.min() < 0 or ranks.max() > report["M_samples"]:
            fail(f"calib7's ranks have shape {ranks.shape} and range {ranks.min()}-{ranks.max()}")
        # the card's test NLL against the CPU plain path on the same points
        y_test, conds = TrainerDataHandler().get_data_for_training(
            {k.lower(): v for k, v in dict(run_cfg, data=dict(run_cfg["data"], path=test_set)).items()},
            model.parameter_index_mapping)
        with torch.no_grad():
            z_cpu, ld_cpu = model.forward(params_from_numpy(trained_np, "cpu"), torch.from_numpy(y_test[:200]),
                                          torch.from_numpy(conds[0][:200]))
        nll_cpu = inn_nll_loss(z_cpu, ld_cpu).item()
        nll_bar = KERNEL_TOL * (z_cpu.abs().sum(dim=1).mean().item() + 1) + 19 * KERNEL_TOL**2
        nll_d = abs(report["test_nll"] - nll_cpu)
        # where a rank batch's time goes: one `sample` of 1000 draws for 100 test points, as the ranks call it
        params = params_from_numpy(trained_np, dev)
        cond = torch.from_numpy(conds[0][:100]).to(dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        with torch.no_grad():
            rank_ms = cuda_ms(lambda: model.sample(params, gen, 1000, cond, device=dev), reps=3)
            h = model.encode(params, (cond,))
            z = torch.randn((1000, 100, model.size), generator=gen, device=dev)
            flow_ms = cuda_ms(lambda: model.inverse_given_h(params, z, h), reps=3)
            device_profile(lambda: model.sample(params, gen, 1000, cond, device=dev),
                           "one rank batch of calib7 (1000 draws x 100 points)")
    print(f"[13 model zoo, path F] calib7 ({CALIB7_PARAMS:,} params; RQS coupling, {model.coupling.num_bins} bins, "
          f"{model.n_blocks} blocks of {len(model.nested_sizes)} x {model.nested_sizes[0]}; LSTM H "
          f"{model.features.feature_networks[-1].hidden_size}) from its published config: train CLI "
          f"({data['n_samples']} trajectories generated on the card with observation noise "
          f"{data['observation_noise']}, 1 epoch at batch {cfg['training']['batch_size']}) {t_train:.2f} s; generate "
          f"200 held-out {t_gen:.2f} s; eval at its defaults (M {report['M_samples']}) {t_eval:.2f} s, stages (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()) +
          f"; kernels launched: none (no kernel covers the RQS coupling); test NLL on the card "
          f"{report['test_nll']:.6f} vs the CPU plain path {nll_cpu:.6f}: |d| {nll_d:.2e} (bar {nll_bar:.2e}); rank "
          f"mean fraction {report['rank_mean_frac']:.3f}; one rank batch (1000 draws x 100 points, CUDA events, "
          f"median of 3): {median(rank_ms):.1f} ms, of which the {model.n_blocks}-block RQS inverse of its 100,000 rows "
          f"{median(flow_ms):.1f} ms")
    if not nll_d <= nll_bar:
        fail(f"calib7's test NLL on the card is {nll_d:.3e} from the CPU plain path's (bar {nll_bar:.3e})")


def zoo_hybrids(rng, dev) -> int:
    """Both dual-domain hybrids at their published widths: one `sample` of
    1000 x 8 through K1 against the plain path, and one training step with
    the hybrid loss at the published batch and dropout. Returns K1's
    launches."""
    import numpy as np
    import torch

    from bcnf_tpu_torch.bridge import map_tree, tree_leaves
    from bcnf_tpu_torch.ops.flow_kernel import ROUTE_WGMMA
    from bcnf_tpu_torch.train import Trainer, make_optimizer

    launches = 0
    for config, (encoder, n_params) in HYBRIDS.items():
        cfg, model, params = zoo_model(config, n_params, encoder, dev)
        name = os.path.basename(config)[:-5]
        T = frames(cfg)
        traj = torch.from_numpy(rng.normal(size=(N_COND, T, 3)).astype(np.float32))
        out, secs, _, routes = zoo_sample(model, params, traj, dev, n=1000)
        if routes != {ROUTE_WGMMA: 1} or not model.hybrid:
            fail(f"{name} sampling launched K1 {routes}, not once on {ROUTE_WGMMA} (hybrid {model.hybrid})")
        launches += 1
        model.use_pallas = False
        with torch.no_grad():
            plain = model.sample(params, torch.Generator().manual_seed(SEED), 1000, traj, device=dev)
        model.use_pallas = True
        err = (out - plain).abs().max().item()
        B = int(cfg["training"]["batch_size"])
        y = rng.normal(size=(B, model.size)).astype(np.float32)
        tr = rng.normal(size=(B, T, 3)).astype(np.float32)
        trainer = Trainer(cfg, data=(y, [tr]), device=dev, seed=SEED, hybrid_weight=cfg["global"]["hybrid_weight"])
        p = map_tree(lambda t: t.detach().clone().requires_grad_(True), params)
        before = [t.detach().clone() for t in tree_leaves(p["head"])]
        opt = make_optimizer("Adam", lr=2e-4).init(p)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        yb, cb = torch.from_numpy(y).to(dev), [torch.from_numpy(tr).to(dev)]
        zero_counts()
        t0 = time.perf_counter()
        metrics = trainer.train_step(model, [p], opt, yb, cb, [gen]).cpu()
        t_step, c = time.perf_counter() - t0, lstm_counts()
        moved = any(not torch.equal(a, b) for a, b in zip(before, tree_leaves(p["head"])))
        print(f"[13 model zoo, hybrid] {name} ({n_params:,} params; {encoder}): sample 1000x{N_COND} in {secs:.3f} s, "
              f"K1 launches {routes}, max|d| vs the plain path on the same z {err:.3e} (tolerance {KERNEL_TOL:g}); one "
              f"training step at batch {B} (hybrid weight {trainer.hybrid_weight}, coupling dropout "
              f"{cfg['model']['kwargs']['dropout']}) in {t_step:.3f} s (first call): loss, nll, mse, mean logdet "
              f"{', '.join(f'{v:.3f}' for v in metrics.tolist())}; K2a {c['K2a']}, K2b {c['K2b']}")
        if not err <= KERNEL_TOL:
            fail(f"{name} samples disagree with the plain path: {err:.3e}")
        if not torch.isfinite(metrics).all() or not metrics[2] > 0 or not moved or (c["K2a"], c["K2b"]) != (0, 0):
            fail(f"{name}'s training step gave {metrics.tolist()}, head moved {moved}, K2a/K2b {c['K2a']}/{c['K2b']}")
    return launches


# the one published configuration at Hp 1024 (5 x 1024, 32 blocks, size 19,
# n_conditions 32, hybrid, DualDomainLSTM): K1's 3xTF32 inverse at Hp 768 and
# 1024 runs the wide inverse (csrc/flow_wide_wgmma.cu)
WIDE_CONFIG = "{{BCNF_ROOT}}/configs/runs/dev/trajectory_LSTM_xsmall_large_hybrid_dual.yaml"
WIDE_PARAMS = 136_369_060
RANK_DRAWS, RANK_CONDITIONS = 1000, 100  # a rank batch: compute_y_hat_ranks' sample_batch_size x batch_size


def zoo_wide(rng, dev, peaks: tuple[float, float, float]) -> tuple[dict, list[dict]]:
    """Phase 13's wide configuration at its published widths, random weights
    from the seed: one `sample` of 10,000 x 8 (counts from 0 just before)
    through K1's wide inverse, one launch on its route, against the plain
    path on the same z within KERNEL_TOL; then its rank batch (1000 draws x
    100 conditions, 100,000 rows) through the wide inverse, the row tiles
    (forced, `WIDE_WGMMA_MAX_TN = 0`) and the float32 plain version, timed
    in turns in this process, the kernel no further from the float64 plain
    version than twice the float32 plain version (and than RANK_MARGIN of
    KERNEL_TOL, phase 12's bar); then its forwards (`wide_forward_path`).
    Returns the launches by kernel on the path and the kernels' rows of the
    table, the inverse's timed at the sample's rows."""
    import numpy as np
    import torch

    from bcnf_tpu_torch.ops import flow_kernel as fk

    cfg, model, params = zoo_model(WIDE_CONFIG, WIDE_PARAMS, "DualDomainLSTM", dev)
    name, T = os.path.basename(WIDE_CONFIG)[:-5], frames(cfg)
    H, size, d_a = model.nested_sizes[0], model.size, model.coupling.d_a
    traj = torch.from_numpy(rng.normal(size=(N_COND, T, 3)).astype(np.float32))
    out, secs, _, routes = zoo_sample(model, params, traj, dev)
    launches = routes.get(fk.ROUTE_WIDE, 0)
    if routes != {fk.ROUTE_WIDE: 1} or not model.hybrid:
        fail(f"{name} sampling launched K1 {routes}, not once on {fk.ROUTE_WIDE} (hybrid {model.hybrid})")
    model.use_pallas = False
    with torch.no_grad():
        plain = model.sample(params, torch.Generator().manual_seed(SEED), M_DRAWS, traj, device=dev)
    model.use_pallas = True
    sample_err = (out - plain).abs().max().item()
    if not sample_err <= KERNEL_TOL:
        fail(f"{name} samples through the wide inverse disagree with the plain path: {sample_err:.3e}")
    Hp = fk.padded_width(H)
    smem, resident = fk.wide_card_layout(Hp, size, d_a)

    def turns(fns: dict, reps: int = 3) -> dict:  # each in turn, then again in reverse: medians of both runs
        times = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            times[k] += cuda_ms(fns[k], reps)
        return {k: median(v) for k, v in times.items()}

    with torch.no_grad():
        # the kernel at the sample's rows, for the table
        kargs, h_proj = model._fused_flow_args(params, model.encode(params, (traj.to(dev),)))
        x = model.draw_z(torch.Generator().manual_seed(SEED), M_DRAWS, N_COND).to(dev).reshape(-1, size)
        err = (fk.fused_flow(x, h_proj, **kargs, inverse=True, n_cond=N_COND)
               - fk.fused_flow_reference(x, h_proj, **kargs, inverse=True, n_cond=N_COND)).abs().max().item()
        k_times = cuda_ms(lambda: fk.fused_flow(x, h_proj, **kargs, inverse=True, n_cond=N_COND), reps=5)
        p_times = cuda_ms(lambda: fk.fused_flow_reference(x, h_proj, **kargs, inverse=True, n_cond=N_COND), reps=3)
        # the rank batch: 100 conditions, 1000 draws each
        cond_b = torch.from_numpy(rng.normal(size=(RANK_CONDITIONS, T, 3)).astype(np.float32)).to(dev)
        kr, hr = model._fused_flow_args(params, model.encode(params, (cond_b,)))
        xr = torch.randn((RANK_DRAWS * RANK_CONDITIONS, size), generator=torch.Generator(device=dev).manual_seed(SEED),
                         device=dev)

        def rows():
            with row_tiles_forced("WIDE_WGMMA_MAX_TN"):
                return fk.fused_flow(xr, hr, **kr, inverse=True, n_cond=RANK_CONDITIONS)

        saved = fk.fused_flow.launches, dict(fk.fused_flow.route_launches)
        y_k = fk.fused_flow(xr, hr, **kr, inverse=True, n_cond=RANK_CONDITIONS)
        y_p = fk.fused_flow_reference(xr, hr, **kr, inverse=True, n_cond=RANK_CONDITIONS)
        y_64 = fk.fused_flow_reference(xr.double(), hr.double(), **{k: v.double() for k, v in kr.items()},
                                       inverse=True, n_cond=RANK_CONDITIONS)
        d_k, d_p = (y_k.double() - y_64).abs().max().item(), (y_p.double() - y_64).abs().max().item()
        del y_64
        r_ms = turns({"wide": lambda: fk.fused_flow(xr, hr, **kr, inverse=True, n_cond=RANK_CONDITIONS), "rows": rows,
                      "plain": lambda: fk.fused_flow_reference(xr, hr, **kr, inverse=True, n_cond=RANK_CONDITIONS)})
        if fk.fused_flow.route_launches[fk.ROUTE_ROWS] == saved[1].get(fk.ROUTE_ROWS, 0):
            fail("the rank batch's row tiles, forced, did not run on the row tiles")
        fk.fused_flow.launches = saved[0]
        fk.fused_flow.route_launches.clear()
        fk.fused_flow.route_launches.update(saved[1])
    row = kernel_row("fused_flow[inverse, wide]", "bcnf_tpu_torch/ops/csrc/flow_wide_wgmma.cu",
                     "bcnf_tpu/ops/flow_kernel.py:162", launches, err, k_times, p_times,
                     flow_work(kargs, h_proj, x.shape[0], H), peaks, None, ARITH_3XTF32)
    r_bound = bound_ms(flow_work(kr, hr, xr.shape[0], H), peaks, ARITH_3XTF32)[0]
    tiles = -(-x.shape[0] // fk.kernel_limit("kWwRows"))
    print(f"[13 model zoo, wide] {name} ({WIDE_PARAMS:,} params; {model.n_blocks} blocks of {len(model.nested_sizes)} "
          f"x {H}, Hp {Hp}): sample {M_DRAWS}x{N_COND} in {secs:.3f} s, K1 launches {routes}, max|d| vs the plain path "
          f"on the same z {sample_err:.3e} (tolerance {KERNEL_TOL:g}); the wide inverse at the sample's {x.shape[0]:,} "
          f"rows {row['ms']:.2f} ms (bound {row['bound_ms']:.2f} ms, {row['bound_ms'] / row['ms']:.1%}; plain "
          f"{row['plain_ms']:.2f} ms; max|d| {err:.2e}), {fk.wide_grid(x.shape[0], Hp)} blocks in clusters of "
          f"{Hp // fk.kernel_limit('kWwCols')}, {smem} bytes of shared memory a block, {resident} clusters resident at "
          f"once: {tiles / resident:.2f} waves")
    print(f"    rank batch ({RANK_DRAWS} draws x {RANK_CONDITIONS} conditions, {xr.shape[0]:,} rows), in turns: wide "
          f"inverse {r_ms['wide']:.2f} ms, row tiles (forced) {r_ms['rows']:.2f} ms, float32 plain "
          f"{r_ms['plain']:.2f} ms (bound {r_bound:.2f} ms: {r_bound / r_ms['wide']:.1%}); from the float64 plain "
          f"version: wide {d_k:.3e}, "
          f"float32 plain {d_p:.3e} (bar: twice it, and {RANK_MARGIN:.0%} of {KERNEL_TOL:g})")
    if not d_k <= min(2 * d_p, RANK_MARGIN * KERNEL_TOL) or not torch.isfinite(y_k).all():
        fail(f"the wide inverse on {name}'s rank batch is {d_k:.3e} from float64 (float32 plain {d_p:.3e})")
    if not r_ms["wide"] < min(r_ms["rows"], r_ms["plain"]):
        fail(f"the wide inverse ({r_ms['wide']:.2f} ms) loses to the row tiles ({r_ms['rows']:.2f}) or the plain "
             f"version ({r_ms['plain']:.2f}) on {name}'s rank batch")
    fwd_launches, fwd_rows = wide_forward_path(rng, dev, peaks, cfg, model, params, out)
    return {"K1 inverse, wide": launches, **fwd_launches}, [row, *fwd_rows]


def wide_forward_path(rng, dev, peaks: tuple[float, float, float], cfg: dict, model, params: dict,
                      out) -> tuple[dict, list[dict]]:
    """Phase 13's wide configuration through the 3xTF32 forwards at Hp 1024
    (the wide forward, csrc/flow_wide_wgmma.cu), each with the counts set to
    0 just before and read just after: `log_prob` and the forward of 4096 of
    the sample's draws (2 launches of K1's forward; z and logdet against the
    plain path within KERNEL_TOL), a `Trainer` validation pass of the
    config's 1000 validation rows in padded 256-row batches (4 launches; the
    metrics against the plain path's within KERNEL_TOL of their size), one
    training step at batch 256 with the coupling dropout at 0 (one K2a
    launch, one K2b launch on the wide backward, csrc/flow_wide_train_wgmma.cu;
    the step's metrics against the plain path's, and its grads from
    standard-normal cotangents against the plain step's at the JAX grad bar)
    and the forward of the 4096 draws through K4 (`use_pallas_coupling`:
    one launch a coupling, 32). Then K1's forward on 4096 and 256 rows with
    their own conditions (the validation layout), timed in turns on the
    route, the row tiles (forced) and the float32 plain version, and K2a and
    K4's forward at 4096 rows against their plain versions: fails where the
    route loses to either at 4096 rows or to the row tiles at 256; and K2b
    at 4096 and 256 rows (the step inputs from K2a, standard-normal
    cotangents, the step's weight layout prepared once) in turns on the wide
    backward, the row tiles (forced) and the float32 plain version: fails
    where a grad leaves the JAX grad bar of the plain version, is further
    from the float64 plain version than max(row tiles, twice the float32
    plain version), differs between two calls, or where the route loses at
    4096 rows to either or at 256 to the row tiles. Returns the launches by
    kernel and the table's rows."""
    import copy

    import numpy as np
    import torch

    from bcnf_tpu_torch.bridge import map_tree, tree_leaves
    from bcnf_tpu_torch.models import CondRealNVP
    from bcnf_tpu_torch.models.cnf import matmul_precision
    from bcnf_tpu_torch.ops import coupling_kernel as ck
    from bcnf_tpu_torch.ops import flow_kernel as fk
    from bcnf_tpu_torch.train import DeviceDataset, Trainer, make_optimizer

    name, T = os.path.basename(WIDE_CONFIG)[:-5], frames(cfg)
    H, size, d_a = model.nested_sizes[0], model.size, model.coupling.d_a
    hw = cfg["global"]["hybrid_weight"]
    src, rep = "bcnf_tpu_torch/ops/csrc/flow_wide_wgmma.cu", "bcnf_tpu/ops/flow_kernel.py"

    def plain(fn):  # fn on the plain path
        model.use_pallas = False
        try:
            return fn()
        finally:
            model.use_pallas = True

    def rel(a, b) -> float:  # max |a - b| over max(1, |b|)
        return ((a - b).abs() / b.abs().clamp(min=1.0)).max().item()

    # (a) log_prob and the forward of 4096 draws conditioned on the 8 trajectories
    d = LOGPROB_ROWS // N_COND
    y_lp = out[:d].reshape(-1, size).contiguous()
    traj = torch.from_numpy(rng.normal(size=(N_COND, T, 3)).astype(np.float32)).to(dev)
    cond_lp = traj.repeat(d, 1, 1)
    with torch.no_grad():
        zero_flow_counts()
        lp = model.log_prob(params, y_lp, cond_lp)
        z, ld = model.forward(params, y_lp, cond_lp)
        torch.cuda.synchronize()
        routes_a = dict(fk.fused_flow.route_launches)
        z_p, ld_p = plain(lambda: model.forward(params, y_lp, cond_lp))
    err_a = max((z - z_p).abs().max().item(), (ld - ld_p).abs().max().item())
    if routes_a != {fk.ROUTE_WIDE_FWD: 2} or not torch.isfinite(lp).all() or not err_a <= KERNEL_TOL:
        fail(f"{name}'s log_prob and forward launched K1 {routes_a} (expected 2 on {fk.ROUTE_WIDE_FWD}), z/logdet "
             f"{err_a:.3e} from the plain path (tolerance {KERNEL_TOL:g})")

    # (b) a validation pass: the config's validation rows in padded batches of its batch size
    B = int(cfg["training"]["batch_size"])
    n_val = int(round(cfg["data"]["n_samples"] * cfg["training"]["validation_split"]))
    y_val = rng.normal(size=(n_val, size)).astype(np.float32)
    t_val = rng.normal(size=(n_val, T, 3)).astype(np.float32)
    trainer = Trainer(cfg, data=(y_val, [t_val]), device=dev, seed=SEED, hybrid_weight=hw)
    val_set = DeviceDataset(y_val, [t_val], dev)
    zero_flow_counts()
    val = [trainer.val_step(model, [params], by, bc, bw) for by, bc, bw in val_set.batches_padded(B)]
    torch.cuda.synchronize()
    routes_b = dict(fk.fused_flow.route_launches)
    val_p = plain(lambda: [trainer.val_step(model, [params], by, bc, bw) for by, bc, bw in val_set.batches_padded(B)])
    n_batches = -(-n_val // B)
    err_b = max(rel(a, b) for v, vp in zip(val, val_p) for a, b in zip(v, vp))
    if routes_b != {fk.ROUTE_WIDE_FWD: n_batches} or not err_b <= KERNEL_TOL:
        fail(f"{name}'s validation pass launched K1 {routes_b} (expected {n_batches} on {fk.ROUTE_WIDE_FWD}); its "
             f"metrics {err_b:.3e} from the plain path's (tolerance {KERNEL_TOL:g} of their size)")

    # (c) one training step at batch B with the coupling dropout at 0: K2a on the wide forward, K2b on the wide backward
    cfg0 = copy.deepcopy(cfg)
    cfg0["model"]["kwargs"]["dropout"] = 0.0
    model0 = CondRealNVP.from_config(cfg0)
    y_tr, t_tr = y_val[:B], t_val[:B]
    trainer0 = Trainer(cfg0, data=(y_tr, [t_tr]), device=dev, seed=SEED, hybrid_weight=hw)
    yb, cb = torch.from_numpy(y_tr).to(dev), [torch.from_numpy(t_tr).to(dev)]

    def step(use_pallas: bool):
        model0.use_pallas = use_pallas
        p = map_tree(lambda t: t.detach().clone().requires_grad_(True), params)
        opt = make_optimizer("Adam", lr=2e-4).init(p)
        return trainer0.train_step(model0, [p], opt, yb, cb, [torch.Generator(device=dev).manual_seed(SEED)])

    zero_train_counts()
    metrics_c = step(True)
    torch.cuda.synchronize()
    c = train_counts()
    metrics_p = step(False)
    err_c = rel(metrics_c, metrics_p)
    if c["K2a"] != {fk.ROUTE_WIDE_FWD: 1} or c["K2b"] != {fk.ROUTE_WIDE_TRAIN: 1} or not err_c <= KERNEL_TOL:
        fail(f"{name}'s training step at dropout 0 launched K2a/K2b {c}, its metrics {err_c:.3e} from the plain "
             f"step's (tolerance {KERNEL_TOL:g} of their size)")
    # the step's grads, pulled back from standard-normal cotangents (`cotangent_loss`), against the plain step's
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    conds = [*cb, torch.randn(yb.shape, generator=g, device=dev), torch.randn(yb.shape[:1], generator=g, device=dev)]

    def step_grads(use_pallas: bool) -> list:
        model0.use_pallas = use_pallas
        p = map_tree(lambda t: t.detach().clone().requires_grad_(True), params)
        with matmul_precision(model0.precision):
            cotangent_loss(model0, p, yb, conds, None)[0].backward()
        return [t.grad for t in tree_leaves(p)]

    grads_c = [(a, b) for a, b in zip(step_grads(True), step_grads(False)) if b is not None]
    excess_c = max(grad_excess(a, b)[1] for a, b in grads_c)
    dmax_c = max(grad_excess(a, b)[0] for a, b in grads_c)
    if not excess_c <= 0:
        fail(f"{name}'s training step at dropout 0: a grad is {excess_c:.3e} past the JAX grad bar of the plain step's")

    # (d) the forward of the 4096 draws through K4, one launch a coupling
    model.use_pallas_coupling = True
    try:
        with torch.no_grad():
            zero_flow_counts()
            k4_before = ck.fused_affine_coupling.launches
            z4, ld4 = model.forward(params, y_lp, cond_lp)
            torch.cuda.synchronize()
            k4_launches = ck.fused_affine_coupling.launches - k4_before
            k4_flow = fk.fused_flow.launches
    finally:
        model.use_pallas_coupling = False
    err_d = max((z4 - z_p).abs().max().item(), (ld4 - ld_p).abs().max().item())
    if k4_launches != model.n_blocks or k4_flow or not err_d <= KERNEL_TOL:
        fail(f"{name}'s forward through K4 launched it {k4_launches} times (expected {model.n_blocks}), K1 "
             f"{k4_flow}; z/logdet {err_d:.3e} from the plain path")

    # (e) the kernels' times on validation-shaped rows, in turns with the row tiles (forced) and the plain version
    def turns(fns: dict, reps: int = 3) -> dict:
        times = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            times[k] += cuda_ms(fns[k], reps)
        return times

    names = ("an_scale", "an_bias", "ortho", "w1y", "b1", "wm", "bm", "wout", "bout")
    t4096 = torch.from_numpy(rng.normal(size=(LOGPROB_ROWS, T, 3)).astype(np.float32)).to(dev)
    x4096 = torch.randn((LOGPROB_ROWS, size), generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    ms, errs = {}, {}
    with torch.no_grad():
        kargs, hp = model._fused_flow_args(params, model.encode(params, (t4096,)))
        args = [kargs[n] for n in names]
        for rows in (LOGPROB_ROWS, B):
            x, h = x4096[:rows].contiguous(), hp[:, :rows].contiguous()
            k1 = lambda: fk.fused_flow(x, h, **kargs, inverse=False, n_cond=rows)

            def k1_rows():
                with row_tiles_forced("WIDE_FWD_MAX_TN"):
                    return k1()

            ms[rows] = turns({"wide": k1, "rows": k1_rows,
                              "plain": lambda: fk.fused_flow_reference(x, h, **kargs, inverse=False, n_cond=rows)})
            errs[rows] = max((a - b).abs().max().item() for a, b in zip(
                k1(), fk.fused_flow_reference(x, h, **kargs, inverse=False, n_cond=rows)))
        k2a = lambda: fk.fused_flow_train_fwd(x4096, hp, *args)
        k2a_plain = lambda: fk.fused_flow_train_reference(x4096, hp, *args)
        err_k2a = max((a - b).abs().max().item() for a, b in zip(k2a(), k2a_plain()))
        k2a_times = turns({"wide": k2a, "plain": k2a_plain})
        # K4: the first block's coupling, its 4096 rows' conditions
        layers = params["blocks"]["coupling"]["a"]["layers"]
        cw = dict(w1y=layers[0]["w"][0, :d_a].contiguous(), b1=layers[0]["b"][0].contiguous(),
                  wm=[p["w"][0].contiguous() for p in layers[1:-1]], bm=[p["b"][0].contiguous() for p in layers[1:-1]],
                  wout=layers[-1]["w"][0].contiguous(), bout=layers[-1]["b"][0].contiguous())
        c4 = hp[0, :, :H].contiguous()
        xa, xb = x4096[:, :d_a].contiguous(), x4096[:, d_a:].contiguous()
        k4 = lambda: ck.fused_affine_coupling(xa, xb, c4, **cw, n_cond=LOGPROB_ROWS)
        k4_plain = lambda: ck.fused_affine_coupling_reference(xa, xb, c4, **cw, inverse=False, n_cond=LOGPROB_ROWS)
        err_k4 = max((a - b).abs().max().item() for a, b in zip(k4(), k4_plain()))
        k4_times = turns({"wide": k4, "plain": k4_plain})
        # K2b on the step inputs of K2a, standard-normal cotangents, the step's weight layout prepared once
        ws = fk.train_weights(x4096, hp, kargs["wm"], d_a, fk.MODE_3XTF32)
        k2b_ms, k2b_err, k2b_share, k2b_faults = {}, 0.0, {}, []
        for rows in (LOGPROB_ROWS, B):
            xr, hr = x4096[:rows].contiguous(), hp[:, :rows].contiguous()
            bound = fk.fused_flow_train_fwd(xr, hr, *args, wstages=ws)[2]
            dz, dld = randn_cotangents(xr)
            wide = lambda: fk.fused_flow_train_bwd(bound, hr, dz, dld, *args, wstages=ws)
            k2b_plain = lambda: fk.fused_flow_train_backward_reference(bound, hr, dz, dld, *args)

            def k2b_rows():
                with row_tiles_forced("WIDE_TRAIN_MAX_TN"):
                    return wide()

            k2b_ms[rows] = turns({"wide": wide, "rows": k2b_rows, "plain": k2b_plain})
            one, two, tiles, p32 = wide(), wide(), k2b_rows(), k2b_plain()
            p64 = fk.fused_flow_train_backward_reference(bound.double(), hr.double(), dz.double(), dld.double(),
                                                         *[a.double() for a in args])
            share = 0.0
            for gname, a, b, r, p, d64 in zip(GRAD_NAMES, one, two, tiles, p32, p64):
                dk, dr, dp = ((t.double() - d64).abs().max().item() for t in (a, r, p))
                share = max(share, dk / max(dr, 2 * dp))
                if rows == LOGPROB_ROWS:
                    k2b_err = max(k2b_err, (a - p).abs().max().item())
                if grad_excess(a, p)[1] > 0 or not dk <= max(dr, 2 * dp) or not torch.equal(a, b):
                    k2b_faults.append(f"{gname} at {rows} rows: {grad_excess(a, p)[1]:.3e} past the grad bar, "
                                      f"{dk:.3e} from float64 (row tiles {dr:.3e}, plain {dp:.3e}), bit-equal "
                                      f"{torch.equal(a, b)}")
            k2b_share[rows] = share
            del one, two, tiles, p32, p64
    med = {rows: {k: median(v) for k, v in t.items()} for rows, t in ms.items()}
    work_k1 = {rows: flow_work(kargs, hp[:, :rows], rows, H) for rows in ms}
    rows_out = [
        kernel_row("fused_flow[forward, wide]", src, f"{rep}:162", routes_a[fk.ROUTE_WIDE_FWD] + n_batches,
                   errs[LOGPROB_ROWS], ms[LOGPROB_ROWS]["wide"], ms[LOGPROB_ROWS]["plain"], work_k1[LOGPROB_ROWS],
                   peaks, None, ARITH_3XTF32),
        kernel_row("K2a[3xtf32, wide] fused_flow_train_fwd", src, f"{rep}:558", c["K2a"][fk.ROUTE_WIDE_FWD], err_k2a,
                   k2a_times["wide"], k2a_times["plain"], train_work(kargs, hp, LOGPROB_ROWS, H)[0], peaks, None,
                   ARITH_3XTF32),
        kernel_row("K4 fused_affine_coupling[forward, wide]", src, "bcnf_tpu/ops/coupling_kernel.py:69", k4_launches,
                   err_k4, k4_times["wide"], k4_times["plain"],
                   coupling_work(cw, LOGPROB_ROWS, LOGPROB_ROWS, H, False), peaks, None, ARITH_3XTF32),
        kernel_row("K2b[3xtf32, wide] fused_flow_train_bwd", "bcnf_tpu_torch/ops/csrc/flow_wide_train_wgmma.cu",
                   f"{rep}:600", c["K2b"][fk.ROUTE_WIDE_TRAIN], k2b_err, k2b_ms[LOGPROB_ROWS]["wide"],
                   k2b_ms[LOGPROB_ROWS]["plain"], train_work(kargs, hp, LOGPROB_ROWS, H)[1], peaks, None,
                   ARITH_3XTF32),
    ]
    for row, what in zip(rows_out[1:], ("K2a", "K4's forward")):
        if not row["max_abs_err"] <= KERNEL_TOL:
            fail(f"{what} on the wide forward is {row['max_abs_err']:.3e} from its plain version")
    b256 = bound_ms(work_k1[B], peaks, ARITH_3XTF32)[0]
    print(f"[13 model zoo, wide forward] {name}: log_prob and the forward of {y_lp.shape[0]} draws, K1 launches "
          f"{routes_a}, z/logdet {err_a:.2e} from the plain path; validation of {n_val} rows in {n_batches} padded "
          f"batches of {B}: K1 launches {routes_b}, metrics {err_b:.2e} (relative) from the plain path's; a training "
          f"step at batch {B}, coupling dropout 0: K2a {c['K2a']}, K2b {c['K2b']}, metrics "
          f"{err_c:.2e} from the plain step's, its {len(grads_c)} grads max|d| {dmax_c:.2e} ({excess_c:.2e} from "
          f"the JAX grad bar); the forward through K4: {k4_launches} launches, {err_d:.2e} from the "
          f"plain path (tolerance {KERNEL_TOL:g})")
    print(f"    K1's forward in turns (tiles of {fk.wide_fwd_rows(LOGPROB_ROWS)} rows at {LOGPROB_ROWS}, "
          f"{fk.wide_fwd_rows(B)} at {B}): {LOGPROB_ROWS} rows wide {med[LOGPROB_ROWS]['wide']:.2f} ms, row tiles "
          f"(forced) {med[LOGPROB_ROWS]['rows']:.2f}, float32 plain {med[LOGPROB_ROWS]['plain']:.2f} (bound "
          f"{rows_out[0]['bound_ms']:.2f}); {B} rows wide {med[B]['wide']:.2f} ms, row tiles {med[B]['rows']:.2f}, "
          f"plain {med[B]['plain']:.2f} (bound {b256:.3f}); K2a at {LOGPROB_ROWS} rows {rows_out[1]['ms']:.2f} ms "
          f"(plain {rows_out[1]['plain_ms']:.2f}, bound {rows_out[1]['bound_ms']:.2f}); K4's forward "
          f"{rows_out[2]['ms']:.3f} ms (plain {rows_out[2]['plain_ms']:.3f}, bound {rows_out[2]['bound_ms']:.3f})")
    if not med[LOGPROB_ROWS]["wide"] < min(med[LOGPROB_ROWS]["rows"], med[LOGPROB_ROWS]["plain"]):
        fail(f"the wide forward ({med[LOGPROB_ROWS]['wide']:.2f} ms) loses to the row tiles "
             f"({med[LOGPROB_ROWS]['rows']:.2f}) or the plain version ({med[LOGPROB_ROWS]['plain']:.2f}) at "
             f"{LOGPROB_ROWS} rows")
    if not med[B]["wide"] < med[B]["rows"]:
        fail(f"the wide forward ({med[B]['wide']:.2f} ms) loses to the row tiles ({med[B]['rows']:.2f}) at {B} rows")
    m2 = {rows: {k: median(v) for k, v in t.items()} for rows, t in k2b_ms.items()}
    Hp = fk.padded_width(H)
    smem, resident, gw_smem, gw_blocks = fk.wide_train_card_layout(Hp, size, d_a)
    print(f"    K2b in turns (tiles of {fk.wide_fwd_rows(LOGPROB_ROWS)} rows at {LOGPROB_ROWS}, "
          f"{fk.wide_fwd_rows(B)} at {B}; rows kernel {smem} B of shared memory, {resident} clusters of "
          f"{Hp // 128} resident, weight-grad pass {gw_smem} B, {gw_blocks} blocks an SM): {LOGPROB_ROWS} rows wide "
          f"{m2[LOGPROB_ROWS]['wide']:.2f} ms, row tiles (forced) {m2[LOGPROB_ROWS]['rows']:.2f}, float32 plain "
          f"{m2[LOGPROB_ROWS]['plain']:.2f} (bound {rows_out[3]['bound_ms']:.2f}); {B} rows wide {m2[B]['wide']:.2f} "
          f"ms, row tiles {m2[B]['rows']:.2f}, plain {m2[B]['plain']:.2f}; grads from float64 at most "
          f"{max(k2b_share.values()):.3f} of max(row tiles, twice the float32 plain version), max|d| from the plain "
          f"version {k2b_err:.2e} at {LOGPROB_ROWS} rows")
    if k2b_faults:
        fail(f"K2b on the wide backward: " + "; ".join(k2b_faults))
    if not m2[LOGPROB_ROWS]["wide"] < min(m2[LOGPROB_ROWS]["rows"], m2[LOGPROB_ROWS]["plain"]):
        fail(f"the wide K2b ({m2[LOGPROB_ROWS]['wide']:.2f} ms) loses to the row tiles "
             f"({m2[LOGPROB_ROWS]['rows']:.2f}) or the plain version ({m2[LOGPROB_ROWS]['plain']:.2f}) at "
             f"{LOGPROB_ROWS} rows")
    if not m2[B]["wide"] < m2[B]["rows"]:
        fail(f"the wide K2b ({m2[B]['wide']:.2f} ms) loses to the row tiles ({m2[B]['rows']:.2f}) at {B} rows")
    launches = {"K1 forward, wide": rows_out[0]["launches"], "K2a, wide": rows_out[1]["launches"],
                "K4 forward, wide": k4_launches, "K2b, wide": rows_out[3]["launches"]}
    return launches, rows_out


def model_zoo(rng, dev, build_dir: str, peaks: tuple[float, float, float]) -> dict:
    """Phase 13: paths D, E, F and the two hybrids. Returns the launches of
    K1 (by direction) and of K3a/K3b on these paths."""
    t0 = time.perf_counter()
    d = zoo_path_d(rng, dev, build_dir, peaks)
    e = zoo_path_e(rng, dev)
    zoo_path_f(dev, build_dir)
    d["inverse"] += zoo_hybrids(rng, dev)
    print(f"    phase 13 took {time.perf_counter() - t0:.1f} s")
    return {"K1 inverse": d["inverse"], "K1 forward": d["forward"], **e}



# ---------------------------------------------------------------------------
# phase 14: the video path (CNN encoder, online training, video datasets,
# pretrained features) on `videos_CNN_LSTM_large` at its published widths
# ---------------------------------------------------------------------------

VIDEO_CONFIG = "{{BCNF_ROOT}}/configs/runs/videos_CNN_LSTM_large.yaml"
VIDEO_PARAMS = 67_787_515
CALIB2_CONFIG = "{{BCNF_ROOT}}/configs/runs/trajectory_LSTM_noisy_calib2.yaml"
ONLINE_STEPS = 16  # online steps at the published batch 64


def video_counts() -> dict:
    """`lstm_counts()` with K1's launches by direction: at the video model's
    padded width 544 K1's inverse runs on `wgmma` and its forward on the
    3xTF32 `wgmma` forward."""
    from bcnf_tpu_torch.ops.flow_kernel import ROUTE_FWD_WGMMA, ROUTE_WGMMA, fused_flow

    c = lstm_counts()
    del c["K1"]
    c["K1 inverse"] = fused_flow.route_launches.get(ROUTE_WGMMA, 0)
    c["K1 forward"] = fused_flow.route_launches.get(ROUTE_FWD_WGMMA, 0)
    return c


def cnn_at_decisions(net, params: dict, x, decisions: list | None = None) -> tuple:
    """The forward of a one-tower `CNN` (dropout off) as `CNN.apply`
    computes it, but with each layer's ReLU mask and 2x2 max-pool argmax
    taken from `decisions` (a (mask, indices) pair a layer; recorded where
    None). Returns (features, decisions). ReLU and max-pool route a grad by
    a comparison, so where two devices' float32 roundings fall on either
    side of a tie (a pre-activation at 0, two equal maxima), their grads
    differ by a whole activation's contribution: grads are compared at one
    device's decisions."""
    import torch.nn.functional as F

    B, n_cams, T, H, W = x.shape
    frames = x.transpose(0, 1).reshape(n_cams * B * T, 1, H, W)
    recorded = []
    for i, (p, (_, _, _, stride, pad)) in enumerate(zip(params["towers"][0], net.plan)):
        a = F.conv2d(frames, p["w"], p["b"], stride=stride, padding=pad)
        if decisions is None:
            frames, idx = F.max_pool2d(F.relu(a), 2, return_indices=True)
            mask = a > 0
        else:
            mask, idx = (t.to(a.device) for t in decisions[i])
            frames = (a * mask).flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
        recorded.append((mask, idx))
    y = frames.reshape(n_cams, B, T, -1).permute(1, 2, 0, 3).reshape(B, T, -1)
    return y @ params["head"]["w"] + params["head"]["b"], recorded


def video_cnn_check(cfg: dict, dev) -> float:
    """(a) The published CNN on the card against the CPU, same weights and
    2 videos of 2 cameras x 30 frames (dropout off): `CNN.apply`'s features
    at KERNEL_TOL; every weight grad (pulled back from a standard-normal
    cotangent) at the flow grad bar, both devices at the card's ReLU and
    max-pool decisions (those the CPU takes otherwise are counted). Returns
    the features' max |d|."""
    import torch

    from bcnf_tpu_torch.bridge import map_tree, tree_leaves
    from bcnf_tpu_torch.factories import FeatureNetworkFactory

    kw = dict(next(fn["kwargs"] for fn in cfg["feature_networks"] if fn["type"] == "CNN"))
    net = FeatureNetworkFactory.get_feature_network("CNN", kw)
    params = net.init(torch.Generator().manual_seed(SEED))
    gen = torch.Generator().manual_seed(SEED)
    x = torch.rand((2, 2, 30, *net.input_size), generator=gen)
    ct = torch.randn((2, 30, net.output_size_lin), generator=gen)
    card_params = map_tree(lambda t: t.to(dev), params)
    with torch.no_grad():
        feats = {"cpu": net.apply(params, x), "cuda": net.apply(card_params, x.to(dev)).cpu()}
        y_dec, dec = cnn_at_decisions(net, card_params, x.to(dev))
        _, cpu_dec = cnn_at_decisions(net, params, x)
    err = (feats["cuda"] - feats["cpu"]).abs().max().item()
    flips = [(int((m.cpu() != cm).sum()), int((i.cpu() != ci).sum())) for (m, i), (cm, ci) in zip(dec, cpu_dec)]
    grads = {}
    for d, p0, xd, ctd in (("cpu", params, x, ct), ("cuda", card_params, x.to(dev), ct.to(dev))):
        p = map_tree(lambda t: t.detach().clone().requires_grad_(True), p0)
        (cnn_at_decisions(net, p, xd, dec)[0] * ctd).sum().backward()
        grads[d] = [t.grad.cpu() for t in tree_leaves(p)]
    names = [f"{k} {i}.{j}" for i, tower in enumerate(params["towers"]) for j in range(len(tower)) for k in ("dw", "db")]
    worst = check_grads("CNN card vs CPU", names + ["dhead.w", "dhead.b"], grads["cuda"], grads["cpu"])
    print(f"[14 video: CNN] plan {net.plan}, {net.final_output_size} features a camera, head "
          f"{2 * net.final_output_size} -> {net.output_size_lin}: features on the card vs the CPU max|d| {err:.3e} "
          f"(tolerance {KERNEL_TOL:g}); weight grads at the card's ReLU and max-pool decisions max|d| {worst:.3e} "
          f"(the flow grad bar); decisions the CPU takes otherwise, (ReLU, max-pool) by layer: {flips} of "
          f"{[(int(m.numel()), int(i.numel())) for m, i in dec]}")
    if not err <= KERNEL_TOL or not torch.equal(y_dec.cpu(), feats["cuda"]):
        fail(f"the video CNN on the card disagrees with the CPU ({err:.3e}), or the check's forward is not CNN.apply's")
    return err


def video_lstm_kernels(rng, dev, peaks: tuple[float, float, float]) -> dict:
    """(b) K3a and K3b at the video model's LSTM (H = 212, so Hp = 224 and TN
    = 7; T = 30) against their plain versions at the online batch 64 and at
    eval's batches 100 (ranks, diagnostics) and 200 (test NLL), both
    directions; their times at B = 64 beside the bound and cuDNN. Launches
    here do not count."""
    import numpy as np
    import torch

    from bcnf_tpu_torch.ops.lstm import lstm_cell_init
    from bcnf_tpu_torch.ops.lstm_kernel import (
        fwd_layout,
        lstm_direction_bwd,
        lstm_direction_bwd_reference,
        lstm_direction_fwd,
        lstm_direction_fwd_reference,
    )

    T, H, F = 30, 212, 2 * 212  # layer 2's input; the kernels see only xp
    saved = lstm_direction_fwd.launches, lstm_direction_bwd.launches
    p = {k: v.to(dev) for k, v in lstm_cell_init(torch.Generator().manual_seed(SEED), F, H).items()}
    worst = {"K3a": 0.0, "K3b": 0.0}
    for B in (64, 100, 200):
        x = torch.from_numpy(rng.normal(size=(B, T, F)).astype(np.float32)).to(dev)
        with torch.no_grad():
            xp = (torch.matmul(x.transpose(0, 1), p["w_ih"]) + p["b_ih"] + p["b_hh"]).contiguous()
            for reverse in (False, True):
                hs, cs = lstm_direction_fwd(xp, p["w_hh"], reverse)
                hs_r, cs_r = lstm_direction_fwd_reference(xp, p["w_hh"], reverse)
                err = max((hs - hs_r).abs().max().item(), (cs - cs_r).abs().max().item())
                dhs = torch.randn(hs.shape, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
                got = lstm_direction_bwd(xp, p["w_hh"], hs, cs, dhs, reverse)
                ref = lstm_direction_bwd_reference(xp, p["w_hh"], hs, cs, dhs, reverse)
                torch.cuda.synchronize()
                if not err <= LSTM_TOL:
                    fail(f"K3a at H={H} (B={B}, reverse={reverse}) disagrees with plain: {err:.3e} > {LSTM_TOL:g}")
                worst["K3a"] = max(worst["K3a"], err)
                worst["K3b"] = max(worst["K3b"], check_grads(
                    f"K3b H={H} B={B} {'reverse' if reverse else 'forward'}", LSTM_GRADS, got, ref, LSTM_GRAD_ATOL,
                    LSTM_GRAD_RTOL))
    if (lstm_direction_fwd.launches - saved[0], lstm_direction_bwd.launches - saved[1]) != (6, 6):
        fail("the LSTM kernels did not count their launches at H=212")
    B = 64
    x = torch.from_numpy(rng.normal(size=(B, T, F)).astype(np.float32)).to(dev)
    with torch.no_grad():
        xp = (torch.matmul(x.transpose(0, 1), p["w_ih"]) + p["b_ih"] + p["b_hh"]).contiguous()
        hs, cs = lstm_direction_fwd(xp, p["w_hh"], False)
        dhs = torch.randn(hs.shape, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
        t = {
            "K3a": cuda_ms(lambda: lstm_direction_fwd(xp, p["w_hh"], False), reps=5),
            "K3a plain": cuda_ms(lambda: lstm_direction_fwd_reference(xp, p["w_hh"], False), reps=3),
            "K3b": cuda_ms(lambda: lstm_direction_bwd(xp, p["w_hh"], hs, cs, dhs, False), reps=5),
            "K3b plain": cuda_ms(lambda: lstm_direction_bwd_reference(xp, p["w_hh"], hs, cs, dhs, False), reps=3),
        }
        run = cudnn_lstm(p, F, H, False, dev)
        t["cuDNN forward"] = cuda_ms(lambda: run(x), reps=5)
    xg = x.clone().requires_grad_(True)
    dy = dhs.transpose(0, 1).contiguous()

    def fwd_bwd():
        run(xg).backward(dy)

    t["cuDNN forward + backward"] = cuda_ms(fwd_bwd, reps=5)
    lstm_direction_fwd.launches, lstm_direction_bwd.launches = saved
    med = {k: median(v) for k, v in t.items()}
    fwd_work, bwd_work = lstm_work(T, B, H)
    lay = fwd_layout(B, H, dev)
    video = {}
    for k, work, lib in (("K3a", fwd_work, med["cuDNN forward"]),
                         ("K3b", bwd_work, med["cuDNN forward + backward"] - med["cuDNN forward"])):
        bound, by = bound_ms(work, peaks, ARITH_3XTF32)
        video[k] = {"video_shape": f"B {B}, T {T}, H {H} (Hp 224)", "video_ms": med[k],
                    "video_plain_ms": med[f"{k} plain"], "video_bound_ms": bound, "video_bound_by": by,
                    "video_library_ms": lib, "video_max_abs_err": worst[k]}
    print(f"[14 video: LSTM kernels] K3a/K3b at H={H} (Hp 224, TN 7), T={T}, B=64/100/200, both directions, vs plain: "
          f"K3a max|d| hs, cs {worst['K3a']:.3e} (tolerance {LSTM_TOL:g}), K3b grads max|d| {worst['K3b']:.3e}; "
          f"layout at B=64: clusters of 8 blocks own {lay['rows']} rows, {lay['clusters']} cluster(s), "
          f"{lay['resident_clusters']} resident at once; times at B=64 (CUDA events, median; ms): "
          f"K3a {med['K3a']:.3f} (bound {video['K3a']['video_bound_ms']:.4f}, {video['K3a']['video_bound_by']}), "
          f"plain {med['K3a plain']:.3f}, cuDNN forward {med['cuDNN forward']:.3f}; K3b {med['K3b']:.3f} (bound "
          f"{video['K3b']['video_bound_ms']:.4f}), plain {med['K3b plain']:.3f}, cuDNN backward "
          f"{video['K3b']['video_library_ms']:.3f}")
    return video


def video_step_split(model, params: dict, opt, sim, batch: int, gen) -> tuple[list[float], list[float]]:
    """CUDA-event split of one online video step (ms, median of 3):
    simulate + render, CNN, LSTM, flow forward (with the NLL), backward,
    clip + Adam; and the steps' losses."""
    import torch

    from bcnf_tpu_torch.utils.misc import inn_nll_loss

    nets, fns = params["features"]["nets"], model.features.feature_networks  # concat, CNN, LSTM, concat
    splits, losses = [], []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        opt.zero_grad()
        ev[0].record()
        y, (videos, meta) = sim.sample_batch(gen, batch)
        ev[1].record()
        f = fns[1].apply(nets[1], videos, gen, train=True)
        ev[2].record()
        h = torch.cat([fns[2].apply(nets[2], f, gen, train=True), meta], dim=-1)
        ev[3].record()
        model.encode = lambda *_a, **_k: h  # the flow alone, on this step's condition
        z, ld = model.forward(params, y, videos, meta, generator=gen, train=True)
        del model.encode
        loss = inn_nll_loss(z, ld)
        ev[4].record()
        loss.backward()
        ev[5].record()
        opt.step()
        ev[6].record()
        torch.cuda.synchronize()
        splits.append([ev[i].elapsed_time(ev[i + 1]) for i in range(6)])
        losses.append(loss.item())
    return [sorted(c)[1] for c in zip(*splits)], losses


def video_online(cfg: dict, dev, tmp: str) -> tuple[dict, str]:
    """(c) `train --online` on the published config at its batch 64 for
    ONLINE_STEPS steps with the fused LSTM: losses, launches held exact;
    then, on the trained params, videos/s over 5 steps, a step split and a
    profiled step. Returns the launches and the model directory."""
    import numpy as np
    import torch

    import bcnf_tpu_torch.__main__ as cli
    from bcnf_tpu_torch.bridge import map_tree, params_from_numpy, tree_leaves
    from bcnf_tpu_torch.config import load_config, load_yaml
    from bcnf_tpu_torch.models import CondRealNVP, count_params
    from bcnf_tpu_torch.train import make_optimizer
    from bcnf_tpu_torch.train.online import OnlineSimulator

    model_dir = os.path.join(tmp, "online")
    fused_lstm(True)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    cli.main(["train", "-c", VIDEO_CONFIG, "-o", model_dir, "--online", "--online-steps", str(ONLINE_STEPS),
              "--seed", str(SEED)])
    torch.cuda.synchronize()
    t_cli, c = time.perf_counter() - t0, video_counts()
    with open(os.path.join(model_dir, "config.json")) as f:
        meta = json.load(f)
    with open(os.path.join(model_dir, "params.pkl"), "rb") as f:
        trained_np = pickle.load(f)
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f if line.strip()]
    evals = 4  # train_online's default eval batches, after the last step
    expected = {"K3a": 4 * (1 + ONLINE_STEPS + evals), "K3b": 4 * ONLINE_STEPS, "K2a": 0, "K2b": 0,
                "K1 inverse": 0, "K1 forward": evals}
    losses = [v for k in ("train_loss", "eval_nll") for _, v in meta["history_tail"][k]]
    if c != expected:
        fail(f"train --online launched {c}, expected {expected} (2 layers x 2 directions; the ActNorm init, "
             f"{ONLINE_STEPS} steps, {evals} eval batches through K1's forward)")
    if not (meta.get("online") is True and np.all(np.isfinite(losses))
            and all(np.isfinite(a).all() for a in tree_leaves(trained_np))):
        fail(f"train --online wrote {meta} or non-finite params")

    model = CondRealNVP.from_config(load_config(VIDEO_CONFIG))
    params = map_tree(lambda t: t.requires_grad_(True), params_from_numpy(trained_np, dev))
    if count_params(params) != VIDEO_PARAMS:
        fail(f"videos_CNN_LSTM_large has {count_params(params):,} params, expected {VIDEO_PARAMS:,}")
    data = cfg["data"]
    sim = OnlineSimulator(load_yaml(data["config_file"]), model.parameter_index_mapping,
                          condition_groups=cfg["global"]["conditions"], dt=float(data["dt"]), T=float(data["T"]),
                          num_cams=int(data["num_cams"]))
    B = int(cfg["training"]["batch_size"])
    opt = make_optimizer("Adam", lr=2e-4).init(params)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    split, step_losses = video_step_split(model, params, opt, sim, B, gen)

    def step():
        opt.zero_grad()
        y, conds = sim.sample_batch(gen, B)
        z, ld = model.forward(params, y, *conds, generator=gen, train=True)
        (0.5 * torch.sum(z**2, dim=1) - ld).mean().backward()
        opt.step()

    video_rates = {}
    for on in (True, False):  # K3a/K3b, then the time loop
        fused_lstm(on)
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        video_rates[on] = 5 * B / (time.perf_counter() - t0)
    fused_lstm(True)
    rate = video_rates[True]
    LSTM_TABLE[f"videos_CNN_LSTM_large, online step at {B}"] = (video_rates[True], video_rates[False], "videos/s")
    torch.cuda.reset_peak_memory_stats()
    device_profile(step, f"one online video step at batch {B}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[14 video: train --online] videos_CNN_LSTM_large ({VIDEO_PARAMS:,} params; CNN -> LSTM H 212 -> "
          f"{model.n_conditions} conditions; flow {model.n_blocks} blocks of {len(model.nested_sizes)} x "
          f"{model.nested_sizes[0]}, coupling dropout {model.dropout}) from its published config, BCNF_FUSED_LSTM=1: "
          f"{ONLINE_STEPS} steps at batch {B}, a fresh batch simulated and rendered on the card each step, in "
          f"{t_cli:.2f} s (CLI, with the ActNorm init and the eval); launches {c} (held); logged "
          f"{[{k: round(v, 3) for k, v in r.items() if k != 'step'} for r in logged]}; history tail "
          f"{meta['history_tail']}")
    print(f"    trained params: {rate:.1f} videos/s (5 steps at batch {B}; each video 2 cameras x {sim.n_steps} frames "
          f"of 90 x 160); step split (CUDA events, median of 3, ms): simulate + render {split[0]:.2f}, CNN {split[1]:.2f}, "
          f"LSTM {split[2]:.2f}, flow forward {split[3]:.2f}, backward {split[4]:.2f}, clip + Adam {split[5]:.2f} "
          f"(sum {sum(split):.2f}); the split's losses {', '.join(f'{v:.3f}' for v in step_losses)}; peak device "
          f"memory of the profiled step {peak_gb:.2f} GB")
    if not np.all(np.isfinite(step_losses)):
        fail(f"online video steps gave non-finite losses {step_losses}")
    return c, model_dir


def video_generate_sample_eval(cfg: dict, model_dir: str, dev, tmp: str) -> tuple[dict, str]:
    """(d) `generate --output-type videos --renderer analytic` of 200
    held-out points on the card; (e) `sample` and `eval` at its defaults on
    the online-trained model: K1's launches by direction, route and rows,
    `report.json`'s keys, and the test NLL of 8 points on the card against
    the CPU plain path at phase 12's bar. Returns the launches."""
    import numpy as np
    import torch

    import bcnf_tpu_torch.__main__ as cli
    from bcnf_tpu_torch.bridge import map_tree, params_from_numpy
    from bcnf_tpu_torch.config import load_config
    from bcnf_tpu_torch.models import CondRealNVP
    from bcnf_tpu_torch.train.data import TrainerDataHandler
    from bcnf_tpu_torch.utils.io import load_data
    from bcnf_tpu_torch.utils.misc import inn_nll_loss

    from bcnf_tpu_torch.simulation.physics import n_steps_for

    n_test, data = 200, cfg["data"]
    n_frames = n_steps_for(float(data["T"]), float(data["dt"]))
    test_set = os.path.join(tmp, "test_videos.pkl")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli.main(["generate", "-c", PRIOR_CONFIG, "-o", test_set, "-n", str(n_test), "--output-type", "videos",
              "--renderer", "analytic", "--no-filter", "--dt", str(data["dt"]), "-T", str(data["T"]),
              "--seed", str(SEED + 1)])
    t_gen = time.perf_counter() - t0
    videos = np.asarray(load_data(test_set, keep_output_type="videos")["videos"])
    if videos.shape != (n_test, 2, n_frames, 90, 160) or not np.isfinite(videos).all():
        fail(f"generate --output-type videos gave {videos.shape}, finite={np.isfinite(videos).all()}")
    print(f"[14 video: generate] {n_test} videos (2 cameras x {n_frames} frames of 90 x 160, analytic renderer, no filter) "
          f"on the card in {t_gen:.2f} s, with the pickle; mean frame mass {videos.sum(axis=(3, 4)).mean():.3f}")

    zero_counts()
    out = os.path.join(tmp, "video_samples.npy")
    with K1Recorder() as k1_sample:
        cli.main(["sample", "-m", model_dir, "-d", test_set, "-n", "1000", "-o", out, "--seed", "1"])
    samples = np.load(out)
    c_sample = video_counts()
    if samples.shape != (1000, n_test, 19) or not np.isfinite(samples).all() or c_sample["K1 inverse"] != 1:
        fail(f"sample gave {samples.shape}, finite={np.isfinite(samples).all()}, K1 {k1_sample.summary()}")
    zero_counts()
    with K1Recorder() as k1:
        (report, figs, stages), t_eval = run_eval(["eval", "-m", model_dir, "-d", test_set, "-o",
                                                   os.path.join(tmp, "video_report")])
    c_eval = video_counts()
    launches = k1.summary()
    expected = {("inverse", "wgmma", 100 * 1000): 2 * 10, ("inverse", "wgmma", 100 * 128): 2 * 4,
                ("inverse", "wgmma", n_test * 250): 4, ("forward", "fwd_wgmma", n_test): 1}
    keys = {"test_nll", "n_points", "M_samples", "rank_mean_frac", "max_scaled_cdf_residual",
            "max_scaled_cdf_residual_all_dims", "scaled_cdf_residual_by_dim", "degenerate_dims", "sup_band_99",
            "n_nondegenerate_dims", "sup_band_99_joint", "calibration_pass_per_dim_band",
            "calibration_pass_joint_band", "calibration_verdict_by_dim", "posterior_width_by_dim",
            "posterior_bias_by_dim", "data_spread_by_dim", "resim_median_mse_mean", "resim_finite_frac",
            "impact_median_dist", "impact_rmse_within_42m", "impact_inlier_frac", "impact_defined_frac"}
    with open(os.path.join(tmp, "video_report", "report.json")) as f:
        written = json.load(f)
    if launches != expected:
        fail(f"eval launched K1 {launches}, expected {expected}")
    if set(written) != keys or not np.isfinite(report["test_nll"]) or report["n_points"] != n_test:
        fail(f"eval's report.json has keys {sorted(written)}, not the JAX package's")
    ranks = figs["ranks"]
    if ranks.shape != (n_test, 19) or ranks.min() < 0 or ranks.max() > report["M_samples"]:
        fail(f"eval's ranks have shape {ranks.shape} and range {ranks.min()}-{ranks.max()}")
    # the test NLL of 8 points: the card's forward (K1) against the CPU plain path
    run_cfg = load_config(VIDEO_CONFIG)
    model = CondRealNVP.from_config(run_cfg)
    with open(os.path.join(model_dir, "params.pkl"), "rb") as f:
        trained_np = pickle.load(f)
    y_test, conds = TrainerDataHandler().get_data_for_training(
        {k.lower(): v for k, v in dict(run_cfg, data=dict(run_cfg["data"], path=test_set)).items()},
        model.parameter_index_mapping)
    y8, c8 = torch.from_numpy(y_test[:8]), [torch.from_numpy(c[:8]) for c in conds]
    params = params_from_numpy(trained_np, dev)
    with torch.no_grad():
        z_card, ld_card = model.forward(params, y8.to(dev), *[c.to(dev) for c in c8])
        z_cpu, ld_cpu = model.forward(map_tree(lambda t: t.cpu(), params), y8, *c8)
    nll_card, nll_cpu = inn_nll_loss(z_card, ld_card).item(), inn_nll_loss(z_cpu, ld_cpu).item()
    nll_bar = KERNEL_TOL * (z_cpu.abs().sum(dim=1).mean().item() + 1) + 19 * KERNEL_TOL**2
    nll_d = abs(nll_card - nll_cpu)
    zero_counts()
    print(f"[14 video: sample, eval] sample 1000 x {n_test}: K1 {k1_sample.summary()}; eval at its defaults (200 "
          f"points, M {report['M_samples']}, 1000 resimulation draws) {t_eval:.2f} s, stages (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()) +
          f"; K1 launches (direction, route, rows): {launches}; K3a {c_eval['K3a']}; report.json has the JAX "
          f"package's {len(keys)} keys; test NLL {report['test_nll']:.3f}, rank mean fraction "
          f"{report['rank_mean_frac']:.3f}, max scaled CDF residual {report['max_scaled_cdf_residual']:.2f}, "
          f"resimulation finite {report['resim_finite_frac']:.3f}; test NLL of 8 points on the card {nll_card:.6f} "
          f"vs the CPU plain path {nll_cpu:.6f}: |d| {nll_d:.2e} (bar {nll_bar:.2e})")
    if not nll_d <= nll_bar:
        fail(f"the video model's test NLL on the card is {nll_d:.3e} from the CPU plain path's (bar {nll_bar:.3e})")
    return {k: c_sample[k] + c_eval[k] for k in c_eval}, test_set


def video_offline(dev, tmp: str, online_dir: str) -> dict:
    """(f) one `Trainer` epoch through the `train` CLI on 160 videos it
    generates on the card (no dataset on disk), batch 64: 2 steps and a
    validation batch, launches held; (h) `train --pretrained-features` from
    (c)'s params.pkl with `--freeze-features` on the same data: the features
    it writes are (c)'s, bit for bit. Returns the launches of both runs."""
    import numpy as np
    import torch
    import yaml

    import bcnf_tpu_torch.__main__ as cli
    from bcnf_tpu_torch.bridge import tree_leaves
    from bcnf_tpu_torch.config import sub_root_path

    with open(sub_root_path(VIDEO_CONFIG)) as f:
        cfg = yaml.safe_load(f)
    data_dir = os.path.join(tmp, "train_videos")
    cfg["data"].update(path=data_dir, n_samples=160)
    cfg["training"]["n_epochs"] = 1
    cfg_path = os.path.join(tmp, "video_run.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    n, B = cfg["data"]["n_samples"], int(cfg["training"]["batch_size"])
    n_train = n - int(round(cfg["training"]["validation_split"] * n))  # 128 of 160 at the published split
    steps, val_batches = n_train // B, -(-(n - n_train) // B)
    expected = {"K3a": 4 * (1 + steps + val_batches), "K3b": 4 * steps, "K2a": 0, "K2b": 0, "K1 inverse": 0,
                "K1 forward": val_batches}
    counts = {}
    for what, extra in (("Trainer epoch", []),
                        ("pretrained", ["--pretrained-features", os.path.join(online_dir, "params.pkl"),
                                        "--freeze-features", "-d", os.path.join(data_dir, "data.pkl")])):
        model_dir = os.path.join(tmp, what.split()[0])
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        cli.main(["train", "-c", cfg_path, "-o", model_dir, "--seed", str(SEED), *extra])
        torch.cuda.synchronize()
        secs, c = time.perf_counter() - t0, video_counts()
        counts[what] = c
        with open(os.path.join(model_dir, "params.pkl"), "rb") as f:
            trained = pickle.load(f)
        if c != expected or not all(np.isfinite(a).all() for a in tree_leaves(trained)):
            fail(f"{what}: train launched {c} (expected {expected}) or wrote non-finite params")
        if what == "pretrained":
            with open(os.path.join(online_dir, "params.pkl"), "rb") as f:
                source = pickle.load(f)
            same = all(np.array_equal(a, b) for a, b in zip(tree_leaves(trained["features"]),
                                                            tree_leaves(source["features"])))
            moved = not np.array_equal(trained["final"]["a"]["layers"][0]["w"], source["final"]["a"]["layers"][0]["w"])
            print(f"[14 video: pretrained] train --pretrained-features (c)'s params.pkl --freeze-features, 1 epoch "
                  f"({steps} steps of {B}): {secs:.2f} s; launches {c}; features after the steps equal (c)'s bit for "
                  f"bit: {same}; the flow moved: {moved}")
            if not (same and moved):
                fail("the pretrained features changed under --freeze-features, or the flow did not train")
        else:
            print(f"[14 video: Trainer] train CLI on {n} videos generated on the card (no filter, dt "
                  f"{cfg['data']['dt']}), 1 epoch ({steps} steps of {B} + {val_batches} validation batch(es)): "
                  f"{secs:.2f} s; launches {c} (held)")
    return {k: sum(c[k] for c in counts.values()) for k in expected}


def calib2_online(dev, tmp: str) -> None:
    """(g) `train --online --online-steps` on the noisy calibration config
    calib2 (observation noise 1.5, LSTM H 64): the trajectory branch with
    noise, as the JAX package's `*_online` calibration runs were trained;
    the fused LSTM's launches held."""
    import numpy as np
    import torch

    import bcnf_tpu_torch.__main__ as cli
    from bcnf_tpu_torch.config import load_config
    from bcnf_tpu_torch.models import CondRealNVP

    steps, model_dir = 8, os.path.join(tmp, "calib2")
    fused_lstm(True)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    cli.main(["train", "-c", CALIB2_CONFIG, "-o", model_dir, "--online", "--online-steps", str(steps),
              "--online-lr-decay", "--seed", str(SEED)])
    torch.cuda.synchronize()
    secs, c = time.perf_counter() - t0, lstm_counts()
    with open(os.path.join(model_dir, "config.json")) as f:
        meta = json.load(f)
    model = CondRealNVP.from_config(load_config(CALIB2_CONFIG))
    k1 = 4 if model._fused_flow_takes() else 0
    expected = {"K3a": 4 * (1 + steps + 4), "K3b": 4 * steps, "K1": k1, "K2a": 0, "K2b": 0}
    losses = [v for k in ("train_loss", "eval_nll") for _, v in meta["history_tail"][k]]
    print(f"[14 video: calib2 online] trajectory_LSTM_noisy_calib2 (observation noise "
          f"{load_config(CALIB2_CONFIG)['data']['observation_noise']}), train --online --online-steps {steps} "
          f"--online-lr-decay at batch {load_config(CALIB2_CONFIG)['training']['batch_size']}: {secs:.2f} s; launches "
          f"{c}; history tail {meta['history_tail']}")
    if c != expected or not np.all(np.isfinite(losses)):
        fail(f"calib2's online run launched {c} (expected {expected}) or logged non-finite losses {losses}")


def video_path(rng, dev, build_dir: str, peaks: tuple[float, float, float]) -> tuple[dict, dict]:
    """Phase 14: (a)-(h). Returns each kernel's launches on the video model's
    runs ((c), (e), (f), (h); counts zeroed before each and read after) and
    K3a's and K3b's times at H = 212."""
    import torch
    import yaml

    from bcnf_tpu_torch.config import sub_root_path

    t0 = time.perf_counter()
    with open(sub_root_path(VIDEO_CONFIG)) as f:
        cfg = yaml.safe_load(f)
    video_cnn_check(cfg, dev)
    lstm_video = video_lstm_kernels(rng, dev, peaks)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        c_online, online_dir = video_online(cfg, dev, tmp)
        c_eval, _ = video_generate_sample_eval(cfg, online_dir, dev, tmp)
        c_offline = video_offline(dev, tmp, online_dir)
        calib2_online(dev, tmp)
    torch.cuda.synchronize()
    launches = {k: c_online[k] + c_eval[k] + c_offline[k] for k in c_online}
    print(f"    phase 14 took {time.perf_counter() - t0:.1f} s; the video model's launches ((c), (e), (f), (h)): "
          f"{launches}")
    return launches, lstm_video


# ---------------------------------------------------------------------------
# phase 15: the reduced matmul precisions (one TF32 pass in K1, K2a, K2b and
# K4) and the hpo path
# ---------------------------------------------------------------------------

# The JAX package's bar for its reduced kernel mode against float32
# (tests/test_flow_kernel.py:130-141): max |d| of values; grads at that bar
# times max(1, max |plain|). The one-pass kernels are held to it against
# their plain one-pass versions (`mm=ops/tf32.py::matmul_tf32`, every MLP
# product rounded; the kernels keep the narrow products float32 FMA) and
# against the 3xTF32 kernels, and must differ from the 3xTF32 kernel by more
# than twice its own distance from float32: the one pass is not a no-op.
REDUCED_TOL = 5e-3
# the JAX CLI's advertised BF16_BF16_F32_X3 round trip on a TPU
# (results/precision_sweep.json): printed beside the port's, not a bar
JAX_X3_ROUND_TRIP = 1.82e-3


def one_pass_counts() -> dict:
    """Launches of the one-pass kernels by route: K1 (the flagship's inverse
    on `wgmma`, its forward on the `wgmma` forward; the forward's row tiles
    where phase 15 (c) forces them), K2a (the `wgmma` forward; the row tiles
    where forced), K2b (the flagship's on `wgmma`; the row tiles where
    forced), and the weight preparation K2a and K2b share."""
    from bcnf_tpu_torch.ops.flow_kernel import (
        ROUTE_FWD_WGMMA_TF32, ROUTE_ROWS_TF32, ROUTE_WGMMA_TF32, fused_flow, fused_flow_train_bwd,
        fused_flow_train_fwd, prepare_train_weights,
    )

    return {"K1 inverse": fused_flow.route_launches[ROUTE_WGMMA_TF32],
            "K1 forward": fused_flow.route_launches[ROUTE_FWD_WGMMA_TF32],
            "K1 forward row tiles": fused_flow.route_launches[ROUTE_ROWS_TF32],
            "K2a": fused_flow_train_fwd.route_launches[ROUTE_FWD_WGMMA_TF32],
            "K2a row tiles": fused_flow_train_fwd.route_launches[ROUTE_ROWS_TF32],
            "K2b": fused_flow_train_bwd.route_launches[ROUTE_WGMMA_TF32],
            "K2b row tiles": fused_flow_train_bwd.route_launches[ROUTE_ROWS_TF32],
            "K2b prep": prepare_train_weights.pass_launches[1]}


def zero_all_counts() -> None:
    from bcnf_tpu_torch.ops.coupling_kernel import fused_affine_coupling
    from bcnf_tpu_torch.ops.flow_kernel import fused_flow_train_bwd, fused_flow_train_fwd, prepare_train_weights

    zero_counts()
    fused_affine_coupling.launches = prepare_train_weights.launches = 0
    prepare_train_weights.pass_launches.clear()
    for fn in (fused_flow_train_fwd, fused_flow_train_bwd, fused_affine_coupling):
        fn.mode_launches.clear()
    fused_flow_train_fwd.route_launches.clear()
    fused_flow_train_bwd.route_launches.clear()


@contextlib.contextmanager
def row_tiles_forced(max_tn: str = "TRAIN_WGMMA_MAX_TN"):
    """The one-pass row tiles in place of a `wgmma` route, by the module
    constant that forces them: K2b's (`TRAIN_WGMMA_MAX_TN = 0`), or the
    forward's, K1's, K2a's and K4's (`FWD_WGMMA_MAX_TN = 0`)."""
    from bcnf_tpu_torch.ops import flow_kernel as fk

    widest = getattr(fk, max_tn)
    setattr(fk, max_tn, 0)
    try:
        yield
    finally:
        setattr(fk, max_tn, widest)


def _worst_rel(grads, ref) -> float:
    """The largest max |d| over the grads, each over max(1, max |ref|)."""
    return max((a - b).abs().max().item() / max(1.0, b.abs().max().item()) for a, b in zip(grads, ref))


def one_pass_k2b(bound, hpt, dz, dld, args: list, g3, work: tuple[float, float], peaks, dev) -> list[dict]:
    """Phase 15 (a), K2b in one pass at the flagship's batch-4096 inputs: its
    `wgmma` route (csrc/flow_train_wgmma.cu) and the one-pass row tiles
    forced on the same inputs, each held against the plain one-pass version
    (every grad within REDUCED_TOL max(1, max |plain|)) and the 3xTF32 kernel
    `g3`; the `wgmma` route no further from the plain one-pass version than
    twice the row tiles' own distance, and two of its calls equal to the bit.
    Each route's time (median of 5), its parts (rows, weight grads, the rest,
    on weights prepared once, and the weight preparation alone), its bound
    and rate, its blocks and waves; the new kernels' ptxas lines. Returns the
    two kernel rows (launches filled in later)."""
    import torch

    from bcnf_tpu_torch.ops import _build
    from bcnf_tpu_torch.ops import flow_kernel as fk
    from bcnf_tpu_torch.ops.tf32 import matmul_tf32

    named = dict(zip(TRAIN_ARGS, args))
    B, Hp = dz.shape[0], hpt.shape[-1]
    size, d_a, nh = dz.shape[1], named["w1y"].shape[1], named["wm"].shape[1]
    with torch.no_grad():
        plain = fk.fused_flow_train_backward_reference(bound, hpt, dz, dld, *args, mm=matmul_tf32)
        wg = fk.fused_flow_train_bwd(bound, hpt, dz, dld, *args, mode=fk.MODE_TF32)
        wg2 = fk.fused_flow_train_bwd(bound, hpt, dz, dld, *args, mode=fk.MODE_TF32)
        with row_tiles_forced():
            tiles = fk.fused_flow_train_bwd(bound, hpt, dz, dld, *args, mode=fk.MODE_TF32)
        torch.cuda.synchronize()
    route = fk.train_bwd_route(Hp, size, d_a, nh, fk.MODE_TF32)
    if route != fk.ROUTE_WGMMA_TF32:
        fail(f"K2b one pass at the flagship's shape takes route {route}, not {fk.ROUTE_WGMMA_TF32}")
    faults = []
    for what, got in (("wgmma", wg), ("row tiles", tiles)):
        for name, a, p, c in zip(GRAD_NAMES, got, plain, g3):
            bar = REDUCED_TOL * max(1.0, p.abs().max().item())
            if not ((a - p).abs().max().item() <= bar and (a - c).abs().max().item() <= bar):
                faults.append(f"{what} {name} {(a - p).abs().max().item():.3e}/{(a - c).abs().max().item():.3e} "
                              f"past {bar:.3g}")
    if faults:
        fail("K2b one pass (vs plain one pass / vs 3xTF32): " + "; ".join(faults))
    if not all(torch.equal(a, b) for a, b in zip(wg, wg2)):
        fail("K2b one pass on wgmma: two calls on the same inputs differ")
    dist = {"wgmma": _worst_rel(wg, plain), "row tiles": _worst_rel(tiles, plain)}
    if not dist["wgmma"] <= 2 * dist["row tiles"]:
        fail(f"K2b one pass on wgmma is {dist['wgmma']:.3e} from the plain one-pass version, past twice the row "
             f"tiles' {dist['row tiles']:.3e} (largest max|d| / max(1, max|plain|) over the grads)")
    kernel = "?"
    for line in _build.build_logs.get(fk.TRAIN_BWD_LIBRARY[fk.ROUTE_WGMMA_TF32], "").splitlines():
        if "Compiling entry function" in line:
            kernel = kernel_label(line)
        elif ("registers" in line or "spill" in line) and "17>" in kernel:
            print(f"    ptxas K2b wgmma route {kernel}: {line.strip().removeprefix('ptxas info    : ')}")

    wstages = fk.prepare_train_weights(named["wm"])
    wstages_plain = fk.prepare_train_weights_reference(named["wm"])
    torch.cuda.synchronize()
    if not torch.equal(wstages.view(torch.int32), wstages_plain.view(torch.int32)):
        fail("K2b's weight preparation on the card differs from its plain version")
    prep = median(cuda_ms(lambda: fk.prepare_train_weights(named["wm"]), reps=5))
    w_bytes = 4.0 * named["wm"].numel()
    prep_row = kernel_row("K2b[tf32] prepare_train_weights", "bcnf_tpu_torch/ops/csrc/flow_train_wgmma.cu",
                          "bcnf_tpu/ops/flow_kernel.py:600", 0, 0.0, cuda_ms(lambda: fk.prepare_train_weights(
                              named["wm"]), reps=5), cuda_ms(lambda: fk.prepare_train_weights_reference(named["wm"]),
                                                             reps=3), (0.0, 3 * w_bytes), peaks, None, ARITH_TF32)
    print(f"    K2b's weight preparation (prepare_kernel, both layouts in TF32; equal to its plain version to the bit): "
          f"{prep_row['ms']:.3f} ms, bound {prep_row['bound_ms']:.3f} ms ({prep_row['bound_by']}: "
          f"{3 * w_bytes / 1e6:.0f} MB), plain {prep_row['plain_ms']:.3f} ms")
    p_times = cuda_ms(lambda: fk.fused_flow_train_backward_reference(bound, hpt, dz, dld, *args, mm=matmul_tf32),
                      reps=3)
    all_parts = fk.BWD_ROWS | fk.BWD_WEIGHT_GRADS | fk.BWD_ACTNORM
    rows = []
    for what, forced, got, src in (("wgmma", False, wg, "flow_train_wgmma.cu"),
                                   ("row tiles", True, tiles, "flow_train_kernel.cu")):
        with row_tiles_forced() if forced else contextlib.nullcontext():
            out = tuple(torch.empty_like(t) for t in wg)
            w = None if forced else wstages
            times = cuda_ms(lambda: fk.fused_flow_train_bwd(bound, hpt, dz, dld, *args, mode=fk.MODE_TF32), reps=5)
            parts = {name: median(cuda_ms(lambda: fk._train_bwd_parts(bound, hpt, dz, dld, named, out, bits,
                                                                      fk.MODE_TF32, w), reps=5))
                     for name, bits in (("rows", fk.BWD_ROWS), ("weight grads", fk.BWD_WEIGHT_GRADS),
                                        ("rest", fk.BWD_ACTNORM), ("all", all_parts))}
        name = "K2b[tf32] fused_flow_train_bwd" if not forced else "K2b[tf32, row tiles] fused_flow_train_bwd"
        row = kernel_row(name, "bcnf_tpu_torch/ops/csrc/" + src, "bcnf_tpu/ops/flow_kernel.py:600", 0,
                         max((a - p).abs().max().item() for a, p in zip(got, plain)), times, p_times, work, peaks,
                         None, ARITH_TF32)
        row["parts_ms"] = parts
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        if not forced:
            row["prep_ms"] = prep
            blocks, resident, gw_blocks, gw_per_sm = fk.train_bwd_wgmma_layout(Hp, size, d_a, nh, B)
            layout = (f"rows kernel {blocks} blocks in {blocks // 2} clusters of 2, {resident} clusters resident at "
                      f"once on {sms} SMs: {blocks / 2 / resident:.2f} waves; weight-grad pass {gw_blocks} blocks, "
                      f"{gw_per_sm} an SM: {gw_blocks / (gw_per_sm * sms):.2f} waves")
        else:
            bm = 32 if Hp <= 544 else 16
            layout = f"rows kernel {-(-B // bm)} blocks of {bm} rows, one an SM: {-(-B // bm) / sms:.2f} waves"
        rows.append(row)
        print(f"    K2b one pass, {what} ({src}), rows {B}: {row['ms']:.3f} ms ({work[0] / row['ms'] / 1e9:.1f} "
              f"TFLOP/s); bound {row['bound_ms']:.3f} ms ({row['bound_by']}); parts alone: rows {parts['rows']:.3f}, "
              f"weight grads {parts['weight grads']:.3f}, the rest {parts['rest']:.3f} (all {parts['all']:.3f})"
              + (f"; the weight preparation {prep:.3f} ms a call" if not forced else "") +
              f"; {layout}; max|d| vs plain one pass {row['max_abs_err']:.3e} (largest over max(1, max|plain|) "
              f"{dist[what]:.3e}), vs 3xTF32 {max((a - c).abs().max().item() for a, c in zip(got, g3)):.3e}")
    print(f"    K2b one pass: wgmma {rows[0]['ms']:.3f} ms against the row tiles' {rows[1]['ms']:.3f} ms on the same "
          f"inputs ({rows[1]['ms'] / rows[0]['ms']:.2f}x); its outputs equal between two calls; its distance from the "
          f"plain one-pass version {dist['wgmma']:.3e} against the row tiles' {dist['row tiles']:.3e}")
    if not rows[0]["ms"] < rows[1]["ms"]:
        fail(f"K2b's wgmma route ({rows[0]['ms']:.3f} ms) is not faster than the one-pass row tiles "
             f"({rows[1]['ms']:.3f} ms) at the flagship's batch-4096 inputs")
    return rows + [prep_row]


def _max_d(a, b) -> float:
    a, b = (a,) if not isinstance(a, tuple) else a, (b,) if not isinstance(b, tuple) else b
    return max((x - y).abs().max().item() for x, y in zip(a, b))


def _hold_one_pass(what: str, one, three, plain_one, plain_f32) -> tuple[float, float, float]:
    """One-pass output against its plain one-pass version and the 3xTF32
    kernel (REDUCED_TOL), and not a no-op; returns (vs plain one pass, vs
    3xTF32, 3xTF32 vs plain float32)."""
    e1, e13, e3 = _max_d(one, plain_one), _max_d(one, three), _max_d(three, plain_f32)
    if not (e1 <= REDUCED_TOL and e13 <= REDUCED_TOL):
        fail(f"{what}: one pass vs plain one pass {e1:.3e}, vs 3xTF32 {e13:.3e} (bar {REDUCED_TOL:g})")
    if not e13 > 2 * e3:
        fail(f"{what}: the one pass is {e13:.3e} from 3xTF32, not more than twice 3xTF32's {e3:.3e} from float32")
    return e1, e13, e3


def one_pass_wgmma_parts(x, kargs: dict, h_proj, n_cond: int, ms: float, work: tuple[float, float], dev) -> None:
    """Phase 15 (a): the one-pass `wgmma` inverse's parts alone, uncounted
    launches at the sampling shape: its products on stale weight stages,
    the weights' stream without the products (GB read from L2: each stage
    once a cluster, which multicasts it to its blocks), both, and neither
    (the rest of the kernel with the ring's hand-offs); its layout (blocks,
    clusters, resident clusters, waves)."""
    import torch

    from bcnf_tpu_torch.ops import flow_kernel as fk
    from bcnf_tpu_torch.ops._build import load_library

    staged, args = fk.prepare_weights(kargs["wm"], passes=1), dict(kargs, h_proj=h_proj)
    part_ms = {name: median(cuda_ms(lambda: fk._launch_flow(x, args, inverse=True, n_cond=n_cond, mode=fk.MODE_TF32,
                                                             wstages=staged, parts=parts), reps=3))
               for name, parts in (("both", fk.WG_PRODUCTS | fk.WG_COPIES), ("products", fk.WG_PRODUCTS),
                                   ("stream", fk.WG_COPIES), ("neither", 0))}
    stages, cluster = fk.wgmma_ring(fk.ROUTE_WGMMA_TF32)
    blocks = -(-x.shape[0] // 64)
    clusters = -(-blocks // cluster)
    stream_gb = clusters * 4 * int(staged.numel()) / 1e9
    Hp, size, d_a = h_proj.shape[-1], x.shape[1], kargs["w1y"].shape[1]
    lib = load_library(fk.ROUTE_LIBRARY[fk.ROUTE_WGMMA_TF32])
    per_sm = lib.bcnf_flow_wgmma_occupancy(Hp, size, d_a)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    resident = lib.bcnf_flow_wgmma_clusters(Hp, size, d_a)
    if per_sm < 1 or resident < 1:
        fail(f"the one-pass wgmma inverse fits {per_sm} block(s) on an SM, {resident} clusters on the card")
    print(f"    one-pass wgmma inverse parts (CUDA events, median of 3, ms; {stages}-stage ring, clusters of "
          f"{cluster}): as built {part_ms['both']:.2f} (timed above: {ms:.2f}); its products alone (stale stages) "
          f"{part_ms['products']:.2f} ({work[0] / part_ms['products'] / 1e9:.1f} TFLOP/s); the hidden weights' "
          f"stream alone {part_ms['stream']:.2f} ({stream_gb:.0f} GB of hi stages from L2 -> "
          f"{stream_gb / part_ms['stream']:.2f} TB/s); neither (the FMA layers, the epilogues and the ring's "
          f"hand-offs) {part_ms['neither']:.2f}; layout: {blocks} blocks of 64 rows in {clusters} clusters, "
          f"{resident} clusters resident at once on {sms} SMs ({per_sm} block(s) an SM): {clusters / resident:.2f} "
          f"waves")


def one_pass_forward(x1, ka: dict, hp1, x2, hp2, args: list, H: int, peaks, dev) -> tuple[list[dict], dict, object]:
    """Phase 15 (a), the one-pass forward at the flagship's widths and 4096
    rows on both of its routes: K1's forward (`log_prob`'s rows, N = 4096)
    and K2a (rows with their own conditions, their step inputs stored) on the
    `wgmma` forward (csrc/flow_fwd_wgmma.cu) and on the one-pass row tiles
    forced on the same inputs; each held against its plain one-pass version
    and the 3xTF32 kernel (REDUCED_TOL), the `wgmma` forward no further from
    the plain one-pass version than twice the row tiles' distance and equal
    to the bit between two calls. CUDA-event times (median of 5): the `wgmma`
    forward on weights prepared once, the same with its preparation (K1's
    forward prepares at every call; K2a shares one preparation a step with
    K2b), the row tiles; the route's layout and ptxas lines. Returns the four
    kernel rows (launches filled in later; K1's time with its preparation,
    K2a's on handed-over weights), their 3xTF32 times, and K2a's step inputs."""
    import torch

    from bcnf_tpu_torch.ops import _build
    from bcnf_tpu_torch.ops import flow_kernel as fk
    from bcnf_tpu_torch.ops.tf32 import matmul_tf32

    named = dict(zip(TRAIN_ARGS, args))
    B, size, Hp = x1.shape[0], x1.shape[1], hp1.shape[-1]
    d_a = named["w1y"].shape[1]
    ws = fk.prepare_train_weights(named["wm"])
    kernel = "?"

    def k1(mode, wstages=None):
        if wstages is None:
            return fk.fused_flow(x1, hp1, **ka, inverse=False, n_cond=B, mode=mode)
        return fk._launch_flow(x1, dict(ka, h_proj=hp1), inverse=False, n_cond=B, mode=mode, wstages=wstages)[1:]

    cases = {  # name: (run, plain, work, the wgmma forward's row name, the row tiles', the TPU kernel)
        "K1 forward": (k1, lambda mm: fk.fused_flow_reference(x1, hp1, **ka, inverse=False, n_cond=B, mm=mm),
                       flow_work(ka, hp1, B, H), "fused_flow[forward, tf32]", "fused_flow[forward, tf32, row tiles]",
                       "bcnf_tpu/ops/flow_kernel.py:162"),
        "K2a": (lambda mode, wstages=None: fk.fused_flow_train_fwd(x2, hp2, *args, mode=mode, wstages=wstages),
                lambda mm: fk.fused_flow_train_reference(x2, hp2, *args, mm=mm), train_work(named, hp2, B, H)[0],
                "K2a[tf32] fused_flow_train_fwd", "K2a[tf32, row tiles] fused_flow_train_fwd",
                "bcnf_tpu/ops/flow_kernel.py:558"),
    }
    for line in _build.build_logs.get(fk.ROUTE_LIBRARY[fk.ROUTE_FWD_WGMMA_TF32], "").splitlines():
        if "Compiling entry function" in line:
            kernel = kernel_label(line)
        elif ("registers" in line or "spill" in line) and "<17," in kernel:
            print(f"    ptxas the wgmma forward {kernel}: {line.strip().removeprefix('ptxas info    : ')}")
    ring, smem, blocks, resident = fk.fwd_wgmma_card_layout(Hp, size, d_a, B)
    rows, three_ms, bound = [], {}, None
    for what, (run, plain, work, name, tiles_name, replaces) in cases.items():
        with torch.no_grad():
            one, two = run(fk.MODE_TF32), run(fk.MODE_TF32)
            three = run(fk.MODE_3XTF32)
            with row_tiles_forced("FWD_WGMMA_MAX_TN"):
                tiles = run(fk.MODE_TF32)
            plain_one, plain_f32 = plain(matmul_tf32), plain(torch.matmul)
            torch.cuda.synchronize()
        e_wg = _hold_one_pass(f"{what} on the wgmma forward", one, three, plain_one, plain_f32)
        e_tiles = _hold_one_pass(f"{what} on the row tiles", tiles, three, plain_one, plain_f32)
        if not all(torch.equal(a, b) for a, b in zip(one, two)):
            fail(f"{what} on the wgmma forward: two calls on the same inputs differ")
        if not e_wg[0] <= 2 * e_tiles[0]:
            fail(f"{what} on the wgmma forward is {e_wg[0]:.3e} from the plain one-pass version, past twice the row "
                 f"tiles' {e_tiles[0]:.3e}")
        with torch.no_grad():
            times = {"kernel": cuda_ms(lambda: run(fk.MODE_TF32, ws), reps=5),
                     "with its preparation": cuda_ms(lambda: run(fk.MODE_TF32), reps=5)}
            with row_tiles_forced("FWD_WGMMA_MAX_TN"):
                times["row tiles"] = cuda_ms(lambda: run(fk.MODE_TF32), reps=5)
            three_t = median(cuda_ms(lambda: run(fk.MODE_3XTF32), reps=5))
            p_times = cuda_ms(lambda: plain(matmul_tf32), reps=3)
        main = times["with its preparation"] if what == "K1 forward" else times["kernel"]
        row = kernel_row(name, "bcnf_tpu_torch/ops/csrc/flow_fwd_wgmma.cu", replaces, 0, e_wg[0], main, p_times,
                         work, peaks, None, ARITH_TF32)
        row["kernel_ms"], row["with_preparation_ms"] = median(times["kernel"]), median(times["with its preparation"])
        tiles_row = kernel_row(tiles_name, "bcnf_tpu_torch/ops/csrc/flow_kernel.cu", replaces, 0, e_tiles[0],
                               times["row tiles"], p_times, work, peaks, None, ARITH_TF32)
        rows += [row, tiles_row]
        three_ms[name] = three_ms[tiles_name] = three_t
        if what == "K2a":
            bound = one[2]
        print(f"    {what} one pass, rows {B}: the wgmma forward {row['kernel_ms']:.3f} ms on weights prepared once "
              f"({work[0] / row['kernel_ms'] / 1e9:.1f} TFLOP/s), {row['with_preparation_ms']:.3f} ms with its "
              f"preparation; the row tiles {tiles_row['ms']:.3f} ms ({tiles_row['ms'] / row['kernel_ms']:.2f}x the "
              f"kernel); 3xTF32 {three_t:.3f} ms; bound {row['bound_ms']:.3f} ms ({row['bound_by']}); plain one pass "
              f"{row['plain_ms']:.2f} ms; max|d| vs plain one pass {e_wg[0]:.3e} (row tiles {e_tiles[0]:.3e}), vs "
              f"3xTF32 {e_wg[1]:.3e} (3xTF32 vs plain float32 {e_wg[2]:.2e}); two calls equal to the bit")
    print(f"    the wgmma forward's layout at {B} rows: {blocks} blocks in {blocks // 2} clusters of 2, {resident} "
          f"clusters resident at once: {blocks / 2 / resident:.2f} waves; a {ring}-stage ring, {smem} bytes of shared "
          f"memory; the weight preparation {median(cuda_ms(lambda: fk.prepare_train_weights(named['wm']), reps=5)):.3f} "
          f"ms")
    return rows, three_ms, bound


def one_pass_kernels(model, params, rng, dev, peaks: tuple[float, float, float]) -> tuple[list[dict], dict]:
    """Phase 15 (a): K1 (the inverse on `wgmma` and on the row tiles, the
    forward), K2a, K2b and K4 in one TF32 pass at the flagship's widths and
    the main path's shapes, each held against its plain one-pass version
    and the 3xTF32 kernel; CUDA-event times beside 3xTF32's; the one-pass
    round trip. Returns the kernel rows (launches filled in later) and the
    rows' 3xTF32 times."""
    import numpy as np
    import torch

    from bcnf_tpu_torch.bridge import map_tree
    from bcnf_tpu_torch.ops import flow_kernel as fk
    from bcnf_tpu_torch.ops.coupling_kernel import (
        fused_affine_coupling, fused_affine_coupling_reference, mlp_params_to_kernel_args,
    )
    from bcnf_tpu_torch.ops.tf32 import matmul_tf32

    H, d_a = model.nested_sizes[0], model.coupling.d_a
    randn = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)  # noqa: E731
    traj, z = randn(N_COND, 30, 3), randn(M_DRAWS * N_COND, model.size)
    traj_lp, y_lp = randn(LOGPROB_ROWS, 30, 3), randn(LOGPROB_ROWS, model.size)
    with torch.no_grad():
        h, h_lp = model.encode(params, (traj,)), model.encode(params, (traj_lp,))
        kargs, h_proj = model._fused_flow_args(params, h)
        kargs_f, h_proj_f = model._fused_flow_args(params, h_lp)
    rows, three_ms = [], {}
    modes = (fk.MODE_TF32, fk.MODE_3XTF32)
    print(f"[15 reduced precision: kernels] one TF32 pass against the plain one-pass version (every MLP product "
          f"rounded to TF32) and the 3xTF32 kernel (bar {REDUCED_TOL:g}, JAX's reduced-mode bar), at the flagship's "
          f"widths; CUDA events, median of 5 (plain 3):")
    cases = {  # direction: (x, kargs, h_proj, n_cond, inverse, the row-tile inverse forced)
        "inverse": (z, kargs, h_proj, N_COND, True, False),
        "inverse, row tiles": (z[:LOGPROB_ROWS], kargs, h_proj, N_COND, True, True),
    }
    wg_max = fk.WGMMA_MAX_TN
    for direction, (x, ka, hp, n, inv, rows_inverse) in cases.items():
        if rows_inverse:  # the route of the models wider than Hp 544, at the flagship's width
            fk.WGMMA_MAX_TN = 0
        try:
            with torch.no_grad():
                outs = {m: fk.fused_flow(x, hp, **ka, inverse=inv, n_cond=n, mode=m) for m in modes}
                plain_one = fk.fused_flow_reference(x, hp, **ka, inverse=inv, n_cond=n, mm=matmul_tf32)
                plain = fk.fused_flow_reference(x, hp, **ka, inverse=inv, n_cond=n)
                torch.cuda.synchronize()
                errs = _hold_one_pass(f"K1 {direction}", outs[fk.MODE_TF32], outs[fk.MODE_3XTF32], plain_one, plain)
                route = fk.flow_route(hp.shape[-1], model.size, d_a, inv, fk.MODE_TF32)
                times = {m: cuda_ms(lambda: fk.fused_flow(x, hp, **ka, inverse=inv, n_cond=n, mode=m), reps=5)
                         for m in modes}
                p_times = cuda_ms(lambda: fk.fused_flow_reference(x, hp, **ka, inverse=inv, n_cond=n, mm=matmul_tf32),
                                  reps=3)
        finally:
            fk.WGMMA_MAX_TN = wg_max
        work = flow_work(ka, hp, x.shape[0], H)
        row = kernel_row(f"fused_flow[{direction}, tf32]", "bcnf_tpu_torch/ops/csrc/" + (
            "flow_wgmma.cu" if route == fk.ROUTE_WGMMA_TF32 else "flow_kernel.cu"), "bcnf_tpu/ops/flow_kernel.py:162",
            0, errs[0], times[fk.MODE_TF32], p_times, work, peaks, None, ARITH_TF32)
        print(f"    K1 {direction} ({route}) rows {x.shape[0]}: one pass {row['ms']:.2f} ms, 3xTF32 "
              f"{median(times[fk.MODE_3XTF32]):.2f} ms ({median(times[fk.MODE_3XTF32]) / row['ms']:.2f}x); bound "
              f"{row['bound_ms']:.2f} ms (3xTF32 {bound_ms(work, peaks, ARITH_3XTF32)[0]:.2f}); plain one pass "
              f"{row['plain_ms']:.2f} ms; max|d| vs plain one pass {errs[0]:.2e}, vs 3xTF32 {errs[1]:.2e} (3xTF32 vs "
              f"plain float32 {errs[2]:.2e})")
        if not rows_inverse:
            rows.append(row)
            three_ms[row["name"]] = median(times[fk.MODE_3XTF32])
        if route == fk.ROUTE_WGMMA_TF32:
            one_pass_wgmma_parts(x, ka, hp, n, row["ms"], work, dev)
    with torch.no_grad():
        y1 = fk.fused_flow(z, h_proj, **kargs, inverse=True, n_cond=N_COND, mode=fk.MODE_TF32)
        z1, _ = fk.fused_flow(y1, h_proj, **kargs, inverse=False, n_cond=N_COND, mode=fk.MODE_TF32)
        torch.cuda.synchronize()
    rt = (z1 - z).abs().max().item()
    print(f"    one-pass round trip (inverse then forward, {z.shape[0]} rows): max|z - z'| {rt:.3e}; the JAX CLI's "
          f"BF16_BF16_F32_X3 figure on a TPU: {JAX_X3_ROUND_TRIP:g} (results/precision_sweep.json)")
    if not rt <= REDUCED_TOL:
        fail(f"one-pass round trip {rt:.3e} > {REDUCED_TOL:g}")

    # K1's forward at the log_prob rows, K2a and K2b at batch 4096 (rows with their own conditions)
    with torch.no_grad():
        kt, hpt = model._fused_flow_args(params, model.encode(params, (randn(LOGPROB_ROWS, 30, 3),)))
    args = [kt[k].contiguous() for k in TRAIN_ARGS]
    y_t = randn(LOGPROB_ROWS, model.size)
    fwd_rows, fwd_three, bound = one_pass_forward(y_lp, kargs_f, h_proj_f, y_t, hpt, args, H, peaks, dev)
    rows += fwd_rows
    three_ms.update(fwd_three)
    dz, dld = randn_cotangents(y_t)
    g1 = fk.fused_flow_train_bwd(bound, hpt, dz, dld, *args, mode=fk.MODE_TF32)
    g3 = fk.fused_flow_train_bwd(bound, hpt, dz, dld, *args)
    gp1 = fk.fused_flow_train_backward_reference(bound, hpt, dz, dld, *args, mm=matmul_tf32)
    torch.cuda.synchronize()
    for name, a, b, c in zip(GRAD_NAMES, g1, gp1, g3):
        print(f"      K2b one pass {name}: max|plain| {b.abs().max().item():.3e}, max|d| vs plain one pass "
              f"{(a - b).abs().max().item():.3e}, vs 3xTF32 {(a - c).abs().max().item():.3e}")
    work = dict(zip(("K2a", "K2b"), train_work(dict(zip(TRAIN_ARGS, args)), hpt, LOGPROB_ROWS, H)))
    k2b_three = median(cuda_ms(lambda: fk.fused_flow_train_bwd(bound, hpt, dz, dld, *args), reps=5))
    for row in one_pass_k2b(bound, hpt, dz, dld, args, g3, work["K2b"], peaks, dev):
        rows.append(row)
        three_ms[row["name"]] = k2b_three if "fused_flow_train_bwd" in row["name"] else None
    print(f"    K2b 3xTF32 (row tiles) {k2b_three:.3f} ms; bound {bound_ms(work['K2b'], peaks, ARITH_3XTF32)[0]:.3f} ms")

    # K4: block 0's coupling on the sampling rows (inverse) and the log_prob rows (forward)
    blk0 = map_tree(lambda t: t[0], params["blocks"]["coupling"])
    cargs = mlp_params_to_kernel_args(blk0["a"], d_a)
    with torch.no_grad():
        for inverse, (x, hc, n) in {True: (z, h, N_COND), False: (y_lp, h_lp, LOGPROB_ROWS)}.items():
            hp = model.coupling.cond_proj(blk0, hc)["a"][0]
            x_a, x_b = x[:, :d_a].contiguous(), x[:, d_a:].contiguous()
            outs = {m: fused_affine_coupling(x_a, x_b, hp, **cargs, inverse=inverse, mode=m) for m in modes}
            p1 = fused_affine_coupling_reference(x_a, x_b, hp, **cargs, inverse=inverse, n_cond=n, mm=matmul_tf32)
            p32 = fused_affine_coupling_reference(x_a, x_b, hp, **cargs, inverse=inverse, n_cond=n)
            torch.cuda.synchronize()
            direction = "inverse" if inverse else "forward"
            errs = _hold_one_pass(f"K4 {direction}", outs[fk.MODE_TF32], outs[fk.MODE_3XTF32], p1, p32)
            times = {m: cuda_ms(lambda: fused_affine_coupling(x_a, x_b, hp, **cargs, inverse=inverse, mode=m), reps=5)
                     for m in modes}
            p_times = cuda_ms(lambda: fused_affine_coupling_reference(x_a, x_b, hp, **cargs, inverse=inverse, n_cond=n,
                                                                      mm=matmul_tf32), reps=3)
            work = coupling_work(cargs, x.shape[0], n, H, inverse)
            row = kernel_row(f"K4[tf32] fused_affine_coupling[{direction}]", "bcnf_tpu_torch/ops/csrc/" + (
                "flow_wgmma.cu" if inverse else "flow_fwd_wgmma.cu"), "bcnf_tpu/ops/coupling_kernel.py:69", 0, errs[0],
                times[fk.MODE_TF32], p_times, work, peaks, None, ARITH_TF32)
            rows.append(row)
            three_ms[row["name"]] = median(times[fk.MODE_3XTF32])
            print(f"    K4 {direction} rows {x.shape[0]}: one pass {row['ms']:.3f} ms, 3xTF32 "
                  f"{three_ms[row['name']]:.3f} ms (earlier runs, its weights prepared at every launch: 3xTF32 "
                  f"{K4_EARLIER_MS[direction][0]} ms, plain {K4_EARLIER_MS[direction][1]} ms); bound "
                  f"{row['bound_ms']:.3f} ms (3xTF32 {bound_ms(work, peaks, ARITH_3XTF32)[0]:.3f}); plain one pass "
                  f"{row['plain_ms']:.3f} ms; max|d| vs plain one pass {errs[0]:.2e}, vs 3xTF32 {errs[1]:.2e}")
    return rows, three_ms


def precision_training(dev, rng) -> None:
    """Phase 15 (c): `Trainer.train` on the flagship at batch 4096 with
    coupling dropout 0 and `training.precision: default` (K2a/K2b in one
    pass: both on their `wgmma` routes, then with K2b's one-pass row tiles
    forced, then with K2a's), and on the published config at batch 256
    (dropout 0.407: plain autograd, its products in TF32), each beside
    float32: train samples/s (5 steps after a warm-up) and the losses after
    the same steps; each forced run's losses within the one-pass bar of the
    `wgmma` routes'; at `default` the hidden weights prepared once a step
    (`prepare_train_weights.launches`), whichever route reads them."""
    import numpy as np
    import torch

    from bcnf_tpu_torch.bridge import map_tree
    from bcnf_tpu_torch.config import load_config
    from bcnf_tpu_torch.models import CondRealNVP
    from bcnf_tpu_torch.ops.flow_kernel import prepare_train_weights
    from bcnf_tpu_torch.train import Trainer, make_optimizer

    forced = {"default, row tiles": "TRAIN_WGMMA_MAX_TN", "default, K2a row tiles": "FWD_WGMMA_MAX_TN"}
    for what, B in (("flagship, dropout 0", 4096), ("published config", 256)):
        cfg = _flagship_train_config(B, 1) if B == 4096 else load_config(CONFIG).to_dict()
        cfg["training"].update(batch_size=B, n_epochs=1, timeout=None)
        n = int(round(3 * B / (1 - cfg["training"]["validation_split"])))
        y = rng.normal(size=(n, 19)).astype(np.float32)
        traj = rng.normal(size=(n, 30, 3)).astype(np.float32)
        result = {}
        runs = ("highest", "default", *forced) if B == 4096 else ("highest", "default")
        for run in runs:
            precision = run.split(",")[0]
            cfg["training"]["precision"] = precision
            with row_tiles_forced(forced[run]) if run in forced else contextlib.nullcontext():
                model = CondRealNVP.from_config(cfg)
                trainer = Trainer(cfg, data=(y, [traj]), device=dev, seed=SEED, verbose=False)
                trained = trainer.train(model, model.init(torch.Generator().manual_seed(SEED), device=dev))
                hist = trainer.meta_scheduler.parameter_history
                losses = [v for _, v in hist["train_loss"]] + [v for _, v in hist["val_loss"]]
                if model.precision != precision or not np.all(np.isfinite(losses)):
                    fail(f"{what}: training.precision {precision} gave model precision {model.precision}, "
                         f"losses {losses}")
                params = map_tree(lambda t: t.detach().clone().requires_grad_(True), trained)
                opt = make_optimizer("Adam", lr=2e-4).init(params)
                gen = torch.Generator(device=dev).manual_seed(SEED)
                yb = torch.from_numpy(y[:B]).to(dev)
                cb = [torch.from_numpy(traj[:B]).to(dev)]
                trainer.train_step(model, [params], opt, yb, cb, [gen])
                torch.cuda.synchronize()
                prepared = prepare_train_weights.launches
                t0 = time.perf_counter()
                for _ in range(5):
                    trainer.train_step(model, [params], opt, yb, cb, [gen])
                torch.cuda.synchronize()
                prepared = prepare_train_weights.launches - prepared
            result[run] = (5 * B / (time.perf_counter() - t0), losses)
            if B == 4096 and run != "highest" and prepared != 5:
                fail(f"{what} at {run}: the hidden weights were prepared {prepared} times in 5 steps, not once a step")
        print(f"    Trainer.train, {what}, batch {B}, 3 steps + validation: train samples/s float32 "
              f"{result['highest'][0]:,.0f}, default (one TF32 pass) {result['default'][0]:,.0f} "
              f"({result['default'][0] / result['highest'][0]:.2f}x); losses after the same steps (train, val) "
              f"float32 {', '.join(f'{v:.4f}' for v in result['highest'][1])}, default "
              f"{', '.join(f'{v:.4f}' for v in result['default'][1])}")
        for run, kernel in (("default, row tiles", "K2b"), ("default, K2a row tiles", "K2a")):
            if run not in result:
                continue
            (wg, wg_losses), (tiles, tile_losses) = result["default"], result[run]
            far = [(a, b) for a, b in zip(wg_losses, tile_losses) if not abs(a - b) <= REDUCED_TOL * max(1.0, abs(b))]
            print(f"    the same at default with {kernel}'s one-pass row tiles forced: {tiles:,.0f} train samples/s "
                  f"against {wg:,.0f} with both on their wgmma routes ({wg / tiles:.3f}x); losses "
                  f"{', '.join(f'{v:.4f}' for v in tile_losses)}; the hidden weights prepared once a step")
            if far:
                fail(f"{what} at default: the wgmma routes' losses and those with {kernel}'s row tiles differ past "
                     f"the one-pass bar: {far}")


def one_pass_floor_sweep(rng, dev) -> None:
    """Phase 15 (c): the one-pass training floor sweep, the flagship's
    dropout-0 step at `training.precision: default` at 32, 64, 128 and 256
    rows with K2b on its `wgmma` route, with the one-pass row tiles forced,
    and with plain autograd (BCNF_FUSED_TRAIN_MIN_BATCH past the batch), in
    turns (wgmma, row tiles, plain, twice; the better of each side's two
    rates); the least batch from which the `wgmma` route beats the row tiles
    at every size measured (the route takes every batch)."""
    import numpy as np
    import torch

    from bcnf_tpu_torch.bridge import map_tree
    from bcnf_tpu_torch.models import CondRealNVP
    from bcnf_tpu_torch.ops import flow_kernel as fk
    from bcnf_tpu_torch.train import Trainer, make_optimizer

    cfg = _flagship_train_config(FLOOR_BATCHES[-1], 1)
    cfg["training"]["precision"] = "default"
    model = CondRealNVP.from_config(cfg)
    model.precision = "default"  # as Trainer.train sets it from the config
    n = 2 * FLOOR_BATCHES[-1]
    y = rng.normal(size=(n, model.size)).astype(np.float32)
    traj = rng.normal(size=(n, 30, 3)).astype(np.float32)
    trainer = Trainer(cfg, data=(y, [traj]), device=dev, seed=SEED)
    params0 = model.init(torch.Generator().manual_seed(SEED), device=dev)
    rates, reps, sides = {}, 5, ("wgmma", "row tiles", "plain")
    expect = {"wgmma": fk.ROUTE_WGMMA_TF32, "row tiles": fk.ROUTE_ROWS_TF32, "plain": None}
    for B in FLOOR_BATCHES:
        yb, cb = torch.from_numpy(y[:B]).to(dev), [torch.from_numpy(traj[:B]).to(dev)]
        for side in sides + sides:
            os.environ["BCNF_FUSED_TRAIN_MIN_BATCH"] = "1" if side != "plain" else str(1 << 30)
            with row_tiles_forced() if side == "row tiles" else contextlib.nullcontext():
                params = map_tree(lambda t: t.detach().clone().requires_grad_(True), params0)
                opt = make_optimizer("Adam", lr=2e-4).init(params)
                gen = torch.Generator(device=dev).manual_seed(SEED)
                before = dict(fk.fused_flow_train_bwd.route_launches)
                trainer.train_step(model, [params], opt, yb, cb, [gen])
                torch.cuda.synchronize()
                ran = [r for r, c in fk.fused_flow_train_bwd.route_launches.items() if c != before.get(r, 0)]
                if ran != ([expect[side]] if expect[side] else []):
                    fail(f"the one-pass floor sweep at {B} rows ({side}): K2b ran on {ran}")
                t0 = time.perf_counter()
                for _ in range(reps):
                    trainer.train_step(model, [params], opt, yb, cb, [gen])
                torch.cuda.synchronize()
            rates[B, side] = max(rates.get((B, side), 0.0), reps * B / (time.perf_counter() - t0))
    del os.environ["BCNF_FUSED_TRAIN_MIN_BATCH"]
    wins = [rates[B, "wgmma"] > rates[B, "row tiles"] for B in FLOOR_BATCHES]
    floor = next((B for i, B in enumerate(FLOOR_BATCHES) if all(wins[i:])), None)
    print("    one-pass training floor sweep, the flagship's dropout-0 step at default, train samples/s with K2b "
          "on wgmma / on the row tiles / plain autograd (better of two turns each, 5 steps a turn): " + "; ".join(
              f"{B} rows {rates[B, 'wgmma']:.0f} / {rates[B, 'row tiles']:.0f} / {rates[B, 'plain']:.0f} "
              f"({rates[B, 'wgmma'] / rates[B, 'row tiles']:.2f}x, {rates[B, 'wgmma'] / rates[B, 'plain']:.2f}x)"
              for B in FLOOR_BATCHES) +
          f"; the least batch from which wgmma beats the row tiles at every size measured: {floor} (the route "
          f"takes every batch)")


def precision_path(model, params, rng, dev, build_dir: str, peaks: tuple[float, float, float]) -> list[dict]:
    """Phase 15: (a) the one-pass kernels; the precision path, its launch
    counts zeroed before it and read after: (b) `sample --precision
    BF16_BF16_F32_X3` and `eval` at its defaults in float32 and with
    `--precision default` on 200 generated test points (the test NLL equal
    to the bit), the per-coupling inverse (K4) at "default"; (c) training at
    `training.precision: default`; (d) `hpo` on 512 trajectories generated on
    the card, 3 calls, 2 folds, 2 epochs, then a re-run that resumes.
    Returns the one-pass kernel rows."""
    import numpy as np
    import torch

    import bcnf_tpu_torch.__main__ as cli
    from bcnf_tpu_torch.bridge import params_to_numpy
    from bcnf_tpu_torch.hpo.gp_minimize import load_checkpoint
    from bcnf_tpu_torch.ops.coupling_kernel import fused_affine_coupling
    from bcnf_tpu_torch.ops.flow_kernel import MODE_TF32

    t_start = time.perf_counter()
    rows, three_ms = one_pass_kernels(model, params, rng, dev, peaks)
    t_kernels = time.perf_counter() - t_start
    zero_all_counts()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        # -- (b) sample and eval at the reduced precisions
        with open(os.path.join(tmp, "params.pkl"), "wb") as f:
            pickle.dump(params_to_numpy(params), f)
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump({"config_path": CONFIG}, f)
        test = os.path.join(tmp, "test.pkl")
        cli.main(["generate", "-c", PRIOR_CONFIG, "-o", test, "-n", "200", "--no-filter", "--dt", "0.067", "-T", "2",
                  "--seed", "15"])
        out = os.path.join(tmp, "samples.npy")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.main(["sample", "-m", tmp, "-d", test, "-n", "1000", "-o", out, "--precision", "BF16_BF16_F32_X3"])
        t_sample = time.perf_counter() - t0
        s = np.load(out)
        if s.shape != (1000, 200, model.size) or not np.isfinite(s).all():
            fail(f"sample --precision BF16_BF16_F32_X3 gave {s.shape}, finite {np.isfinite(s).all()}")
        reports = {}
        for precision in (None, "default"):
            argv = ["eval", "-m", tmp, "-d", test, "-o", os.path.join(tmp, f"report_{precision}")]
            (report, _, stages), secs = run_eval(argv + (["--precision", precision] if precision else []))
            reports[precision] = report
            print(f"    eval at its defaults{' --precision ' + precision if precision else ' (float32)'}: {secs:.2f} s; "
                  f"stages {', '.join(f'{k} {v:.3f}' for k, v in stages.items())}; test NLL {report['test_nll']!r}")
        if reports["default"]["test_nll"] != reports[None]["test_nll"]:
            fail(f"eval --precision default moved the test NLL: {reports['default']['test_nll']!r} against "
                 f"{reports[None]['test_nll']!r}")
        z = torch.from_numpy(rng.normal(size=(M_DRAWS, N_COND, model.size)).astype(np.float32)).to(dev)
        traj = torch.from_numpy(rng.normal(size=(N_COND, 30, 3)).astype(np.float32)).to(dev)
        # posterior sampling, 10,000 x 8, at float32 and at "default" (host clock, after a warm-up each)
        rates = {}
        try:
            for precision in ("highest", "default"):
                model.precision = precision
                with torch.no_grad():
                    model.sample(params, torch.Generator().manual_seed(SEED), 16, traj, device=dev)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    model.sample(params, torch.Generator().manual_seed(SEED), M_DRAWS, traj, device=dev)
                    torch.cuda.synchronize()
                rates[precision] = M_DRAWS * N_COND / (time.perf_counter() - t0)
        finally:
            model.precision = "highest"
        print(f"    sample {M_DRAWS} x {N_COND}: {rates['highest']:.0f} samples/s at float32 (3xTF32 K1), "
              f"{rates['default']:.0f} at precision 'default' (one-pass K1)")
        k4 = fused_affine_coupling.mode_launches
        model.use_pallas_coupling, model.precision = True, "default"
        try:
            with torch.no_grad():
                y4 = model.inverse_given_h(params, z, model.encode(params, (traj,)))
                k4_inverse = k4[MODE_TF32]
                z4, _ = model.forward(params, y4[0], traj)
                torch.cuda.synchronize()
        finally:
            model.use_pallas_coupling, model.precision = False, "highest"
        k4_forward = k4[MODE_TF32] - k4_inverse
        if not (torch.isfinite(y4).all() and torch.isfinite(z4).all()):
            fail("the per-coupling inverse or forward at precision 'default' is not finite")
        print(f"[15 reduced precision: path] sample --precision BF16_BF16_F32_X3, 1000 x 200: {t_sample:.2f} s, "
              f"finite; the test NLL at --precision default equals float32's to the bit; the per-coupling inverse "
              f"at 'default' ({M_DRAWS} x {N_COND}) and forward ({N_COND} rows) finite")

        # -- (c) training at training.precision: default
        precision_training(dev, rng)
        one_pass_floor_sweep(rng, dev)
        counts = dict(one_pass_counts(), **{"K4 inverse": k4_inverse, "K4 forward": k4_forward})

        # -- (d) hpo on trajectories generated on the card
        data = os.path.join(tmp, "hpo_data.pkl")
        cli.main(["generate", "-c", PRIOR_CONFIG, "-o", data, "-n", "512", "--no-filter", "--dt", "0.067", "-T", "2",
                  "--seed", "16"])
        hpo_dir = os.path.join(tmp, "hpo")
        argv = ["hpo", "-d", data, "-o", hpo_dir, "--n-initial-points", "2", "--n-splits", "2", "--n-epochs", "2",
                "--n-samples", "512"]
        t0 = time.perf_counter()
        cli.main(argv + ["--n-calls", "3"])
        first = load_checkpoint(os.path.join(hpo_dir, "hpo_checkpoint.pkl"))
        cli.main(argv + ["--n-calls", "4"])
        t_hpo = time.perf_counter() - t0
        resumed = load_checkpoint(os.path.join(hpo_dir, "hpo_checkpoint.pkl"))
        with open(os.path.join(hpo_dir, "best.json")) as f:
            best = json.load(f)
        if (len(first["x_iters"]) != 3 or resumed["x_iters"][:3] != first["x_iters"] or best["n_evaluations"] != 4
                or not np.isfinite(best["best_val_loss"])):
            fail(f"hpo: {len(first['x_iters'])} then {len(resumed['x_iters'])} evaluations, best {best}")
        print(f"    hpo on 512 trajectories generated on the card: 3 calls (2 random, 1 from the GP) x 2 folds x 2 "
              f"epochs, then a re-run resumed to 4, in {t_hpo:.2f} s; best CV val loss {best['best_val_loss']:.3f} at "
              f"{best['best_params']}")
    torch.cuda.synchronize()
    missing = [k for k, v in counts.items() if v < 1]
    if missing:
        fail(f"the precision path launched no one-pass {', '.join(missing)}: {counts}")
    key = {"fused_flow[inverse, tf32]": "K1 inverse", "fused_flow[forward, tf32]": "K1 forward",
           "fused_flow[forward, tf32, row tiles]": "K1 forward row tiles",
           "K2a[tf32, row tiles] fused_flow_train_fwd": "K2a row tiles",
           "K4[tf32] fused_affine_coupling[inverse]": "K4 inverse", "K4[tf32] fused_affine_coupling[forward]": "K4 forward",
           "K2b[tf32, row tiles] fused_flow_train_bwd": "K2b row tiles",
           "K2b[tf32] prepare_train_weights": "K2b prep"}
    for row in rows:
        row["launches"] = counts[key.get(row["name"], row["name"].split("[")[0])]
        row["ms_3xtf32"] = three_ms[row["name"]]
    print(f"    phase 15 took {time.perf_counter() - t_start:.1f} s (kernels {t_kernels:.1f} s); one-pass launches on "
          f"its path (counts zeroed before (b), read after (c)): {counts}")
    return rows


# ---------------------------------------------------------------------------
# phase 16: data parallelism (parallel/mesh.py) on the one card: a mesh of
# two shards placed on the same card, and a one-rank NCCL process group
# ---------------------------------------------------------------------------

DP_BATCH = 4096  # the flagship step of phase 6: 2048 rows a shard keep the training kernels' gate open
DP_RANK_POINTS, DP_RESIM_POINTS, DP_RESIM_DRAWS = 64, 8, 100
DP_ONLINE_STEPS, DP_ONLINE_BATCH = 8, 64
DP_KERNELS = ("K1 inverse", "K1 forward", "K2a", "K2b", "K3a", "K3b")
# sharded vs unsharded samples on the card: |d| <= DP_SAMPLE_REL * max(1, max|unsharded|). cuBLAS may take
# another product kernel for a shard's rows, which moves the flagship's samples by a few 1e-6 on an H100;
# a rank may then differ only where a draw lies within that bound of its true value
DP_SAMPLE_REL = 1e-5


def dp_counts() -> dict:
    """The launches of phase 16's kernels, K1 by direction (`video_counts`)."""
    return video_counts()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cotangent_loss(model, params: dict, y, conditions: list, generator) -> tuple:
    """The objective of phase 16's grad checks, in the Trainer's loss slot:
    z and logdet pulled back from standard-normal cotangents that ride in
    the conditions after the trajectories (so a shard takes its rows'),
    over the rows; then the NLL, 0, the mean logdet. The mean NLL's own
    grads cancel past float32 in the ActNorm scale grads of a random model
    (the sharded and unsharded sums then differ by rounding alone)."""
    import torch

    from bcnf_tpu_torch.utils.misc import inn_nll_loss

    traj, dz, dld = conditions
    z, ld = model.forward(params, y, traj, generator=generator, train=True)
    obj = ((z * dz).sum() + (ld * dld).sum()) / y.shape[0]
    return obj, inn_nll_loss(z, ld), torch.zeros((), device=y.device), ld.mean()


def dp_step_check(trainer, model, params0: dict, yb, cb: list, what: str) -> tuple[dict, dict, list]:
    """One data-parallel step (`Trainer.shard_grads`) against the unsharded
    step on the same batch and params: the NLL, and every grad pulled back
    from standard-normal cotangents (`cotangent_loss`) at the JAX grad bar
    (each grad's atol capped at GRAD_REL of its max |plain|). Returns the
    launches of each (sharded, unsharded) and the sharded grads."""
    import torch

    from bcnf_tpu_torch.bridge import map_tree, tree_leaves
    from bcnf_tpu_torch.models.cnf import matmul_precision
    from bcnf_tpu_torch.parallel import replicate_trainable

    def trainable():
        return map_tree(lambda t: t.detach().clone().requires_grad_(True), params0)

    g = torch.Generator(device=yb.device).manual_seed(SEED + 16)
    conds = [*cb, torch.randn(yb.shape, generator=g, device=yb.device),
             torch.randn(yb.shape[:1], generator=g, device=yb.device)]
    p1 = trainable()
    torch.cuda.synchronize()
    zero_counts()
    with matmul_precision(model.precision):
        m1 = cotangent_loss(model, p1, yb, conds, None)
        m1[0].backward()
    torch.cuda.synchronize()
    c1 = dp_counts()
    replicas = replicate_trainable(trainer.mesh, trainable())
    trainer.loss_fn = cotangent_loss  # the Trainer's sharded step, this objective in its loss slot
    try:
        zero_counts()
        # no generator, as on the unsharded side: the LSTM's dropout stays off in both
        m2 = trainer.shard_grads(model, replicas, yb, conds, [None] * len(trainer.mesh.devices))
        torch.cuda.synchronize()
    finally:
        del trainer.loss_fn
    c2 = dp_counts()
    worst, max_d, mags, where = -1.0, 0.0, [], ""
    for path, a, b in zip(leaf_paths(replicas[0]), tree_leaves(replicas[0]), tree_leaves(p1)):
        if b.grad is not None:
            d, excess, mag = grad_excess(a.grad, b.grad)
            if excess > worst:
                worst, where = excess, f"{path} (max|d| {d:.3e}, max|plain| {mag:.3e})"
            max_d = max(max_d, d)
            mags.append(mag)
    loss_s, loss_u = m2[1].item(), m1[1].item()
    print(f"    {what}: NLL {loss_s:.6f} vs unsharded {loss_u:.6f}; {len(mags)} param grads from standard-normal "
          f"cotangents max|d| {max_d:.3e} (bar "
          f"|d| <= min({GRAD_ATOL:g}, {GRAD_REL:g} max|plain|) + {GRAD_RTOL:g}|plain|; max|plain| per grad "
          f"{min(mags):.3e} to {max(mags):.3e}); launches sharded {c2}, unsharded {c1}")
    if not abs(loss_s - loss_u) <= KERNEL_TOL * max(1.0, abs(loss_u)) or worst > 0:
        fail(f"{what}: the sharded step disagrees with the unsharded one: NLL |d| {abs(loss_s - loss_u):.3e}, "
             f"grads {worst:.3e} past the bar at {where}")
    return c2, c1, [a.grad for a in tree_leaves(replicas[0])]


def leaf_paths(tree, prefix: str = "") -> list[str]:
    """The paths of a parameter tree's leaves, in `tree_leaves` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in leaf_paths(v, f"{prefix}.{k}" if prefix else str(k))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, f"{prefix}[{i}]")]
    return [prefix]


def dp_rates(trainer, trainer_mesh, model, params0: dict, yb, cb: list, dev, reps: int = 5) -> tuple[float, float]:
    """Train samples/s of `reps` steps (after a warm-up), unsharded and on the
    mesh, host clock around synchronised work; the replicas equal after."""
    import torch

    from bcnf_tpu_torch.bridge import map_tree, tree_leaves
    from bcnf_tpu_torch.parallel import replicate_trainable
    from bcnf_tpu_torch.train import make_optimizer

    rates = []
    for t in (trainer, trainer_mesh):
        params = replicate_trainable(t.mesh, map_tree(lambda x: x.detach().clone().requires_grad_(True), params0))
        opt = make_optimizer("Adam", lr=2e-4).init(params[0])
        gen = t.shard_generators(0)
        t.train_step(model, params, opt, yb, cb, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            t.train_step(model, params, opt, yb, cb, gen)
        torch.cuda.synchronize()
        rates.append(reps * yb.shape[0] / (time.perf_counter() - t0))
        if len(params) > 1 and not all(torch.equal(a, b) for a, b in zip(tree_leaves(params[0]),
                                                                        tree_leaves(params[1]))):
            fail("the replicas differ after the sharded updates")
    return rates[0], rates[1]


def parallel_path(rng, dev, build_dir: str) -> dict:
    """Phase 16: (a) the flagship's training on a 2-shard mesh on the card,
    (b) the same step under a one-rank NCCL process group, (c) sharded
    calibration ranks and resimulation, (d) online video training on the
    mesh, (e) the CLI's `--dp-devices`. Returns the kernels' launches on the
    sharded paths ((a)'s `Trainer.train`, (c)'s sharded ranks and
    resimulation, (d); counts zeroed before each and read after)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import yaml

    import bcnf_tpu_torch.__main__ as cli
    from bcnf_tpu_torch.bridge import params_to_numpy, tree_leaves
    from bcnf_tpu_torch.config import load_config, load_yaml, sub_root_path
    from bcnf_tpu_torch.eval.calibration import compute_y_hat_ranks
    from bcnf_tpu_torch.models import CondRealNVP
    from bcnf_tpu_torch.parallel import Mesh, replicate, sample_sharded
    from bcnf_tpu_torch.simulation.resimulation import resimulate
    from bcnf_tpu_torch.train import Trainer
    from bcnf_tpu_torch.train.online import OnlineSimulator, train_online

    t_start = time.perf_counter()
    card = torch.device("cuda", 0)
    mesh = Mesh([card, card])  # two shards on the one card: a test device of the sharded path
    dp_launches = dict.fromkeys(DP_KERNELS, 0)
    fused_lstm(True)

    # (a) the flagship's data-parallel step and Trainer.train on the mesh
    cfg = _flagship_train_config(DP_BATCH, 1)
    model = CondRealNVP.from_config(cfg)
    n = int(round(3 * DP_BATCH / (1 - cfg["training"]["validation_split"])))  # 3 training batches an epoch
    y = rng.normal(size=(n, model.size)).astype(np.float32)
    traj = rng.normal(size=(n, 30, 3)).astype(np.float32)
    params0 = model.init(torch.Generator().manual_seed(SEED), device=card)
    trainer = Trainer(cfg, data=(y, [traj]), device=card, seed=SEED)
    trainer_mesh = Trainer(cfg, data=(y, [traj]), mesh=mesh, seed=SEED)
    yb = torch.from_numpy(y[:DP_BATCH]).to(card)
    cb = [torch.from_numpy(traj[:DP_BATCH]).to(card)]
    c_s, c_u, _ = dp_step_check(trainer_mesh, model, params0, yb, cb,
                                f"[16 data parallel, (a)] one step at batch {DP_BATCH} on a 2-shard mesh on the card")
    for k in ("K2a", "K2b", "K3a", "K3b"):
        if c_u[k] < 1 or c_s[k] != 2 * c_u[k]:
            fail(f"the 2-shard step launched {k} {c_s[k]} times, not twice the unsharded step's {c_u[k]}")
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    trained = trainer_mesh.train(model, params0)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    c = dp_counts()
    hist = trainer_mesh.meta_scheduler.parameter_history
    losses = [v for _, v in hist["train_loss"]] + [v for _, v in hist["val_loss"]]
    if (c["K2a"], c["K2b"], c["K3b"]) != (6, 6, 24) or c["K3a"] != 4 * (1 + 6 + c["K1 forward"]) or c["K1 forward"] < 2:
        fail(f"Trainer.train on the mesh (3 steps of 2 shards) launched {c}")
    if not (np.all(np.isfinite(losses)) and all(torch.isfinite(t).all() for t in tree_leaves(trained))):
        fail(f"Trainer.train on the mesh gave non-finite losses or params: {losses}")
    for k in DP_KERNELS:
        dp_launches[k] += c[k]
    rate_u, rate_s = dp_rates(trainer, trainer_mesh, model, params0, yb, cb, card)
    print(f"    Trainer.train on the mesh, 1 epoch x 3 steps of {DP_BATCH} (2 x {DP_BATCH // 2} rows a step) + "
          f"validation, in {t_train:.2f} s; launches {c}; losses {', '.join(f'{v:.3f}' for v in losses)}; "
          f"train samples/s {rate_s:.0f} on the 2-shard mesh, {rate_u:.0f} unsharded (5 steps each, same call)")

    # (b) the same step under a one-rank NCCL process group: the reduce goes through NCCL
    torch.cuda.set_device(card)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
    try:
        if dist.get_backend() != "nccl":
            fail(f"the one-rank process group runs {dist.get_backend()}, not NCCL")
        mesh_nccl = Mesh([card], group=dist.group.WORLD)
        trainer_nccl = Trainer(cfg, data=(y, [traj]), mesh=mesh_nccl, seed=SEED)
        c_s, c_u, grads = dp_step_check(trainer_nccl, model, params0, yb, cb,
                                        "[16 (b)] the step on a one-rank NCCL process group")
        if c_s != c_u or c_s["K2b"] < 1:
            fail(f"the one-rank NCCL step launched {c_s}, the unsharded step {c_u}")
        flat = torch.cat([g.reshape(-1) for g in grads])
        ar_ms = cuda_ms(lambda: dist.all_reduce(flat, group=mesh_nccl.group), reps=5)
        print(f"    all_reduce of the step's grads ({flat.numel():,} floats, {4 * flat.numel() / 1e6:.0f} MB) on one "
              f"NCCL rank: {median(ar_ms):.3f} ms (CUDA events, median of 5, range {min(ar_ms):.3f}-{max(ar_ms):.3f})")
    finally:
        dist.destroy_process_group()

    # (c) sharded calibration ranks and resimulation against one device's
    pts = rng.normal(size=(DP_RANK_POINTS, model.size)).astype(np.float32)
    traj_pts = torch.from_numpy(rng.normal(size=(DP_RANK_POINTS, 30, 3)).astype(np.float32)).to(card)
    with torch.no_grad():
        s_u = model.sample(params0, torch.Generator(device=card).manual_seed(1), 1000, traj_pts, device=card)
        s_s = sample_sharded(mesh, model, replicate(mesh, params0), torch.Generator(device=card).manual_seed(1), 1000,
                             traj_pts)
    kw = dict(M_samples=M_DRAWS, sample_batch_size=1000, batch_size=DP_RANK_POINTS, device=card)
    ranks, counts, secs = [], [], []
    for m in (None, mesh):
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        ranks.append(compute_y_hat_ranks(model, params0, pts, traj_pts, mesh=m,
                                         generator=torch.Generator(device=card).manual_seed(SEED), **kw))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts.append(dp_counts())
    n_draws = -(-M_DRAWS // 1000)
    sample_d = (s_s - s_u).abs().max().item()
    bound = DP_SAMPLE_REL * max(1.0, s_u.abs().max().item())
    # near ties: the unsharded ranks' own draws (redrawn from the same seed) within the bound of the true value
    near = torch.zeros(pts.shape, dtype=torch.int64, device=card)
    y_pts, gen = torch.from_numpy(pts).to(card), torch.Generator(device=card).manual_seed(SEED)
    with torch.no_grad():
        for drawn in range(0, M_DRAWS, 1000):
            s = model.sample(params0, gen, min(1000, M_DRAWS - drawn), traj_pts, device=card)
            near += ((s - y_pts[None]).abs() <= bound).sum(dim=0)
    near = near.cpu().numpy()
    rank_d = np.abs(ranks[0] - ranks[1])
    print(f"[16 (c)] calibration ranks of {DP_RANK_POINTS} points at M = {M_DRAWS:,}: unsharded {secs[0]:.2f} s, "
          f"K1 {counts[0]['K1 inverse']} launches of {1000 * DP_RANK_POINTS:,} rows; sharded {secs[1]:.2f} s, K1 "
          f"{counts[1]['K1 inverse']} launches of {1000 * DP_RANK_POINTS // 2:,} rows; one batch of 1000 draws, "
          f"sharded vs unsharded samples max|d| {sample_d:.3e} (bound {bound:.3e} = {DP_SAMPLE_REL:g} x max(1, "
          f"max|unsharded| {s_u.abs().max().item():.3e})); {int((rank_d > 0).sum())} of {rank_d.size} ranks differ "
          f"(by at most {int(rank_d.max())}), {int(near.sum())} draws lie within the bound of their true value "
          f"({int((near > 0).sum())} of {near.size} entries)")
    if counts[0]["K1 inverse"] != n_draws or counts[1]["K1 inverse"] != 2 * n_draws:
        fail(f"the ranks launched K1 {counts[0]['K1 inverse']} times unsharded and {counts[1]['K1 inverse']} sharded")
    if not sample_d <= bound:
        fail(f"the sharded samples differ from the unsharded ones by {sample_d:.3e}, past {bound:.3e}")
    if np.any(rank_d > near):
        fail(f"{int((rank_d > near).sum())} sharded ranks differ from the unsharded ranks by more than the draws "
             f"within {bound:.3e} of their true value")
    for k in DP_KERNELS:
        dp_launches[k] += counts[1][k]
    # resimulation: the sharded path end to end (its draws sampled on the shards; held to
    # its shape and K1 launches only: the random-weight flagship's trajectories amplify
    # the samples' gap of a few 1e-6 past any fixed bar), then the sharded grid against
    # one device's on the same draws, as the JAX package's test isolates the grid with a
    # deterministic stand-in (tests/test_parallel.py:141)
    T, dt = float(cfg["data"]["T"]), float(cfg["data"]["dt"])
    traj_r = traj_pts[:DP_RESIM_POINTS]
    zero_counts()
    X_e = resimulate(model, params0, T, dt, {}, None, traj_r, m_samples=DP_RESIM_DRAWS, mesh=mesh, device=card,
                     generator=torch.Generator(device=card).manual_seed(SEED + 1))
    c = dp_counts()
    with torch.no_grad():
        y_hat = model.sample(params0, torch.Generator(device=card).manual_seed(SEED + 1), DP_RESIM_DRAWS, traj_r,
                             device=card)
    X_u, X_s = (resimulate(model, params0, T, dt, {}, y_hat, traj_r, mesh=m, device=card) for m in (None, mesh))
    finite = np.isfinite(X_u) & np.isfinite(X_s)
    d = float(np.abs(X_u - X_s)[finite].max()) if finite.any() else 0.0
    same = np.array_equal(np.isfinite(X_u), np.isfinite(X_s)) and np.array_equal(X_u[~finite], X_s[~finite],
                                                                                  equal_nan=True)
    print(f"    resimulation of {DP_RESIM_POINTS} points x {DP_RESIM_DRAWS} draws, {X_s.shape}: sharded end to end "
          f"{float(np.isfinite(X_e).mean()):.3f} finite (unsharded on its draws {float(np.isfinite(X_u).mean()):.3f}), "
          f"launches {c}; the sharded grid vs one device's on the same draws: max|d| {d:.3e} (tolerance 1e-6), the "
          f"same non-finite entries: {same}")
    if not (d <= 1e-6 and same and c["K1 inverse"] == 2 and X_e.shape == X_u.shape):
        fail(f"the sharded resimulation differs from the unsharded one ({d:.3e}, same non-finite entries {same}) "
             f"or launched K1 {c['K1 inverse']} times")
    for k in DP_KERNELS:
        dp_launches[k] += c[k]

    # (d) online video training on the mesh
    with open(sub_root_path(VIDEO_CONFIG)) as f:
        vcfg = yaml.safe_load(f)
    vmodel = CondRealNVP.from_config(load_config(VIDEO_CONFIG))
    vdata = vcfg["data"]
    sim = OnlineSimulator(load_yaml(vdata["config_file"]), vmodel.parameter_index_mapping,
                          condition_groups=vcfg["global"]["conditions"], dt=float(vdata["dt"]), T=float(vdata["T"]),
                          num_cams=int(vdata["num_cams"]))
    vparams = vmodel.init(torch.Generator().manual_seed(SEED), device=card)
    t_online = {}
    for m in (None, mesh):  # the unsharded run first, as the yardstick of the same call
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        vtrained, vhist = train_online(vmodel, vparams, sim, n_steps=DP_ONLINE_STEPS, batch_size=DP_ONLINE_BATCH,
                                       lr=2e-4, eval_every=DP_ONLINE_STEPS, eval_batches=1, seed=SEED, mesh=m,
                                       device=card)
        torch.cuda.synchronize()
        t_online[m is not None] = time.perf_counter() - t0
    c = dp_counts()
    vals = [v for k in ("train_loss", "eval_nll") for _, v in vhist[k]]
    print(f"    (d) train_online on videos_CNN_LSTM_large on the 2-shard mesh: {DP_ONLINE_STEPS} steps at batch "
          f"{DP_ONLINE_BATCH} ({DP_ONLINE_BATCH // 2} videos a shard, each simulated and rendered on the card) + 1 "
          f"eval batch in {t_online[True]:.2f} s (unsharded, same call: {t_online[False]:.2f} s; both with the "
          f"ActNorm init); launches {c}, a shard's K3a {(c['K3a'] - 8) // 2}, K3b {c['K3b'] // 2} "
          f"(4 a pass; the ActNorm init and the eval unsharded); history {vhist['train_loss']}, {vhist['eval_nll']}")
    if c["K3b"] != 2 * 4 * DP_ONLINE_STEPS or c["K3a"] != 4 * (2 * DP_ONLINE_STEPS + 2):
        fail(f"train_online on the mesh launched {c}")
    if not (np.all(np.isfinite(vals)) and all(torch.isfinite(t).all() for t in tree_leaves(vtrained))):
        fail(f"train_online on the mesh gave non-finite values: {vhist}")
    for k in DP_KERNELS:
        dp_launches[k] += c[k]
    del vmodel, vparams, vtrained, sim

    # (e) the CLI: `sample`/`eval --dp-devices 1` on the card; `train --dp-devices 2` raises (one card)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        with open(os.path.join(tmp, "params.pkl"), "wb") as f:
            pickle.dump(params_to_numpy(params0), f)
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump({"config_path": CONFIG}, f)
        data = {"trajectories": traj_pts.cpu().numpy()}
        data.update({p: pts[:, i] for i, p in enumerate(model.parameter_index_mapping.parameters)})
        data_path, out = os.path.join(tmp, "data.pkl"), os.path.join(tmp, "samples.npy")
        with open(data_path, "wb") as f:
            pickle.dump(data, f)
        zero_counts()
        cli.main(["sample", "-m", tmp, "-d", data_path, "-n", "100", "-o", out, "--dp-devices", "1"])
        samples, c_sample = np.load(out), dp_counts()
        zero_counts()
        (report, _, stages), t_eval = run_eval(["eval", "-m", tmp, "-d", data_path, "-o", os.path.join(tmp, "report"),
                                                "-M", "1000", "--resim-samples", "100", "--dp-devices", "1"])
        c_eval = dp_counts()
        try:
            cli.main(["train", "-c", CONFIG, "-d", data_path, "-o", os.path.join(tmp, "dp2"), "--dp-devices", "2"])
            fail("train --dp-devices 2 ran on one card")
        except ValueError as e:
            message = str(e)
        if "Requested a 2-device mesh but only 1 device(s) are visible" not in message:
            fail(f"train --dp-devices 2 raised {message!r}, not the JAX package's message")
    if (samples.shape != (100, DP_RANK_POINTS, model.size) or not np.isfinite(samples).all()
            or c_sample["K1 inverse"] != 1):
        fail(f"sample --dp-devices 1 gave {samples.shape}, finite={np.isfinite(samples).all()}, launches {c_sample}")
    if not np.isfinite(report["test_nll"]) or c_eval["K1 inverse"] < 1 or c_eval["K1 forward"] < 1:
        fail(f"eval --dp-devices 1: test NLL {report['test_nll']}, launches {c_eval}")
    print(f"    (e) sample --dp-devices 1: {samples.shape} finite, launches {c_sample}; eval --dp-devices 1 "
          f"({DP_RANK_POINTS} points, M 1000, 100 resimulation draws) in {t_eval:.2f} s, test NLL "
          f"{report['test_nll']:.3f}, launches {c_eval}; train --dp-devices 2 on one card raised: {message}")
    fused_lstm(False)
    missing = [k for k, v in dp_launches.items() if v < 1]
    if missing:
        fail(f"the sharded paths launched no {', '.join(missing)}: {dp_launches}")
    print(f"    phase 16 took {time.perf_counter() - t_start:.1f} s; the sharded paths' launches ((a) Trainer.train, "
          f"(c), (d)): {dp_launches}")
    return dp_launches


# ---------------------------------------------------------------------------
# phase 17: the policies set from the card's numbers (the fused LSTM's
# default, the training kernels' batch floor)
# ---------------------------------------------------------------------------

# the kernels lose a case of the fused LSTM's table past the host-bound spread
# (phase 9's rates move by up to 2x between calls; within one call less)
LSTM_LOSS = 0.75
FLOOR_BATCHES = (32, 64, 128, 256)
# the one-pass forward's row sweep: K2a at the floor sweep's batches and the
# flagship's 4096; K1's forward at `eval`'s 200 test points, a 2-shard
# validation's 2048 rows and `log_prob`'s 4096
FWD_SWEEP = {"K2a": (*FLOOR_BATCHES, 4096), "K1 forward": (200, 2048, 4096)}


def train_floor_sweep(rng, dev) -> None:
    """Phase 17 (b): the flagship's dropout-0 training step at float32 at 32,
    64, 128 and 256 rows with the training kernels (K2a/K2b on their 3xTF32
    `wgmma` routes), with the kernels on the row tiles forced, and without
    (plain autograd, forced by BCNF_FUSED_TRAIN_MIN_BATCH), in turns (wgmma,
    plain, row tiles, row tiles, plain, wgmma; the better of each side's two
    rates); the least batch from which the kernels win at every size
    measured, beside the model's floor; then K2a + K2b of one step (with the
    step's weight preparation on the `wgmma` side) at each batch on both
    routes, CUDA events in turns (median of 5 a turn, the better turn of
    each side). Fails where the row tiles' kernels are faster than the
    `wgmma` routes' (those take every batch)."""
    import numpy as np
    import torch

    from bcnf_tpu_torch.bridge import map_tree
    from bcnf_tpu_torch.models import CondRealNVP
    from bcnf_tpu_torch.ops.flow_kernel import ROUTE_FWD_WGMMA, ROUTE_ROWS, fused_flow_train_fwd
    from bcnf_tpu_torch.train import Trainer, make_optimizer

    cfg = _flagship_train_config(FLOOR_BATCHES[-1], 1)
    model = CondRealNVP.from_config(cfg)
    n = 2 * FLOOR_BATCHES[-1]
    y = rng.normal(size=(n, model.size)).astype(np.float32)
    traj = rng.normal(size=(n, 30, 3)).astype(np.float32)
    trainer = Trainer(cfg, data=(y, [traj]), device=dev, seed=SEED)
    params0 = model.init(torch.Generator().manual_seed(SEED), device=dev)
    rates, reps = {}, 5
    for B in FLOOR_BATCHES:
        yb, cb = torch.from_numpy(y[:B]).to(dev), [torch.from_numpy(traj[:B]).to(dev)]
        for side in ("wgmma", "plain", "row tiles", "row tiles", "plain", "wgmma"):
            kernels = side != "plain"
            os.environ["BCNF_FUSED_TRAIN_MIN_BATCH"] = "1" if kernels else str(1 << 30)
            params = map_tree(lambda t: t.detach().clone().requires_grad_(True), params0)
            opt = make_optimizer("Adam", lr=2e-4).init(params)
            gen = torch.Generator(device=dev).manual_seed(SEED)
            with train_row_tiles() if side == "row tiles" else contextlib.nullcontext():
                before = dict(fused_flow_train_fwd.route_launches)
                trainer.train_step(model, [params], opt, yb, cb, [gen])
                torch.cuda.synchronize()
                moved = {r: n - before.get(r, 0) for r, n in fused_flow_train_fwd.route_launches.items()
                         if n != before.get(r, 0)}
                want = {} if not kernels else {ROUTE_ROWS if side == "row tiles" else ROUTE_FWD_WGMMA: 1}
                if moved != want:
                    fail(f"the training floor sweep at {B} rows ({side}): K2a launched {moved}, not {want}")
                t0 = time.perf_counter()
                for _ in range(reps):
                    trainer.train_step(model, [params], opt, yb, cb, [gen])
                torch.cuda.synchronize()
            rate = reps * B / (time.perf_counter() - t0)
            rates[B, side] = max(rates.get((B, side), 0.0), rate)
    del os.environ["BCNF_FUSED_TRAIN_MIN_BATCH"]
    wins = [rates[B, "wgmma"] > rates[B, "plain"] for B in FLOOR_BATCHES]
    floor = next((B for i, B in enumerate(FLOOR_BATCHES) if all(wins[i:])), None)
    print("    (b) the training kernels' batch floor: the flagship's dropout-0 step at float32, train samples/s "
          "with K2a/K2b on the 3xTF32 wgmma routes, on the row tiles, and with plain autograd (better of two turns "
          "each, 5 steps a turn): " + "; ".join(
              f"{B} rows {rates[B, 'wgmma']:.0f} / {rates[B, 'row tiles']:.0f} / {rates[B, 'plain']:.0f} "
              f"({rates[B, 'wgmma'] / rates[B, 'plain']:.2f}x plain, {rates[B, 'wgmma'] / rates[B, 'row tiles']:.2f}x "
              f"the row tiles)" for B in FLOOR_BATCHES) +
          f"; the least batch from which the kernels win at every size measured: {floor}; the model's "
          f"fused_train_min_batch: {model.fused_train_min_batch}")
    from bcnf_tpu_torch.ops import flow_kernel as fk

    kernel_ms, lost = {}, []
    for B in FLOOR_BATCHES:
        with torch.no_grad():
            kargs, hp = model._fused_flow_args(params0, model.encode(params0, (torch.from_numpy(traj[:B]).to(dev),)))
            args = [kargs[k].contiguous() for k in TRAIN_ARGS]
            xb = torch.from_numpy(y[:B]).to(dev)
            _, _, bound = fk.fused_flow_train_reference(xb, hp, *args)
            dz, dld = randn_cotangents(xb)

            def step():
                ws = fk.train_weights(xb, hp, args[5], args[3].shape[1], fk.MODE_3XTF32)
                fk.fused_flow_train_fwd(xb, hp, *args, wstages=ws)
                fk.fused_flow_train_bwd(bound, hp, dz, dld, *args, wstages=ws)

            for side in ("wgmma", "row tiles", "row tiles", "wgmma"):
                with train_row_tiles() if side == "row tiles" else contextlib.nullcontext():
                    t = median(cuda_ms(step, reps=5))
                kernel_ms[B, side] = min(kernel_ms.get((B, side), float("inf")), t)
        if not kernel_ms[B, "wgmma"] < kernel_ms[B, "row tiles"]:
            lost.append(f"{B} rows ({kernel_ms[B, 'wgmma']:.3f} against {kernel_ms[B, 'row tiles']:.3f} ms)")
    print("    (b) K2a + K2b of one float32 step (CUDA events, better of two turns, median of 5 each; the wgmma side "
          "with its weight preparation), the 3xTF32 wgmma routes / the row tiles: " + "; ".join(
              f"{B} rows {kernel_ms[B, 'wgmma']:.3f} / {kernel_ms[B, 'row tiles']:.3f} ms "
              f"({kernel_ms[B, 'row tiles'] / kernel_ms[B, 'wgmma']:.2f}x)" for B in FLOOR_BATCHES))
    if lost:
        fail("the 3xTF32 wgmma training routes take every batch, but the row tiles were faster at " + "; ".join(lost))


def fwd_row_sweep(model, params, rng, dev) -> None:
    """Phase 17 (b): the forward's routes by rows at the flagship's widths,
    in one pass and in 3xTF32: K2a at 32, 64, 128, 256 and 4096 rows (on
    weights prepared once, as a training step hands them over) and K1's
    forward at 200, 2048 and 4096 rows (each call preparing its weights), on
    the mode's `wgmma` forward and on its forced row tiles, in turns (wgmma,
    row tiles, row tiles, wgmma; CUDA events, median of 5 a turn, the better
    turn of each side); the least row count from which the `wgmma` forward
    wins at every size measured. Fails where the route takes the `wgmma`
    forward (it has no row floor) and the row tiles were faster."""
    import numpy as np
    import torch

    from bcnf_tpu_torch.ops import flow_kernel as fk

    with torch.no_grad():
        traj = torch.from_numpy(rng.normal(size=(4096, 30, 3)).astype(np.float32)).to(dev)
        kt, hpt = model._fused_flow_args(params, model.encode(params, (traj,)))
    args = [kt[k].contiguous() for k in TRAIN_ARGS]
    x = torch.from_numpy(rng.normal(size=(4096, model.size)).astype(np.float32)).to(dev)
    Hp, d_a = hpt.shape[-1], kt["w1y"].shape[1]
    best, lines, losses = {}, [], []
    for mode, route in ((fk.MODE_TF32, fk.ROUTE_FWD_WGMMA_TF32), (fk.MODE_3XTF32, fk.ROUTE_FWD_WGMMA)):
        if fk.flow_route(Hp, model.size, d_a, False, mode) != route:
            fail(f"the flagship's forward in {mode} does not take its wgmma forward")
        ws = fk.prepare_train_weights(kt["wm"], passes=1 if mode == fk.MODE_TF32 else 3)
        for what, sizes in FWD_SWEEP.items():
            sweep_one(what, sizes, mode, ws, x, hpt, args, kt, best, lines, losses)
    if losses:
        fail("the forward takes the wgmma forward at every batch, but the row tiles were faster: "
             + "; ".join(losses))


def sweep_one(what: str, sizes, mode: str, ws, x, hpt, args, kt, best: dict, lines: list, losses: list) -> None:
    """One line of `fwd_row_sweep`: `what` (K2a or K1's forward) in `mode` at
    each row count of `sizes`, the `wgmma` forward against its row tiles."""
    import torch

    from bcnf_tpu_torch.ops import flow_kernel as fk

    for B in sizes:
        xb, hb = x[:B].contiguous(), hpt[:, :B].contiguous()
        if what == "K2a":
            def run():
                return fk.fused_flow_train_fwd(xb, hb, *args, mode=mode, wstages=ws)
        else:
            def run():
                return fk.fused_flow(xb, hb, **kt, inverse=False, n_cond=B, mode=mode)
        with torch.no_grad():
            for side in ("wgmma", "row tiles", "row tiles", "wgmma"):
                with row_tiles_forced("FWD_WGMMA_MAX_TN") if side == "row tiles" else contextlib.nullcontext():
                    t = median(cuda_ms(run, reps=5))
                best[what, mode, B, side] = min(best.get((what, mode, B, side), float("inf")), t)
        wg, tiles = best[what, mode, B, "wgmma"], best[what, mode, B, "row tiles"]
        lines.append(f"{B} rows {wg:.3f} / {tiles:.3f} ms ({tiles / wg:.2f}x)")
        if not wg < tiles:
            losses.append(f"{what} ({mode}) at {B} rows ({wg:.3f} against {tiles:.3f} ms)")
    wins = [best[what, mode, B, "wgmma"] < best[what, mode, B, "row tiles"] for B in sizes]
    floor = next((B for i, B in enumerate(sizes) if all(wins[i:])), None)
    print(f"    (b) the {'one-pass' if mode == fk.MODE_TF32 else '3xTF32'} forward's routes by rows, {what} (the "
          f"wgmma forward / the row tiles, better of two turns, median of 5 each): " +
          "; ".join(lines[-len(sizes):]) +
          f"; the least rows from which the wgmma forward wins at every size measured: {floor}")


def card_policies(model, params, rng, dev) -> None:
    """Phase 17: (a) the fused LSTM's table (phases 9, 10, 12 and 14: each
    published configuration with the encoder on K3a/K3b and on the time
    loop, in this run) and the default it sets: with BCNF_FUSED_LSTM unset
    a CUDA tensor takes K3a/K3b, a CPU tensor the time loop; fails where the
    kernels lose a case past LSTM_LOSS; (b) the training floor sweep and
    the one-pass forward's row sweep."""
    import numpy as np
    import torch

    from bcnf_tpu_torch.ops.lstm import _fused_enabled

    t0 = time.perf_counter()
    os.environ.pop("BCNF_FUSED_LSTM", None)  # the port's default from here on
    print("[17 the card's policies] (a) the fused LSTM (K3a/K3b) against the encoders' time loop, this run:")
    losses = []
    for case, (kernels, loop, unit) in LSTM_TABLE.items():
        gain = loop / kernels if unit == "s" else kernels / loop
        print(f"      {case}: {kernels:.4g} with K3a/K3b, {loop:.4g} with the time loop ({unit}): {gain:.2f}x")
        if gain < LSTM_LOSS:
            losses.append(f"{case} ({gain:.2f}x)")
    traj = torch.from_numpy(rng.normal(size=(N_COND, 30, 3)).astype(np.float32))
    with torch.no_grad():
        zero_counts()
        out = model.sample(params, torch.Generator().manual_seed(SEED), 1000, traj, device=dev)
        torch.cuda.synchronize()
        c = lstm_counts()
    default = {"cuda": _fused_enabled(torch.device("cuda")), "cpu": _fused_enabled(torch.device("cpu"))}
    print(f"    BCNF_FUSED_LSTM unset: the fused recurrence on a CUDA tensor {default['cuda']}, on a CPU tensor "
          f"{default['cpu']}; the flagship's `sample` on the card launched K3a {c['K3a']}, K1 {c['K1']}")
    if default != {"cuda": True, "cpu": False} or (c["K3a"], c["K1"]) != (4, 1) or not torch.isfinite(out).all():
        fail(f"the fused LSTM's default: {default}, the flagship's sample launched K3a {c['K3a']}, K1 {c['K1']}")
    if losses:
        fail(f"the fused LSTM is the default on the card but loses {', '.join(losses)} past {LSTM_LOSS:g}x")
    train_floor_sweep(rng, dev)
    fwd_row_sweep(model, params, rng, dev)
    print(f"    phase 17 took {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
