"""The whole RealNVP flow in CUDA kernels: host side.

- K1, `fused_flow`, replaces `bcnf_tpu/ops/flow_kernel.py::fused_flow` (the
  Pallas TPU kernel `_flow_kernel`). Its route is chosen by mode and shape
  (`flow_route`), never by catching a failure:
  - the default mode (the "highest"/"float32" contract, which the JAX model
    serves with its "x3" kernel mode) runs 3xTF32 on the tensor cores: the
    inverse on `wgmma` (`csrc/flow_wgmma.cu`: 2-block clusters splitting
    each hidden layer's columns, each k-stage's three passes folded into a
    float32 sum; the hidden weights prepared once a call by
    `prepare_weights`) at padded widths up to 544, and the forward there on
    the `wgmma` forward of `csrc/flow_fwd_wgmma.cu` (three passes a k-step,
    on the hi/lo weights `prepare_train_weights(wm, passes=3)` lays out);
    at the padded widths 768 and 1024 both ways on `wgmma` clusters of
    Hp/128 blocks on a distributed tile (`csrc/flow_wide_wgmma.cu`,
    streaming the hidden weights once in float32 as `prepare_wide_weights`
    lays them out once a call; the inverse folds each k-step, the forward,
    on 128- or 64-row tiles by the batch, every 16);
    the row-tile kernel (`rows_flow_kernel` in `csrc/flow_kernel.cu`) where
    none of these takes the shape;
  - the reduced mode (the "default", "bfloat16" and "BF16_BF16_F32_X3"
    precisions, which the JAX model serves with its "default" kernel mode)
    runs the same kernels built with one TF32 pass a product (the `*_tf32`
    libraries, `ops/_build.py`); its `wgmma` inverse streams hi-only weight
    stages (`prepare_weights(wm, passes=1)`), and its forward at padded
    widths up to 544 runs the `wgmma` forward of `csrc/flow_fwd_wgmma.cu` on
    the weights `prepare_train_weights` lays out; at 768 and 1024 both ways
    run the one-pass build of `csrc/flow_wide_wgmma.cu`, on the hidden
    weights rounded to TF32 once a call (`prepare_wide_weights(wm,
    passes=1)`);
  - the strict mode (`CondRealNVP(pallas_strict=True)`, as the JAX model's
    strict flag forces its exact-float32 kernel mode) runs the float32 FMA
    kernel (`csrc/flow_fma.cu`) both ways: persistent blocks, one an SM,
    over balanced ranges of row groups (`fma_layout`).
- K4, the per-coupling kernel, is K1 at one step (`ops/coupling_kernel.py`).
- K2a/K2b, `fused_flow_train`, replace `fused_flow_train` and its custom VJP
  (`fwd_call`/`bwd_call` of `_make_fused_flow_train`): a
  `torch.autograd.Function` whose forward is K2a (`fused_flow_train_fwd`, on
  the forward route `flow_route` gives: the row-tile kernel with its
  step-input store, or at padded widths up to 544 the `wgmma` forward of
  `csrc/flow_fwd_wgmma.cu`, and at 768 and 1024 the wide forward of
  `csrc/flow_wide_wgmma.cu` built for the mode; strict, the FMA kernel with its step-input
  store) and whose backward is K2b (`fused_flow_train_bwd`, on the route
  `train_bwd_route` gives: the row tiles of `csrc/flow_train_kernel.cu`, or
  at padded widths up to 544 the `wgmma` route of
  `csrc/flow_train_wgmma.cu`, at 768 and 1024 the wide backward of
  `csrc/flow_wide_train_wgmma.cu` built for the mode, or strict the float32 FMA kernels of
  `csrc/flow_train_fma.cu`). Both `wgmma` routes read the hidden weights as
  `prepare_train_weights` lays them out for their mode (hi, and in 3xTF32
  lo beside it), prepared once a step and handed from K2a to K2b; at 768
  and 1024 the wide forward and the wide backward read
  `prepare_wide_train_weights` (`prepare_wide_weights`' layout of Wm and of
  Wm^T, for the mode) in the same way. The
  strict K2b recomputes nothing of the MLP: the strict K2a keeps each
  layer's activations and gelu' for it (`train_keep`, which both require),
  handed from K2a to K2b in the same way; where a row chunk's keep would
  pass its share of the card's memory, the strict backward runs in row
  chunks, K2a again a chunk (`strict_chunks`). The
  tensor-core routes run their square hidden products in 3xTF32, or in one
  TF32 pass in the reduced mode; the strict routes every product in float32
  FMA.

The kernel modes (`KERNEL_MODES`): `MODE_3XTF32`, `MODE_TF32` (one pass) and
`MODE_FMA` (strict: K1, K2a and K2b; `TRAIN_MODES`). K4 has the first two
(`TF32_MODES`). A CPU tensor takes the plain version, float32, in every
mode, as JAX on the CPU computes float32 at every precision.

This module stacks and pads the kernels' arguments, checks them, launches
them on PyTorch's current stream, and holds their plain PyTorch versions
(`fused_flow_reference`, `fused_flow_train_reference`,
`fused_flow_train_backward_reference`, and `train_keep_reference`, what the
strict K2a keeps), which serve CPU tensors (the tests) and which
`chip_smoke.py` holds the kernels against on the card.

Layout contract (the same as the JAX kernel's): rows are draws-major, row
``r`` uses the condition projection ``h_proj[step, r % n_cond]``; step ``K``
(the last of ``K+1``) is the final coupling, whose ActNorm and orthonormal
slots are identity and are skipped exactly. Unlike the TPU kernel there is no
tiling rule on ``B`` or ``n_cond``: the kernel masks the ragged last tile.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
import re
from collections.abc import Callable
from pathlib import Path
from typing import Any

import torch
import torch.nn.functional as F

from bcnf_tpu_torch.ops.nn import gelu, gelu_grad

# Each thread of the kernel owns `TN` columns of the padded hidden width
# (32 * TN); these are the widths it is compiled for (`csrc/flow_kernel.cu`).
KERNEL_TN = (1, 2, 4, 8, 12, 16, 17, 24, 32)


# The kernels' arithmetic: 3xTF32 (the default mode: JAX's "x3"), one TF32
# pass (the reduced mode: JAX's "default") and float32 FMA (strict: JAX's
# "highest" kernel mode; K1, K2a and K2b).
MODE_3XTF32, MODE_TF32, MODE_FMA = "3xtf32", "tf32", "fma"
KERNEL_MODES = (MODE_3XTF32, MODE_TF32, MODE_FMA)
TRAIN_MODES = KERNEL_MODES  # K2a's and K2b's modes
TF32_MODES = (MODE_3XTF32, MODE_TF32)  # the tensor-core modes: K4 has no float32 FMA mode (nor has JAX's)
# K1's routes (`flow_route`): 3xTF32 on `wgmma` (the inverse at TN <= 17),
# 3xTF32 on the row tiles, float32 FMA (strict), and the one-pass `wgmma`
# and row tiles; each route's library (`ops/_build.py`).
ROUTE_WGMMA, ROUTE_ROWS, ROUTE_FMA = "wgmma", "rows", "fma"
ROUTE_WIDE = "wide_wgmma"  # the 3xTF32 inverse at Hp 768 and 1024 (csrc/flow_wide_wgmma.cu)
ROUTE_WIDE_FWD = "wide_fwd_wgmma"  # the 3xTF32 forward there (K1's, K2a's, K4's; the same source)
ROUTE_WIDE_TF32 = "wide_wgmma_tf32"  # the one-pass inverse there (the same source's one-pass build)
ROUTE_WIDE_FWD_TF32 = "wide_fwd_wgmma_tf32"  # the one-pass forward there
WIDE_ROUTES = (ROUTE_WIDE, ROUTE_WIDE_FWD, ROUTE_WIDE_TF32, ROUTE_WIDE_FWD_TF32)
WIDE_FWD_ROUTES = (ROUTE_WIDE_FWD, ROUTE_WIDE_FWD_TF32)
WIDE_TF32_ROUTES = (ROUTE_WIDE_TF32, ROUTE_WIDE_FWD_TF32)  # read the one-pass layout of the hidden weights
ROUTE_WGMMA_TF32, ROUTE_ROWS_TF32 = "wgmma_tf32", "rows_tf32"
# the forward on wgmma (K1, K2a, K4; csrc/flow_fwd_wgmma.cu), in 3xTF32 and in one pass
ROUTE_FWD_WGMMA, ROUTE_FWD_WGMMA_TF32 = "fwd_wgmma", "fwd_wgmma_tf32"
FWD_WGMMA_ROUTES = (ROUTE_FWD_WGMMA, ROUTE_FWD_WGMMA_TF32)
ROUTE_LIBRARY = {ROUTE_WGMMA: "flow_wgmma", ROUTE_ROWS: "flow_kernel", ROUTE_FMA: "flow_fma",
                 ROUTE_WGMMA_TF32: "flow_wgmma_tf32", ROUTE_ROWS_TF32: "flow_kernel_tf32",
                 ROUTE_FWD_WGMMA: "flow_fwd_wgmma", ROUTE_FWD_WGMMA_TF32: "flow_fwd_wgmma_tf32",
                 ROUTE_WIDE: "flow_wide_wgmma", ROUTE_WIDE_FWD: "flow_wide_wgmma",
                 ROUTE_WIDE_TF32: "flow_wide_wgmma_tf32", ROUTE_WIDE_FWD_TF32: "flow_wide_wgmma_tf32"}
WGMMA_MAX_TN = 17  # the widest width the wgmma inverse holds (Hp 544; csrc/flow_wgmma.cu)
WIDE_TN = (24, 32)  # the widths the wide inverse and forward are built for (Hp 768, 1024; csrc/flow_wide_wgmma.cu)
WIDE_WGMMA_MAX_TN = 32  # the widest of them the wide inverse takes; 0 forces the row tiles there in both modes
WIDE_FWD_MAX_TN = 32  # the widest of them the wide forward takes; 0 forces the row tiles there in both modes
# the wide forward walks 64-row tiles (kWwHalfRows) up to this many rows: one wave of the 15 clusters an
# H100 holds at Hp 1024 (PERF.md: 256 and 960 rows 6.32 and 6.48 ms on 64-row tiles, 7.74 and 7.92 on 128;
# 4096 rows 34.91 and 23.72)
WIDE_FWD_HALF_MAX_ROWS = 960
FWD_WGMMA_MAX_TN = 17  # the widest width the wgmma forward holds (Hp 544); 0 forces the row tiles in both modes
ROUTE_TRAIN_BWD = "train_bwd"  # K2b's rows kernel, for `kernel_smem` (csrc/flow_train_kernel.cu: launch_rows)
# K2b's routes (`train_bwd_route`): the row tiles in 3xTF32 (`ROUTE_ROWS`) and
# in one pass (`ROUTE_ROWS_TF32`), the `wgmma` route in 3xTF32
# (`ROUTE_WGMMA`) and in one pass (`ROUTE_WGMMA_TF32`), both
# csrc/flow_train_wgmma.cu, and the strict float32 FMA route (`ROUTE_FMA`,
# csrc/flow_train_fma.cu); each route's library.
ROUTE_WIDE_TRAIN = "wide_train_wgmma"  # K2b in 3xTF32 at Hp 768 and 1024 (csrc/flow_wide_train_wgmma.cu)
ROUTE_WIDE_TRAIN_TF32 = "wide_train_wgmma_tf32"  # K2b in one pass there (the same source's one-pass build)
WIDE_TRAIN_ROUTES = (ROUTE_WIDE_TRAIN, ROUTE_WIDE_TRAIN_TF32)
TRAIN_BWD_LIBRARY = {ROUTE_ROWS: "flow_train_kernel", ROUTE_ROWS_TF32: "flow_train_kernel_tf32",
                     ROUTE_WGMMA: "flow_train_wgmma", ROUTE_WGMMA_TF32: "flow_train_wgmma_tf32",
                     ROUTE_FMA: "flow_train_fma", ROUTE_WIDE_TRAIN: "flow_wide_train_wgmma",
                     ROUTE_WIDE_TRAIN_TF32: "flow_wide_train_wgmma_tf32"}
ROUTE_TRAIN_BWD_FMA = "train_bwd_fma"  # the strict K2b's rows kernel, for `kernel_smem` (csrc: ft_smem)
ROUTE_TRAIN_BWD_WGMMA = "train_bwd_wgmma"  # its rows kernel, for `kernel_smem` (csrc/flow_train_wgmma.cu: tw_smem)
TRAIN_WGMMA_MAX_TN = 17  # the widest width K2b's wgmma route holds (Hp 544); 0 forces the row tiles in both modes
WIDE_TRAIN_MAX_TN = 32  # the widest of WIDE_TN K2b's wide route takes; 0 forces the row tiles there in both modes
# The constants of the kernels' sources that the host side reads, by the
# source that defines each: the dynamic shared memory a block may use and
# the weight-grad jobs one AtbJobs launch holds (K2b's nh + 3 a step), the
# limits the launchers check; the `wgmma` inverse's weight ring and blocks of
# a cluster by arithmetic (`wgmma_ring`), the k-steps a 3xTF32 stage holds
# and its cluster's hand-off barriers; K2b's
# `wgmma` route's rows a cluster, blocks a cluster and weight ring (stages of
# kTwStageK rows); the strict kernel's consumer warps, rows a lane, the
# widest TN at that many rows, weight rows a stage and the bounds of its
# ring (`fma_layout`); the one-pass `wgmma` forward's rows a cluster, blocks
# a cluster, weight rows a stage, the bounds of its ring and the floats of
# its barriers (`fwd_wgmma_ring`); the strict K2b's weight-grad jobs a step
# and that pass's output tile and rows a stage (`fma_atb_tiles`); the wide
# inverse's (and forward's) rows a cluster, the forward's smaller tile, columns
# a block, k-steps a stage, its two 3xTF32 rings' stages and its one-pass
# ring's stages.
_SOURCE_CONSTANTS = {"kFtMaxJobs": "flow_train_fma.cu", "kFtTile": "flow_train_fma.cu", "kFtK": "flow_train_fma.cu",
                     "kSmemLimit": "flow_common.cuh", "kAtbMaxJobs": "atb.cuh",
                  **{name: "flow_wgmma.cu" for name in ("kWgRing3xTf32", "kWgCluster3xTf32", "kWgRingTf32",
                                                         "kWgClusterTf32", "kWgStageK", "kWgXchBarriers")},
                  "kTwRows": "flow_train_wgmma.cu", "kTwCluster": "flow_train_wgmma.cu",
                  "kTwRing": "flow_train_wgmma.cu", "kTwStageK": "flow_train_wgmma.cu",
                  **{name: "flow_fma.cu" for name in ("kFmaWarps", "kFmaLaneRows", "kFmaWideTN", "kFmaStageRows",
                                                       "kFmaRingMin", "kFmaRingMax")},
                  **{name: "flow_fwd_wgmma.cu" for name in ("kFwRows", "kFwCluster", "kFwStageK", "kFwRingMin",
                                                             "kFwRingMax", "kFwBarrierFloats")},
                  **{name: "flow_wide_wgmma.cu" for name in ("kWwRows", "kWwHalfRows", "kWwCols", "kWwStageK",
                                                              "kWwHiStages", "kWwLoStages", "kWwHiStagesTf32")}}


@functools.cache
def kernel_limit(name: str) -> int:
    """A constant of `_SOURCE_CONSTANTS`, read from the `constexpr` in its
    source under `csrc/`, so that the gates and the launchers' checks share
    one number. Read at first use, not at import."""
    text = (Path(__file__).resolve().parent / "csrc" / _SOURCE_CONSTANTS[name]).read_text()
    match = re.search(rf"constexpr\s+\w+\s+{name}\s*=\s*(\d+)\s*;", text)
    if match is None:
        raise RuntimeError(f"no constexpr {name} in csrc/{_SOURCE_CONSTANTS[name]}")
    return int(match.group(1))


def wgmma_ring(route: str) -> tuple[int, int]:
    """(stages of the weight ring, blocks of a cluster) of the `wgmma`
    inverse on `route` (`csrc/flow_wgmma.cu`): in 3xTF32 the blocks of a
    cluster own the same 64 rows, each half of every hidden layer's columns;
    in one pass each block owns its 64 rows and the cluster shares each stage."""
    if route == ROUTE_WGMMA:
        return kernel_limit("kWgRing3xTf32"), kernel_limit("kWgCluster3xTf32")
    if route == ROUTE_WGMMA_TF32:
        return kernel_limit("kWgRingTf32"), kernel_limit("kWgClusterTf32")
    raise ValueError(f"{route!r} is not a wgmma route")


def wgmma_grid(route: str, B: int) -> int:
    """Blocks the `wgmma` inverse on `route` launches for B rows, in whole
    clusters (`csrc/flow_wgmma.cu`: `launch`): 3xTF32 a cluster a 64-row
    tile; one pass the 64-row tiles rounded up to whole clusters (a block
    past the last row runs on masked rows)."""
    cluster, tiles = wgmma_ring(route)[1], -(-B // 64)
    return cluster * (tiles if route == ROUTE_WGMMA else -(-tiles // cluster))


def wide_grid(B: int, Hp: int, rows: int | None = None) -> int:
    """Blocks the wide inverse, or the wide forward on tiles of `rows` rows,
    launches for B rows at the padded width Hp (`csrc/flow_wide_wgmma.cu`:
    `ww_launch`): a cluster of Hp/kWwCols blocks a tile of `rows` rows
    (default kWwRows, the inverse's)."""
    return -(-B // (rows or kernel_limit("kWwRows"))) * (Hp // kernel_limit("kWwCols"))


def wide_fwd_rows(B: int) -> int:
    """Rows of the wide forward's tile for a call of B rows: kWwHalfRows (the
    two consumer warpgroups of a block split its columns) up to
    `WIDE_FWD_HALF_MAX_ROWS` rows, where twice the clusters shorten the walk
    more than the halved products cost (PERF.md: the card's row sweep), else
    kWwRows."""
    return kernel_limit("kWwHalfRows") if B <= WIDE_FWD_HALF_MAX_ROWS else kernel_limit("kWwRows")


def wide_rings(mode: str = MODE_3XTF32) -> int:
    """Stages of the wide kernels' weight rings in `mode`
    (`csrc/flow_wide_wgmma.cu`: kWwHi + kWwLo): in 3xTF32 the hi ring's
    kWwHiStages and the lo ring's kWwLoStages, in one pass the hi ring alone
    of kWwHiStagesTf32."""
    _check_mode(mode, TF32_MODES)
    if mode == MODE_TF32:
        return kernel_limit("kWwHiStagesTf32")
    return kernel_limit("kWwHiStages") + kernel_limit("kWwLoStages")


def wide_smem(Hp: int, size: int, d_a: int, rows: int | None = None, forward: bool = False,
              mode: str = MODE_3XTF32) -> int:
    """Bytes of shared memory a block of the wide inverse, or of the wide
    forward, takes on tiles of `rows` rows (default kWwRows) at this shape in
    `mode` (`csrc/flow_wide_wgmma.cu`: `ww_smem`): the tile of the block's
    columns (the 3xTF32 inverse's rows of cols + 4 floats; the forward's,
    and in one pass both directions', fragment-major, unpadded); the weight rings (`wide_rings`: kWwStageK k-steps of 8 rows of the
    block's columns a stage); x and the mix's output; the C blocks' partial
    [t | s'] of the ceil(rows / C) rows a block reduces, and [t | s'] of
    every row; 2 barriers a ring stage and 3 a block of the cluster; the
    forward adds the step's W1y (d_a rows), b1 and Wout (n_out floats a
    row) of the block's columns, the rows' logdet, the step's Q, ActNorm
    scale and bias (to a multiple of 2 floats), a layer's bias of the
    block's columns, 2 barriers and, on 64-row tiles, a second tile (h_l
    and h_{l+1} in turn)."""
    rows, cols = rows or kernel_limit("kWwRows"), kernel_limit("kWwCols")
    C, stages, n_out = Hp // cols, wide_rings(mode), 2 * (size - d_a)
    stage, reduced = kernel_limit("kWwStageK") * 8 * cols, C * -(-rows // C) + rows
    two = rows * cols if rows == kernel_limit("kWwHalfRows") else 0  # the 64-row tiles' second tile
    fwd = (d_a + 1 + n_out) * cols + rows + (size * size + 2 * size + 1) // 2 * 2 + cols + two if forward else 0
    tile = cols if forward or mode == MODE_TF32 else cols + 4
    return (4 * (rows * tile + stages * stage + rows * 2 * size + reduced * n_out + fwd)
            + 8 * (2 * stages + 3 * C + (2 if forward else 0)))


def wide_takes(Hp: int, size: int, d_a: int, forward: bool = False, mode: str = MODE_3XTF32) -> bool:
    """Whether the wide inverse (or the wide forward) of `mode` takes the
    shape (`ww_takes`): a width it is built for, and its shared memory on its
    kWwRows-row tile (which grows with the rows' state and the cluster's
    partial outputs) within a block's; the forward's smaller tile then fits
    too."""
    one = mode == MODE_TF32
    route = (ROUTE_WIDE_FWD_TF32 if one else ROUTE_WIDE_FWD) if forward else (ROUTE_WIDE_TF32 if one else ROUTE_WIDE)
    return Hp // 32 in WIDE_TN and kernel_smem(route, Hp, size, d_a) <= kernel_limit("kSmemLimit")


def wide_train_smem(Hp: int, size: int, d_a: int, rows: int | None = None, mode: str = MODE_3XTF32) -> int:
    """Bytes of shared memory a block of K2b's wide rows kernel takes on
    tiles of `rows` rows (default kWwRows) at this shape in `mode`
    (`csrc/flow_wide_train_wgmma.cu`: `wt_smem`): the tile of the block's
    columns (two on 64-row tiles), the weight rings (`wide_rings`), the step's W1y, b1 and
    Wout of the block's columns, per row x1, dx2, [t | s'], dx_a and dld, the
    C blocks' partials of the ceil(rows / C) rows a block reduces (max(n_out,
    d_a) floats a row), to an even count of floats; then 2 barriers a ring
    stage, 3 a block of the cluster and 1 for the step's weights."""
    rows, cols = rows or kernel_limit("kWwRows"), kernel_limit("kWwCols")
    C, stages, n_out = Hp // cols, wide_rings(mode), 2 * (size - d_a)
    tiles = 2 if rows == kernel_limit("kWwHalfRows") else 1
    floats = (tiles * rows * cols + stages * kernel_limit("kWwStageK") * 8 * cols + (d_a + 1 + n_out) * cols
              + rows * (2 * size + n_out + d_a + 1) + C * -(-rows // C) * max(n_out, d_a))
    return 4 * (floats + floats % 2) + 8 * (2 * stages + 3 * C + 1)


def wide_train_takes(Hp: int, size: int, d_a: int, mode: str = MODE_3XTF32) -> bool:
    """Whether K2b's wide route of `mode` takes the shape (`wt_smem` within
    a block's on its kWwRows-row tile; the 64-row tiles then fit too): a
    width the wide kernels are built for."""
    return (Hp // 32 in WIDE_TN and Hp % 32 == 0
            and wide_train_smem(Hp, size, d_a, mode=mode) <= kernel_limit("kSmemLimit"))


def wide_train_card_layout(Hp: int, size: int, d_a: int, rows: int | None = None,
                           mode: str = MODE_3XTF32) -> tuple[int, int, int, int]:
    """K2b's wide route of `mode` at this shape on tiles of `rows` rows
    (default kWwRows) on the current card (`csrc/flow_wide_train_wgmma.cu`:
    `bcnf_flow_train_wide_layout`): the rows kernel's bytes of shared memory
    a block and its clusters resident at once, the weight-grad pass's bytes
    a block and its blocks resident on an SM."""
    from bcnf_tpu_torch.ops._build import load_library

    lib = load_library(TRAIN_BWD_LIBRARY[ROUTE_WIDE_TRAIN_TF32 if mode == MODE_TF32 else ROUTE_WIDE_TRAIN])
    out = (ctypes.c_int * 4)()
    _raise_on(lib.bcnf_flow_train_wide_layout(Hp, size, d_a, rows or kernel_limit("kWwRows"), out), lib,
              "wide_train_card_layout")
    return tuple(out)


def padded_width(H: int, compiled: tuple[int, ...] = KERNEL_TN) -> int:
    """The hidden width a kernel runs at: the smallest 32*TN >= H of the TN
    it is compiled for (default: the flow kernels')."""
    for tn in compiled:
        if 32 * tn >= H:
            return 32 * tn
    raise ValueError(f"hidden width {H} exceeds the kernel's largest width {32 * compiled[-1]}")


def stack_flow_params(model: Any, params: dict) -> dict:
    """Stacked per-step kernel arguments from a `CondRealNVP` param tree
    (`bcnf_tpu/ops/flow_kernel.py:290-323`). Entry K is the final coupling;
    its ActNorm and orthonormal slots are identity."""
    size = model.size
    d_a = model.coupling.d_a
    blocks = params["blocks"]
    cp = blocks["coupling"]["a"]["layers"]  # leaves (K, ...)
    fin = params["final"]["a"]["layers"]

    def cat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.cat([a, b[None]], dim=0)

    K = cp[0]["w"].shape[0]
    w1 = cat(cp[0]["w"], fin[0]["w"])
    ones = cp[0]["w"].new_ones((size,))
    zeros = cp[0]["w"].new_zeros((size,))
    if model.actnorm is not None:
        an_s = cat(blocks["actnorm"]["scale"], ones)
        an_b = cat(blocks["actnorm"]["bias"], zeros)
    else:
        an_s = ones.expand(K + 1, size)
        an_b = zeros.expand(K + 1, size)
    return {
        "an_scale": an_s,
        "an_bias": an_b,
        "ortho": cat(blocks["ortho"], torch.eye(size, dtype=w1.dtype, device=w1.device)),
        "w1y": w1[:, :d_a, :],
        "b1": cat(cp[0]["b"], fin[0]["b"]),
        "wm": torch.stack([cat(cp[i]["w"], fin[i]["w"]) for i in range(1, len(cp) - 1)], dim=1),
        "bm": torch.stack([cat(cp[i]["b"], fin[i]["b"]) for i in range(1, len(cp) - 1)], dim=1),
        "wout": cat(cp[-1]["w"], fin[-1]["w"]),
        "bout": cat(cp[-1]["b"], fin[-1]["b"]),
    }


def pad_hidden(kargs: dict, h_proj: torch.Tensor) -> tuple[dict, torch.Tensor]:
    """Zero-pad the hidden width H to `padded_width(H)` (`pad_hidden`,
    `bcnf_tpu/ops/flow_kernel.py:326-342`). The same function exactly: padded
    units see zero weights, zero bias and a zero projection, gelu(0) = 0, and
    their zero rows of the next weight add nothing downstream."""
    H = kargs["b1"].shape[-1]
    p = padded_width(H) - H
    out = {k: v.contiguous() for k, v in kargs.items()}
    if p:
        out["w1y"] = F.pad(kargs["w1y"], (0, p))
        out["b1"] = F.pad(kargs["b1"], (0, p))
        out["wm"] = F.pad(kargs["wm"], (0, p, 0, p))
        out["bm"] = F.pad(kargs["bm"], (0, p))
        out["wout"] = F.pad(kargs["wout"], (0, 0, 0, p))
        h_proj = F.pad(h_proj, (0, p))
    return out, h_proj.contiguous()


def kernel_smem(route: str, Hp: int, size: int, d_a: int) -> int:
    """Bytes of shared memory a block of K1's kernel on `route` takes at this
    shape: the sums the kernels' launchers check (`csrc/flow_kernel.cu`:
    `launch_rows`; `csrc/flow_wgmma.cu`: `wg_smem`; `csrc/flow_fma.cu`:
    `fma_smem`, at its least; `csrc/flow_fwd_wgmma.cu`: `fw_smem`, at its
    least; `csrc/flow_wide_wgmma.cu`: `ww_smem`, both ways on kWwRows-row
    tiles: `wide_smem`), and of K2b's rows kernels
    (`ROUTE_TRAIN_BWD`; `csrc/flow_train_kernel.cu`: `launch_rows`; `ROUTE_TRAIN_BWD_WGMMA`:
    `csrc/flow_train_wgmma.cu`: `tw_smem`; `ROUTE_TRAIN_BWD_FMA`:
    `csrc/flow_train_fma.cu`: `ft_smem`, at its least)."""
    tn, n_out = Hp // 32, 2 * (size - d_a)
    if route in WIDE_ROUTES:
        return wide_smem(Hp, size, d_a, forward=route in WIDE_FWD_ROUTES,
                         mode=MODE_TF32 if route in WIDE_TF32_ROUTES else MODE_3XTF32)
    if route == ROUTE_TRAIN_BWD_FMA:  # the shortest ring
        return fma_train_smem(Hp, size, d_a, kernel_limit("kFmaRingMin"))
    if route in FWD_WGMMA_ROUTES:  # the shortest ring
        return fwd_wgmma_smem(Hp, size, d_a, kernel_limit("kFwRingMin"))
    if route == ROUTE_TRAIN_BWD_WGMMA:  # barriers, tile, ring, then x1, dx2, [t | s'], dout and x1_a in TF32,
        rows, stage = kernel_limit("kTwRows"), kernel_limit("kTwStageK") * Hp // 2  # the exchanged halves, dld
        state = rows * (2 * size + 2 * n_out + d_a + 2 * max(n_out, d_a) + 1)
        return 4 * (16 + rows * (Hp + 4) + kernel_limit("kTwRing") * stage + state)
    if route in (ROUTE_WGMMA, ROUTE_WGMMA_TF32):  # tile, the ring's stages (8 Hp floats a k-step: hi of every
        three = route == ROUTE_WGMMA  # column, or hi and lo of a block's half), x, x Q^T, [t | s'], 2 barriers a
        stages, stage = wgmma_ring(route)[0], 8 * Hp * (kernel_limit("kWgStageK") if three else 1)  # stage (+ the
        barriers = 2 * stages + (kernel_limit("kWgXchBarriers") if three else 0)  # 3xTF32 cluster's hand-offs)
        return 4 * (64 * (Hp + 4) + stages * stage + 64 * (2 * size + n_out)) + 8 * barriers
    if route in (ROUTE_ROWS, ROUTE_ROWS_TF32, ROUTE_TRAIN_BWD):  # tile, the 3-stage ring (csrc/flow_rows.cuh), then
        BM, BK = (32, 16) if tn <= 17 else (16, 8)
        stage = max(BK * (Hp + 8), Hp * (BK + 4))
        if route == ROUTE_TRAIN_BWD:  # ... K2b's rows' state, BM x (5 size + n_out + d_a + 1)
            return 4 * (BM * (Hp + 4) + 3 * stage + BM * (5 * size + n_out + d_a + 1))
        return 4 * (BM * (Hp + 4) + 3 * stage + BM * (2 * size + n_out + 1))  # ... x, x Q, [t | s'], logdet
    if route == ROUTE_FMA:  # the shortest ring
        return fma_smem(Hp, size, d_a, kernel_limit("kFmaRingMin"))
    raise ValueError(f"unknown route {route!r}")


def wide_card_layout(Hp: int, size: int, d_a: int, rows: int | None = None,
                     forward: bool = False, mode: str = MODE_3XTF32) -> tuple[int, int]:
    """The wide inverse, or the wide forward on tiles of `rows` rows (default
    kWwRows), of `mode` at this shape on the current card (`csrc/flow_wide_wgmma.cu`:
    `bcnf_flow_wide_layout`): its bytes of shared memory a block, and its
    clusters of Hp/128 blocks resident at once (the occupancy calculator's
    `cudaOccupancyMaxActiveClusters`)."""
    from bcnf_tpu_torch.ops._build import load_library

    lib = load_library(ROUTE_LIBRARY[ROUTE_WIDE_TF32 if mode == MODE_TF32 else ROUTE_WIDE])
    out = (ctypes.c_int * 2)()
    _raise_on(lib.bcnf_flow_wide_layout(Hp, size, d_a, rows or kernel_limit("kWwRows"), int(forward), out), lib,
              "wide_card_layout")
    return out[0], out[1]


def fma_lane_rows(Hp: int) -> int:
    """Rows a lane of the strict kernel holds at the padded width Hp
    (`csrc/flow_fma.cu`: `fma_lane_rows`): kFmaLaneRows, half that above
    kFmaWideTN; a round is 8 times that many rows."""
    return kernel_limit("kFmaLaneRows") // (1 if Hp // 32 <= kernel_limit("kFmaWideTN") else 2)


def fma_stage(Hp: int, size: int, d_a: int) -> int:
    """Floats a ring stage of the strict kernel holds (`fma_stage`): its
    weight rows (kFmaStageRows, half that above kFmaWideTN), and at least 4
    rows of Wout."""
    rows = kernel_limit("kFmaStageRows") // (1 if Hp // 32 <= kernel_limit("kFmaWideTN") else 2)
    return max(rows * Hp, 8 * (size - d_a))


def fma_smem(Hp: int, size: int, d_a: int, stages: int) -> int:
    """Bytes of shared memory a block of the strict kernel takes with a ring
    of `stages` stages (`fma_smem`): the ring's two barriers a stage, the
    transposed tile (Hp x (8 R + 4), R rows a lane), the ring, and the
    round's 8 R rows of [x | x Q | t s' | logdet]."""
    rows = 8 * fma_lane_rows(Hp)
    return 16 * stages + 4 * (Hp * (rows + 4) + stages * fma_stage(Hp, size, d_a) + rows * (4 * size - 2 * d_a + 1))


def fma_layout(B: int, Hp: int, size: int, d_a: int, sms: int) -> tuple[int, int, int, int, int]:
    """The strict kernel's launch at this shape on a card of `sms` SMs
    (`csrc/flow_fma.cu`: `fma_layout`): (rows a lane, blocks, ring stages,
    floats a stage, bytes of shared memory). The ring takes as many stages
    as fit, up to kFmaRingMax; one block an SM, at most one a row group (4
    times a lane's rows). None of it fits: ValueError."""
    lo, hi, limit = kernel_limit("kFmaRingMin"), kernel_limit("kFmaRingMax"), kernel_limit("kSmemLimit")
    stages = next((r for r in range(hi, lo - 1, -1) if fma_smem(Hp, size, d_a, r) <= limit), 0)
    if not stages:
        raise ValueError(f"the strict kernel takes no block at Hp {Hp}, size {size}, d_a {d_a}")
    rows = fma_lane_rows(Hp)
    return rows, min(-(-B // (4 * rows)), sms), stages, fma_stage(Hp, size, d_a), fma_smem(Hp, size, d_a, stages)


def fma_card_layout(B: int, Hp: int, size: int, d_a: int) -> tuple[int, int, int, int, int]:
    """`fma_layout` as the strict kernel's launcher computes it on the current
    card (`csrc/flow_fma.cu`: `bcnf_flow_fma_layout`)."""
    from bcnf_tpu_torch.ops._build import load_library

    lib = load_library(ROUTE_LIBRARY[ROUTE_FMA])
    out = (ctypes.c_int * 5)()
    _raise_on(lib.bcnf_flow_fma_layout(B, size, d_a, Hp, out), lib, "fma_card_layout")
    return tuple(out)


def fma_train_stage(Hp: int, size: int, d_a: int) -> int:
    """Floats a ring stage of the strict K2b's rows kernel holds
    (`csrc/flow_train_fma.cu`: `ft_stage`): the strict K1's stage, and at
    least 4 rows of W1y^T (d_a rounded up to even floats a row)."""
    return max(fma_stage(Hp, size, d_a), 4 * (d_a + d_a % 2))


def fma_train_smem(Hp: int, size: int, d_a: int, stages: int) -> int:
    """Bytes of shared memory a block of the strict K2b's rows kernel takes
    with a ring of `stages` stages (`ft_smem`): the ring's two barriers a
    stage, the transposed tile, the ring, and the round's 8 R rows of [x_k |
    x1 | dy | dx2 | [t | s'] | dz_b e^s | da_0 W1y^T | dld]."""
    rows = 8 * fma_lane_rows(Hp)
    state = 4 * size + 3 * (size - d_a) + d_a + d_a % 2 + 1
    return 16 * stages + 4 * (Hp * (rows + 4) + stages * fma_train_stage(Hp, size, d_a) + rows * state)


def fma_train_layout(B: int, Hp: int, size: int, d_a: int, sms: int) -> tuple[int, int, int, int, int]:
    """The strict K2b's rows kernel's launch at this shape on a card of `sms`
    SMs (`csrc/flow_train_fma.cu`: `ft_layout`), as `fma_layout` gives the
    strict K1's: (rows a lane, blocks, ring stages, floats a stage, bytes of
    shared memory). None of it fits: ValueError."""
    lo, hi, limit = kernel_limit("kFmaRingMin"), kernel_limit("kFmaRingMax"), kernel_limit("kSmemLimit")
    stages = next((r for r in range(hi, lo - 1, -1) if fma_train_smem(Hp, size, d_a, r) <= limit), 0)
    if not stages:
        raise ValueError(f"the strict K2b takes no block at Hp {Hp}, size {size}, d_a {d_a}")
    rows = fma_lane_rows(Hp)
    return (rows, min(-(-B // (4 * rows)), sms), stages, fma_train_stage(Hp, size, d_a),
            fma_train_smem(Hp, size, d_a, stages))


def fma_atb_jobs(size: int, d_a: int, nh: int, Hp: int) -> list[tuple[str, int, int, bool]]:
    """The strict K2b's weight-grad jobs of a step, in the order of its
    launch (`csrc/flow_train_fma.cu`: `atb_jobs`): (name, m, n, with the
    column sums as row m) of C = A^T B over the rows, A's column m all ones:
    dWm_l with dbm_l (h_l^T da_{l+1}) for each hidden layer, dWout with dbout,
    dW1y with db1, and the ActNorm rows' column sums alone (m 0)."""
    n_out = 2 * (size - d_a)
    return ([(f"dwm{l}", Hp, Hp, True) for l in range(nh)]
            + [("dwout", Hp, n_out, True), ("dw1y", d_a, Hp, True), ("actnorm", 0, 2 * size + 1, True)])


def fma_atb_tiles(size: int, d_a: int, nh: int, Hp: int) -> list[tuple[int, int, int, int, int]]:
    """The blocks of one step of the strict K2b's weight-grad pass, in
    launch order (`ft_atb_kernel`; the launch is S times these): (job, m0,
    n0, row halves, column halves) of each kFtTile x kFtTile output tile of
    the job's m rows (+1 for the sums' row) and n columns; a tile whose rows
    or columns end within its first half runs that half alone (1), else both
    (2)."""
    tile = kernel_limit("kFtTile")
    out = []
    for j, (_, m, n, sums) in enumerate(fma_atb_jobs(size, d_a, nh, Hp)):
        mt = m + int(sums)
        for m0 in range(0, mt, tile):
            for n0 in range(0, n, tile):
                out.append((j, m0, n0, 1 + (mt - m0 > tile // 2), 1 + (n - n0 > tile // 2)))
    return out


def fma_keep_rows(B: int, Hp: int) -> int:
    """Rows of each layer's h_l and gelu'(a_l) in the strict K2a's keep: B
    rounded up to the strict kernels' row group (4 rows a lane's worth;
    `csrc/flow_fma.cu`: `fma_keep_rows`), since gelu' is kept a row group at
    a time."""
    G = 4 * fma_lane_rows(Hp)
    return -(-B // G) * G


def fma_keep_grad_at(Hp: int) -> torch.Tensor:
    """Where gelu'(a) of a row group's G x Hp block lies in the strict K2a's
    keep (`csrc/flow_fma.cu`: `keep_grad_at`): entry col G + rr, the
    block's column col, row rr, in column-major order, holds its float
    offset within the block: column-major in units of R = G / 4 rows, each
    unit's index XOR-ed with (col / 4) % 8 (shifted up one at R = 2), so that
    the strict kernels' lanes, whose columns lie 4 apart, meet in no
    shared-memory bank."""
    R = fma_lane_rows(Hp)
    G = 4 * R
    col, rr = torch.arange(Hp).repeat_interleave(G), torch.arange(G).repeat(Hp)
    return R * ((4 * col + rr // R) ^ (((col >> 2) & 7) << (1 if R == 2 else 0))) + rr % R


def fma_keep_floats(B: int, S: int, size: int, d_a: int, nh: int, Hp: int) -> int:
    """Floats the strict K2a keeps for the strict K2b (`csrc/flow_fma.cu`:
    `fma_keep_floats`): h_l and gelu'(a_l) of every step and layer (2 (nh +
    1) S Bp Hp, Bp = `fma_keep_rows`), then s = tanh(s') of every step (S B
    d_b)."""
    return 2 * (nh + 1) * S * fma_keep_rows(B, Hp) * Hp + S * B * (size - d_a)


def fma_train_scratch_floats(B: int, S: int, size: int, d_a: int, nh: int, Hp: int) -> int:
    """Floats of the strict K2b's scratch (`csrc/flow_train_fma.cu`:
    `scratch_parts`), each part rounded up to 4: the transposed Wm, Wout and
    W1y (d_a rounded up to even), da_1 .. da_nh, dout, x1 and the ActNorm rows
    of every step, the ActNorm column sums."""
    n_out, n_an = 2 * (size - d_a), 2 * size + 1
    parts = (S * nh * Hp * Hp, S * n_out * Hp, S * Hp * (d_a + d_a % 2), S * B * nh * Hp, S * B * n_out,
             S * B * size, S * B * n_an, S * n_an)
    return sum(-(-p // 4) * 4 for p in parts)


# The strict K2b's row chunks. Where one chunk's keep and K2b scratch would
# pass STRICT_CHUNK_SHARE of the card's memory, the strict K2a keeps nothing
# in the forward and the backward runs K2a again on each chunk of rows into a
# chunk's keep, then K2b on that chunk, summing the weight and ActNorm grads
# over the chunks (as the JAX package's strict backward recomputes each
# block's MLP from the stored step inputs). A chunk is a multiple of
# STRICT_CHUNK_ROWS rows (the kernels' 32-row rounds and weight-grad stages);
# a tail of fewer rows joins the last chunk.
STRICT_CHUNK_SHARE = 0.125
STRICT_CHUNK_ROWS = 32


def strict_chunk_rows(S: int, size: int, d_a: int, nh: int, Hp: int, card_bytes: int) -> int:
    """Rows of the strict K2b's row chunk on a card of `card_bytes` of
    memory (its total, so that one card and one shape always chunk alike):
    the most rows, a multiple of STRICT_CHUNK_ROWS (at least one), whose keep
    (`fma_keep_floats`) and K2b scratch (`fma_train_scratch_floats`) take at
    most STRICT_CHUNK_SHARE of it. 13,088 rows at the flagship's shape on an
    H100 80GB (85,017,853,952 bytes)."""
    budget = STRICT_CHUNK_SHARE * card_bytes

    def fits(units: int) -> bool:
        rows = units * STRICT_CHUNK_ROWS
        return 4 * (fma_keep_floats(rows, S, size, d_a, nh, Hp) + fma_train_scratch_floats(rows, S, size, d_a, nh, Hp)
                    ) <= budget

    lo, hi = 1, int(budget // (4 * fma_keep_floats(STRICT_CHUNK_ROWS, S, size, d_a, nh, Hp))) + 1
    while lo < hi:  # the most units that fit (fits is monotone), at least 1
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    return lo * STRICT_CHUNK_ROWS


def row_chunks(B: int, rows: int) -> list[tuple[int, int]]:
    """[first, end) of each row chunk of B rows: `rows` rows each, a tail of
    fewer than STRICT_CHUNK_ROWS joining the last (B 100 in chunks of 32:
    32, 32 and 36)."""
    ends = list(range(rows, B, rows)) + [B]
    if len(ends) > 1 and ends[-1] - ends[-2] < STRICT_CHUNK_ROWS:
        del ends[-2]
    return list(zip([0] + ends[:-1], ends))


def _strict_route(x: torch.Tensor, h_proj: torch.Tensor, d_a: int, mode: str) -> bool:
    """Whether K2a and K2b run on x's rows by the strict float32 FMA route
    (a CUDA tensor in `MODE_FMA`), whose K2a keeps what its K2b reads."""
    return (x.device.type == "cuda" and mode == MODE_FMA
            and flow_route(h_proj.shape[-1], x.shape[-1], d_a, False, mode) == ROUTE_FMA)


def strict_chunks(x: torch.Tensor, h_proj: torch.Tensor, wm: torch.Tensor, d_a: int, mode: str,
                  chunk_rows: int | None = None) -> list[tuple[int, int]] | None:
    """The strict K2b's row chunks of x's B rows (`row_chunks`), or None
    where the training step takes the batch whole: outside the strict mode;
    with `chunk_rows` None, on a CPU tensor (whose plain versions keep
    nothing) or where the batch fits one chunk of `strict_chunk_rows` on the
    tensor's card. `chunk_rows` (a multiple of STRICT_CHUNK_ROWS) forces the
    chunk's size, in either place."""
    if mode != MODE_FMA:
        return None
    (B, size), (S, _, Hp), nh = x.shape, h_proj.shape, wm.shape[1]
    if chunk_rows is None:
        if not _strict_route(x, h_proj, d_a, mode):
            return None
        chunk_rows = strict_chunk_rows(S, size, d_a, nh, Hp, torch.cuda.get_device_properties(x.device).total_memory)
    elif chunk_rows <= 0 or chunk_rows % STRICT_CHUNK_ROWS:
        raise ValueError(f"chunk_rows must be a positive multiple of {STRICT_CHUNK_ROWS}, got {chunk_rows}")
    chunks = row_chunks(B, chunk_rows)
    return chunks if len(chunks) > 1 else None


def fma_train_card_layout(B: int, S: int, Hp: int, size: int, d_a: int, nh: int) -> tuple[int, ...]:
    """`fma_train_layout` as the strict K2b's launcher computes it on the
    current card, then the weight-grad pass's blocks, S times
    `len(fma_atb_tiles)` (`csrc/flow_train_fma.cu`: `bcnf_flow_train_fma_layout`)."""
    from bcnf_tpu_torch.ops._build import load_library

    lib = load_library(TRAIN_BWD_LIBRARY[ROUTE_FMA])
    out = (ctypes.c_int * 6)()
    _raise_on(lib.bcnf_flow_train_fma_layout(B, S, size, d_a, nh, Hp, out), lib, "fma_train_card_layout")
    return tuple(out)


def fma_groups(B: int, rows: int, blocks: int) -> list[tuple[int, int]]:
    """Each block's contiguous range [g0, g1) of the strict kernel's
    ceil(B / 4 rows) row groups (group g: rows 4 rows g .. 4 rows g + 4 rows
    - 1, `rows` a lane; `csrc/flow_fma.cu`: `block_groups`). A block walks
    its range in rounds of 2 groups, each group's rows on 4 warps."""
    groups = -(-B // (4 * rows))
    return [(b * groups // blocks, (b + 1) * groups // blocks) for b in range(blocks)]


def fwd_wgmma_smem(Hp: int, size: int, d_a: int, stages: int) -> int:
    """Bytes of shared memory a block of the one-pass `wgmma` forward takes
    with a ring of `stages` stages (`csrc/flow_fwd_wgmma.cu`: `fw_smem`):
    the ring's barriers, the 64-row tile, the stages (kFwStageK weight rows of
    the block's Hp/2 columns), and the rows' state: x and the mix's output,
    each rank's half of [t | s'], logdet."""
    rows, n_out = kernel_limit("kFwRows"), 2 * (size - d_a)
    return 4 * (kernel_limit("kFwBarrierFloats") + rows * (Hp + 4) + stages * kernel_limit("kFwStageK") * Hp // 2
                + rows * (2 * size + 2 * n_out + 1))


def fwd_wgmma_ring(Hp: int, size: int, d_a: int) -> int:
    """The ring's stages of the one-pass `wgmma` forward at this shape
    (`csrc/flow_fwd_wgmma.cu`: `fw_ring`): as many as fit in a block's shared
    memory, at most kFwRingMax, at least kFwRingMin and Wout's stages (a
    stage carries as many of Wout's Hp/2 rows of the block as its floats
    hold, a multiple of 4: `wout_rows`); 0 where the kernel refuses the
    shape (W1y's d_a rows past one stage of kFwStageK, Wout's rows past the
    ring, or no ring beside the tile)."""
    NB, stage_k = Hp // 2, kernel_limit("kFwStageK")
    rows = min((stage_k * NB // (2 * (size - d_a))) & ~3, NB)
    if d_a > stage_k or rows < 4:
        return 0
    least = max(kernel_limit("kFwRingMin"), -(-NB // rows))
    return next((r for r in range(kernel_limit("kFwRingMax"), least - 1, -1)
                 if fwd_wgmma_smem(Hp, size, d_a, r) <= kernel_limit("kSmemLimit")), 0)


def fwd_wgmma_card_layout(Hp: int, size: int, d_a: int, B: int, mode: str = MODE_TF32) -> tuple[int, int, int, int]:
    """The `wgmma` forward's launch in `mode` at this shape on the current
    card (`csrc/flow_fwd_wgmma.cu`: `bcnf_flow_fwd_wgmma_layout`): ring
    stages, bytes of shared memory, blocks, and clusters resident at once."""
    from bcnf_tpu_torch.ops._build import load_library

    lib = load_library(ROUTE_LIBRARY[ROUTE_FWD_WGMMA if mode == MODE_3XTF32 else ROUTE_FWD_WGMMA_TF32])
    out = (ctypes.c_int * 4)()
    _raise_on(lib.bcnf_flow_fwd_wgmma_layout(Hp, size, d_a, B, out), lib, "fwd_wgmma_card_layout")
    return tuple(out)


def _check_mode(mode: str, modes: tuple[str, ...] = KERNEL_MODES) -> None:
    if mode not in modes:
        raise ValueError(f"kernel mode {mode!r} is not one of {modes}")


def flow_route(Hp: int, size: int, d_a: int, inverse: bool, mode: str = MODE_3XTF32) -> str | None:
    """Which of K1's kernels runs this call (and, forward, which runs K2a's
    and K4's), by mode and shape: strict (`MODE_FMA`) takes the float32 FMA
    kernel; the default and the one-pass mode the `wgmma` inverse where it
    holds the width and the shape, the inverse at Hp 768 and 1024 the wide
    inverse (`csrc/flow_wide_wgmma.cu`, built for the mode, up to
    `WIDE_WGMMA_MAX_TN`) where it takes the shape (`wide_takes`), else the
    row tiles, each built for its mode; the forward of either mode the
    `wgmma` forward (`csrc/flow_fwd_wgmma.cu`, built for the mode) at the
    widths it holds
    (`FWD_WGMMA_MAX_TN`) where its ring takes the shape (`fwd_wgmma_ring`), at
    every batch (PERF.md: the card's row sweeps), the forward at Hp 768 and
    1024 the wide forward (the same source and build as the wide inverse, up
    to `WIDE_FWD_MAX_TN`) where it takes the shape, at every batch (its
    tile's rows by the batch: `wide_fwd_rows`), else the row tiles. None
    where no kernel takes the shape (its shared memory; then the model's gate
    stays closed, as JAX's `inverse_fused_flow` returns None)."""
    _check_mode(mode)
    if Hp % 32 or Hp // 32 not in KERNEL_TN or not 0 < d_a < size:
        return None
    one = mode == MODE_TF32
    wgmma, rows = (ROUTE_WGMMA_TF32, ROUTE_ROWS_TF32) if one else (ROUTE_WGMMA, ROUTE_ROWS)
    if mode == MODE_FMA:
        candidates = (ROUTE_FMA,)
    elif inverse and Hp // 32 <= WGMMA_MAX_TN:
        candidates = (wgmma, rows)
    elif inverse and Hp // 32 in WIDE_TN and Hp // 32 <= WIDE_WGMMA_MAX_TN:
        candidates = (ROUTE_WIDE_TF32 if one else ROUTE_WIDE, rows)
    elif not inverse and Hp // 32 <= FWD_WGMMA_MAX_TN:
        candidates = (ROUTE_FWD_WGMMA_TF32 if one else ROUTE_FWD_WGMMA, rows)
    elif not inverse and Hp // 32 in WIDE_TN and Hp // 32 <= WIDE_FWD_MAX_TN:
        candidates = (ROUTE_WIDE_FWD_TF32 if one else ROUTE_WIDE_FWD, rows)
    else:
        candidates = (rows,)
    limit = kernel_limit("kSmemLimit")
    return next((r for r in candidates if (fwd_wgmma_ring(Hp, size, d_a) > 0 if r in FWD_WGMMA_ROUTES
                                           else wide_takes(Hp, size, d_a, r in WIDE_FWD_ROUTES, mode)
                                           if r in WIDE_ROUTES else kernel_smem(r, Hp, size, d_a) <= limit)), None)


def train_bwd_route(Hp: int, size: int, d_a: int, nh: int, mode: str = MODE_3XTF32) -> str | None:
    """Which of K2b's kernels runs this call, by mode and shape: strict
    (`MODE_FMA`) the float32 FMA kernels (`csrc/flow_train_fma.cu`), with nh +
    3 weight-grad jobs a step within one launch's (`kFtMaxJobs`) and its rows
    kernel's shortest ring within a block's shared memory; the 3xTF32 and
    the one-pass mode the `wgmma` route (`csrc/flow_train_wgmma.cu`, built
    for the mode) at the widths it holds (`TRAIN_WGMMA_MAX_TN`) where its rows
    kernel takes the shape (its shared memory, and n_out and d_a within what
    its weight ring stages, reckoned in a stage's floats, kTwStageK x Hp/2 in
    either mode), at every batch (the card's sweeps found the row tiles
    faster at none of 32, 64, 128, 256 and 4096 rows: PERF.md); either mode
    at Hp 768 and 1024 the wide route (`csrc/flow_wide_train_wgmma.cu`,
    built for the mode, up to `WIDE_TRAIN_MAX_TN`) where its rows kernel's
    shared memory takes the shape (`wide_train_takes`), at every batch; else the row tiles of the
    mode (`csrc/flow_train_kernel.cu`). The row tiles take nh +
    3 weight-grad jobs a step within one launch's (`kAtbMaxJobs`) and their
    rows kernel's shared memory within a block's (`kSmemLimit`). None where
    no kernel takes the shape: the launchers return cudaErrorInvalidValue
    past these limits."""
    _check_mode(mode, TRAIN_MODES)
    if Hp % 32 or Hp // 32 not in KERNEL_TN or not 0 < d_a < size or nh < 1:
        return None
    limit, ring = kernel_limit("kSmemLimit"), kernel_limit("kTwStageK")
    if mode == MODE_FMA:
        return ROUTE_FMA if (nh + 3 <= kernel_limit("kFtMaxJobs")
                             and kernel_smem(ROUTE_TRAIN_BWD_FMA, Hp, size, d_a) <= limit) else None  # the wgmma route's narrow weights pass
    if (Hp // 32 <= TRAIN_WGMMA_MAX_TN  # through its ring (csrc: tw_takes)
            and 2 * (size - d_a) <= kernel_limit("kTwRing") * ring and d_a <= ring
            and kernel_smem(ROUTE_TRAIN_BWD_WGMMA, Hp, size, d_a) <= limit):
        return ROUTE_WGMMA_TF32 if mode == MODE_TF32 else ROUTE_WGMMA
    if Hp // 32 <= WIDE_TRAIN_MAX_TN and wide_train_takes(Hp, size, d_a, mode):
        return ROUTE_WIDE_TRAIN_TF32 if mode == MODE_TF32 else ROUTE_WIDE_TRAIN
    if nh + 3 <= kernel_limit("kAtbMaxJobs") and kernel_smem(ROUTE_TRAIN_BWD, Hp, size, d_a) <= limit:
        return ROUTE_ROWS_TF32 if mode == MODE_TF32 else ROUTE_ROWS
    return None


def train_kernels_take(Hp: int, size: int, d_a: int, nh: int, mode: str = MODE_3XTF32) -> bool:
    """Whether K2a and K2b take this shape in `mode`: a K2a route (the
    forward's, `flow_route`) and a K2b route (`train_bwd_route`), each read
    from its kernels' limits in their sources; nh >= 1."""
    if nh < 1 or flow_route(Hp, size, d_a, False, mode) is None:
        return False
    return train_bwd_route(Hp, size, d_a, nh, mode) is not None


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32, rounded to nearest with ties away from zero (the bits
    of `cvt.rna.tf32.f32`, csrc/mma_tf32.cuh: `tf32_rna`), kept in float32."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def prepare_weights(wm: torch.Tensor, passes: int = 3, stage_k: int | None = None) -> torch.Tensor:
    """The stacked, padded hidden weights `wm` (S, nh, Hp, Hp), stored (in,
    out), as the `wgmma` inverse reads them (`csrc/flow_wgmma.cu`), on `wm`'s
    device: transposed to K-major (out, in), split into ``hi = tf32(w)``
    (rounded) and ``lo = w - hi`` (exact; the tensor cores read its top 19
    bits), and laid out stage by stage, 8 input rows a stage, in the order of
    `wgmma`'s core matrices (8 outputs x 4 inputs, 128 contiguous bytes; the
    two along the inputs side by side). In 3xTF32 a stage holds `stage_k`
    k-steps (default: the kernel's `kWgStageK`), split by output column
    between the two blocks of a cluster (rank r owns columns r Hp/2 ..),
    each rank's part holding its k-steps' hi then lo, so that one bulk copy
    moves a block's part of a stage: shape (S, nh, Hp/8/stage_k stages, 2
    ranks, stage_k k-steps, 2 [hi, lo], Hp/16 output groups, 2 input halves,
    8 outputs, 4 inputs). With `passes=1` (the one-pass kernel) a stage holds
    one k-step, hi alone, of every column: (S, nh, Hp/8, 1, Hp/8, 2, 8, 4),
    half the bytes."""
    if passes not in (1, 3):
        raise ValueError(f"prepare_weights: a product takes 1 or 3 passes, not {passes}")
    S, nh, Hp, _ = wm.shape
    g = Hp // 8
    # w^T[n, k] with n = 8 ng + r and k = 8 s + 4 kg + c, to (s, ng, kg, r, c)
    wt = wm.transpose(-1, -2).reshape(S, nh, g, 8, g, 2, 4).permute(0, 1, 4, 2, 5, 3, 6).contiguous()
    hi = _round_tf32(wt)
    if passes == 1:
        return hi.unsqueeze(3)
    k = kernel_limit("kWgStageK") if stage_k is None else stage_k
    # s = k j + u and ng = (Hp/16) rank + ng', to (j, rank, u, ng', kg, r, c)
    wt, hi = (t.reshape(S, nh, g // k, k, 2, g // 2, 2, 8, 4).transpose(3, 4) for t in (wt, hi))
    return torch.stack([hi, wt - hi], dim=5).contiguous()


def prepare_wide_weights(wm: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """The stacked, padded hidden weights `wm` (S, nh, Hp, Hp), stored (in,
    out), as the wide inverse reads them (`csrc/flow_wide_wgmma.cu`), on
    `wm`'s device, for a product of `passes` passes: in 3xTF32 float32 as
    they are (the kernel splits them into hi and lo in shared memory); in one
    pass (`passes=1`) each entry rounded to TF32 (`tf32_rna`), which the
    one-pass build reads as it lands. Transposed to K-major, in `wgmma`'s core-matrix
    order (8 outputs x 4 inputs, 128 contiguous bytes; the two along the
    inputs side by side), stage by stage, each stage kWwStageK k-steps (8
    input rows each) split by output column between the Hp/kWwCols blocks
    of a cluster (block c owns columns kWwCols c ..), so that one bulk copy
    moves a block's part of a stage: shape (S, nh, Hp/8/kWwStageK stages,
    Hp/kWwCols blocks, kWwStageK k-steps, kWwCols/8 output groups, 2 input
    halves, 8 outputs, 4 inputs); entry [s, l, j, c, u, ng, kg, r, i] is
    wm[s, l, 8 (kWwStageK j + u) + 4 kg + i, kWwCols c + 8 ng + r]. The same
    bytes as `wm`. The one-pass layout carries an axis of 1 after the k-steps
    (hi alone, as `prepare_weights(passes=1)` marks its own), so that no
    layout of one mode passes the other's shape check: (S, nh, stages,
    blocks, kWwStageK, 1, kWwCols/8, 2, 8, 4), the same bytes."""
    if passes not in (1, 3):
        raise ValueError(f"prepare_wide_weights: a product takes 1 or 3 passes, not {passes}")
    S, nh, Hp, _ = wm.shape
    k, cols = kernel_limit("kWwStageK"), kernel_limit("kWwCols")
    if Hp % (8 * k) or Hp % cols:
        raise ValueError(f"prepare_wide_weights: the padded width {Hp} is not one the wide inverse takes")
    out = (wm.reshape(S, nh, Hp // 8 // k, k, 2, 4, Hp // cols, cols // 8, 8)
           .permute(0, 1, 2, 6, 3, 7, 4, 8, 5).contiguous())
    return out if passes == 3 else _round_tf32(out).unsqueeze(5)


def prepare_wide_train_weights(wm: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """A training step's hidden weights at Hp 768 and 1024 for a product of
    `passes` passes, laid out once for the wide forward (K2a) and the wide
    backward (K2b): `prepare_wide_weights(., passes)` of Wm (the products h
    Wm: the forward's and K2b's recompute), then of Wm^T (K2b's da Wm^T),
    stacked, shape (2, S, nh, ...); K2a reads the first. Twice Wm's bytes,
    on `wm`'s device."""
    out = torch.empty((2, *_wide_weights_shape(*wm.shape[:3], passes)), dtype=wm.dtype, device=wm.device)
    out[0] = prepare_wide_weights(wm, passes)
    out[1] = prepare_wide_weights(wm.transpose(-1, -2), passes)
    return out


def _wide_weights_shape(S: int, nh: int, Hp: int, passes: int = 3) -> tuple[int, ...]:
    """The shape of `prepare_wide_weights`' layout for `passes`."""
    k, cols = kernel_limit("kWwStageK"), kernel_limit("kWwCols")
    return (S, nh, Hp // 8 // k, Hp // cols, k, *((1,) if passes == 1 else ()), cols // 8, 2, 8, 4)


def _weights_shape(S: int, nh: int, Hp: int, passes: int) -> tuple[int, ...]:
    """The shape of `prepare_weights`'s layout."""
    if passes == 1:
        return (S, nh, Hp // 8, 1, Hp // 8, 2, 8, 4)
    k = kernel_limit("kWgStageK")
    return (S, nh, Hp // 8 // k, 2, k, 2, Hp // 16, 2, 8, 4)


def _train_weights_shape(S: int, nh: int, Hp: int, passes: int) -> tuple[int, ...]:
    """The shape of `prepare_train_weights`'s layout."""
    parts = (2,) if passes == 3 else ()  # hi, lo
    return (S, nh, 2, 2, Hp // 8, *parts, Hp // 16, 2, 8, 4)


def _checked_wstages(wstages: torch.Tensor, shape: tuple[int, ...], wm: torch.Tensor, what: str,
                     exact: bool = False) -> torch.Tensor:
    """`wstages` if it holds as many floats as the layout a route reads
    (`shape`; a layout of the other mode holds half or twice as many), for
    `wm`'s layers, contiguous float32 on `wm`'s device; else raises: the
    route's bulk copies read that many bytes from it, whatever it holds. (It
    is checked by its size: a tool's variant build of the inverse may stage
    another number of k-steps.) `exact` checks the whole shape: the wide
    layouts of the two modes hold the same bytes, and only their shapes tell
    them apart."""
    if ((tuple(wstages.shape) != shape if exact else tuple(wstages.shape[:2]) != shape[:2])
            or wstages.numel() != math.prod(shape)
            or wstages.dtype != torch.float32 or wstages.device != wm.device or not wstages.is_contiguous()):
        raise ValueError(f"{what}: wstages must be the hidden weights laid out for its route, contiguous float32 of "
                         f"shape {shape} on {wm.device}; got {tuple(wstages.shape)} {wstages.dtype} on "
                         f"{wstages.device}")
    return wstages


def prepare_train_weights(wm: torch.Tensor, passes: int = 1) -> torch.Tensor:
    """`prepare_train_weights_reference`'s layout of `wm` for a product of
    `passes` passes (1, or 3 for 3xTF32) on its device: on a CUDA tensor one
    launch of `csrc/flow_train_wgmma.cu`'s `prepare_kernel` from the library
    built for that mode (counted in `launches`, and by passes in
    `pass_launches`), or raises; on a CPU tensor, or a stack of no layer
    (nothing to lay out), the plain version. K2b's and the forward's `wgmma`
    routes of the mode read it: the forward direction 0, K2b both."""
    if passes not in (1, 3):
        raise ValueError(f"prepare_train_weights: a product takes 1 or 3 passes, not {passes}")
    S, nh, Hp, _ = wm.shape
    if Hp % 32:
        raise ValueError(f"prepare_train_weights: the padded width {Hp} is not a multiple of 32")
    if wm.device.type == "cpu" or wm.numel() == 0:
        return prepare_train_weights_reference(wm, passes)
    if wm.device.type != "cuda" or wm.dtype != torch.float32:
        raise ValueError(f"prepare_train_weights takes float32 CPU or CUDA tensors, not {wm.dtype} on {wm.device}")
    from bcnf_tpu_torch.ops._build import load_library

    lib = load_library(TRAIN_BWD_LIBRARY[ROUTE_WGMMA if passes == 3 else ROUTE_WGMMA_TF32])
    w = wm.contiguous()
    out = torch.empty(_train_weights_shape(S, nh, Hp, passes), dtype=wm.dtype, device=wm.device)
    with torch.cuda.device(wm.device):
        err = lib.bcnf_prepare_train_weights(*_ptrs(w, out), S * nh, Hp, _stream())
    _raise_on(err, lib, "prepare_train_weights")
    prepare_train_weights.launches += 1
    prepare_train_weights.pass_launches[passes] += 1
    return out


prepare_train_weights.launches = 0  # type: ignore[attr-defined]
prepare_train_weights.pass_launches = collections.Counter()  # type: ignore[attr-defined]


def prepare_train_weights_reference(wm: torch.Tensor, passes: int = 1) -> torch.Tensor:
    """The stacked, padded hidden weights `wm` (S, nh, Hp, Hp), stored (in,
    out), as K2b's and the forward's `wgmma` routes read them
    (`csrc/flow_train_wgmma.cu`, `csrc/flow_fwd_wgmma.cu`), on `wm`'s device:
    rounded to TF32 (`tf32_rna`) and laid out for each product's B operand,
    K-major: the recompute's (and the forward's) ``h Wm`` reads Wm^T
    (direction 0), the backward's ``da Wm^T`` reads Wm as stored (direction
    1). Each is split by output column between the two blocks of a cluster
    (rank r owns columns r Hp/2 ..), and each rank's part is laid out k-group
    by k-group (8 input rows), in `wgmma`'s core-matrix order (8 outputs x 4
    inputs, 128 contiguous bytes; the two along the inputs side by side), so
    that one bulk copy moves a ring stage of 16 rows. Shape (S, nh, 2
    directions, 2 ranks, Hp/8 k-groups, Hp/16 output groups, 2 input halves,
    8 outputs, 4 inputs). With `passes=3` (3xTF32) each k-group holds hi =
    tf32(w) and then lo = w - hi (exact; the tensor cores read its top 19
    bits) in the same order: (S, nh, 2, 2, Hp/8, 2 [hi, lo], Hp/16, 2, 8, 4),
    so that a ring stage of the same bytes is one k-group's hi and lo."""
    if passes not in (1, 3):
        raise ValueError(f"prepare_train_weights_reference: a product takes 1 or 3 passes, not {passes}")
    S, nh, Hp, _ = wm.shape
    w = wm.contiguous()
    hi = _round_tf32(w)  # elementwise, so before the layout: one pass over Wm
    out = torch.empty(_train_weights_shape(S, nh, Hp, passes), dtype=wm.dtype, device=wm.device)
    # B(k, n) at [n // (Hp/2)][k // 8][(n % (Hp/2)) // 8][(k % 8) // 4][n % 8][k % 4], from T[n, k] = B(k, n)
    for part, v in enumerate((hi,) if passes == 1 else (hi, w - hi)):
        dst = out if passes == 1 else out[:, :, :, :, :, part]
        for d, t in enumerate((v.transpose(-1, -2), v)):  # T: Wm^T (the recompute's h Wm), Wm (the backward's da Wm^T)
            dst[:, :, d] = t.reshape(S, nh, 2, Hp // 16, 8, Hp // 8, 2, 4).permute(0, 1, 2, 5, 3, 6, 4, 7)
    return out


def route_weights(route: str, wm: torch.Tensor, wstages: torch.Tensor | None = None) -> torch.Tensor:
    """The hidden weights `wm` laid out as K1's `wgmma` route `route` reads
    them: `prepare_weights` for the inverses, `prepare_train_weights` for the
    forwards, each for the route's mode, `prepare_wide_weights` for the wide
    inverse and the wide forward of the route's mode (one layout serves both
    directions); or `wstages`, a caller's layout, checked against the
    route's (the wide layouts by their whole shape, which tells the modes
    apart)."""
    if route in WIDE_ROUTES:
        passes = 1 if route in WIDE_TF32_ROUTES else 3
        if wstages is None:
            return prepare_wide_weights(wm, passes)
        return _checked_wstages(wstages, _wide_weights_shape(*wm.shape[:3], passes), wm, f"the {route} route",
                                exact=True)
    if route in (ROUTE_WGMMA, ROUTE_WGMMA_TF32):
        passes, prepare, shape = 1 if route == ROUTE_WGMMA_TF32 else 3, prepare_weights, _weights_shape
    elif route in FWD_WGMMA_ROUTES:
        passes, prepare, shape = 1 if route == ROUTE_FWD_WGMMA_TF32 else 3, prepare_train_weights, _train_weights_shape
    else:
        raise ValueError(f"{route!r} is not a wgmma route")
    if wstages is None:
        return prepare(wm, passes)
    return _checked_wstages(wstages, shape(*wm.shape[:3], passes), wm, f"the {route} route")


def fused_flow_reference(
    x: torch.Tensor,
    h_proj: torch.Tensor,
    an_scale: torch.Tensor,
    an_bias: torch.Tensor,
    ortho: torch.Tensor,
    w1y: torch.Tensor,
    b1: torch.Tensor,
    wm: torch.Tensor,
    bm: torch.Tensor,
    wout: torch.Tensor,
    bout: torch.Tensor,
    *,
    inverse: bool,
    n_cond: int,
    mm: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = torch.matmul,
) -> tuple[torch.Tensor, torch.Tensor] | torch.Tensor:
    """Plain PyTorch version of K1: the same steps, one op at a time.
    Forward returns `(z, logdet)`, inverse returns `y`. `mm` takes every
    product of the coupling MLP (`tf32.matmul_3xtf32`, the arithmetic of the
    default mode's hidden products; `tf32.matmul_tf32`, the one-pass mode's);
    the mixes stay float32, as the JAX kernel pins them to HIGHEST."""
    B, size = x.shape
    n_steps = h_proj.shape[0]
    d_a = w1y.shape[1]
    rows = torch.arange(B, device=x.device) % n_cond

    def coeffs(k: int, x_a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        a = gelu(mm(x_a, w1y[k]) + b1[k] + h_proj[k].index_select(0, rows))
        for i in range(wm.shape[1]):
            a = gelu(mm(a, wm[k, i]) + bm[k, i])
        out = mm(a, wout[k]) + bout[k]
        return out[:, : size - d_a], torch.tanh(out[:, size - d_a:])

    if not inverse:
        ld = x.new_zeros((B,))
        for k in range(n_steps):
            inner = k < n_steps - 1
            if inner:
                x = x * an_scale[k] + an_bias[k]
                ld = ld + torch.sum(torch.log(torch.abs(an_scale[k])))
            t, s = coeffs(k, x[:, :d_a])
            x = torch.cat([x[:, :d_a], torch.exp(s) * x[:, d_a:] + t], dim=-1)
            ld = ld + torch.sum(s, dim=-1)
            if inner:
                x = x @ ortho[k]
        return x, ld

    for k in range(n_steps - 1, -1, -1):
        inner = k < n_steps - 1
        if inner:
            x = x @ ortho[k].T
        t, s = coeffs(k, x[:, :d_a])
        x = torch.cat([x[:, :d_a], (x[:, d_a:] - t) * torch.exp(-s)], dim=-1)
        if inner:
            x = (x - an_bias[k]) / an_scale[k]
    return x


def _check_args(x: torch.Tensor, args: dict[str, torch.Tensor], n_cond: int) -> None:
    for name, t in {"x": x, **args}.items():
        if t.dtype != torch.float32:
            raise TypeError(f"fused_flow: {name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"fused_flow: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_flow: {name} must be contiguous")
    if x.dim() != 2:
        raise ValueError(f"fused_flow: x must be (rows, size), got {tuple(x.shape)}")
    B, size = x.shape
    S, N, Hp = args["h_proj"].shape
    nh, d_a = args["wm"].shape[1], args["w1y"].shape[1]
    expected = {
        "h_proj": (S, n_cond, Hp),
        "an_scale": (S, size),
        "an_bias": (S, size),
        "ortho": (S, size, size),
        "w1y": (S, d_a, Hp),
        "b1": (S, Hp),
        "wm": (S, nh, Hp, Hp),
        "bm": (S, nh, Hp),
        "wout": (S, Hp, 2 * (size - d_a)),
        "bout": (S, 2 * (size - d_a)),
    }
    for name, shape in expected.items():
        if tuple(args[name].shape) != shape:
            raise ValueError(f"fused_flow: {name} has shape {tuple(args[name].shape)}, expected {shape}")
    if Hp % 32 or Hp // 32 not in KERNEL_TN:
        raise ValueError(f"fused_flow: hidden width {Hp} is not one the kernel is built for; pad with pad_hidden")
    if not 0 < d_a < size or n_cond < 1:
        raise ValueError(f"fused_flow: bad split d_a={d_a} of size={size} or n_cond={n_cond}")
    if B * size >= 2**31:
        raise ValueError(f"fused_flow: {B} rows exceed the kernel's 32-bit row indexing")


def _ptrs(*tensors: torch.Tensor) -> list[ctypes.c_void_p]:
    return [ctypes.c_void_p(t.data_ptr()) for t in tensors]


def _raise_on(err: int, lib: Any, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: {lib.bcnf_cuda_error_string(err).decode()}")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


# the `wgmma` inverses' parts (csrc/flow_wgmma.cu, csrc/flow_wide_wgmma.cu):
# their products, the weights' stream, the exchange between the blocks of a
# 3xTF32 cluster (the wide inverse: the A fragments read from the owners'
# tiles), and the wide inverse's split of each weight stage into hi and lo
WG_PRODUCTS, WG_COPIES, WG_EXCHANGE, WIDE_SPLIT = 1, 2, 4, 8
WG_ALL = WG_PRODUCTS | WG_COPIES | WG_EXCHANGE | WIDE_SPLIT


def _launch_flow(x: torch.Tensor, args: dict[str, torch.Tensor], *, inverse: bool, n_cond: int, mode: str,
                 wstages: torch.Tensor | None = None, parts: int = WG_ALL,
                 ) -> tuple[str, torch.Tensor, torch.Tensor | None]:
    """Launch K1 on checked CUDA tensors, uncounted, on the route
    `flow_route` gives for `mode`; returns `(route, y, logdet or None)`. The
    `wgmma` inverses read the hidden weights as `prepare_weights` gives them
    for the mode, the `wgmma` forward as `prepare_train_weights` does: pass
    them as `wstages`, or they are prepared here. `parts`
    other than all three runs the `wgmma` inverse with a part left out, to
    time the rest (chip_smoke.py): its products alone, on stale weight
    stages (`WG_PRODUCTS`), the weights' stream without the products
    (`WG_COPIES`), or each 3xTF32 block on its own half without the exchange
    (no `WG_EXCHANGE`); the wide inverse and forward also without their
    split of the weight stages (no `WIDE_SPLIT`); y is then not the flow.
    The wide inverse and forward read them as `prepare_wide_weights` lays
    them out for the mode, the forward on tiles of `wide_fwd_rows(B)` rows."""
    from bcnf_tpu_torch.ops._build import load_library

    B, size = x.shape
    S, _, Hp = args["h_proj"].shape
    d_a, nh = args["w1y"].shape[1], args["wm"].shape[1]
    route = flow_route(Hp, size, d_a, inverse, mode)
    if route is None:
        raise ValueError(f"fused_flow: no kernel takes size {size}, d_a {d_a} at hidden width {Hp} "
                         f"({mode}, {'inverse' if inverse else 'forward'})")
    y = torch.empty_like(x)
    ld = None if inverse else torch.empty((B,), dtype=x.dtype, device=x.device)
    if B == 0:
        return route, y, ld
    tensors = [args[n] for n in ("h_proj", "an_scale", "an_bias", "ortho", "w1y", "b1", "wm", "bm", "wout", "bout")]
    lib = load_library(ROUTE_LIBRARY[route])
    with torch.cuda.device(x.device):
        if route in (ROUTE_WIDE, ROUTE_WIDE_TF32):
            tensors[6] = route_weights(route, args["wm"], wstages)
            err = lib.bcnf_flow_inverse_wide(*_ptrs(x, *tensors, y), B, n_cond, S, size, d_a, nh, Hp, parts, _stream())
        elif route in WIDE_FWD_ROUTES:  # no step-input store (that is K2a's)
            tensors[6] = route_weights(route, args["wm"], wstages)
            err = lib.bcnf_flow_forward_wide(*_ptrs(x, *tensors, y, ld), ctypes.c_void_p(0), B, n_cond, S, size, d_a,
                                             nh, Hp, wide_fwd_rows(B), parts, _stream())
        elif route in (ROUTE_WGMMA, ROUTE_WGMMA_TF32):
            tensors[6] = route_weights(route, args["wm"], wstages)
            err = lib.bcnf_flow_inverse_wgmma(*_ptrs(x, *tensors, y), B, n_cond, S, size, d_a, nh, Hp, parts, _stream())
        elif route in FWD_WGMMA_ROUTES:  # no step-input store (that is K2a's)
            tensors[6] = route_weights(route, args["wm"], wstages)
            err = lib.bcnf_flow_fwd_wgmma(*_ptrs(x, *tensors, y, ld), ctypes.c_void_p(0),
                                          B, n_cond, S, size, d_a, nh, Hp, _stream())
        else:
            ld_ptr = ctypes.c_void_p(0 if ld is None else ld.data_ptr())
            if route != ROUTE_FMA:  # no step-input store (that is K2a's)
                err = lib.bcnf_flow_rows(*_ptrs(x, *tensors, y), ld_ptr, ctypes.c_void_p(0),
                                         B, n_cond, S, size, d_a, nh, Hp, int(inverse), _stream())
            else:
                err = lib.bcnf_fused_flow(*_ptrs(x, *tensors, y), ld_ptr,
                                          B, n_cond, S, size, d_a, nh, Hp, int(inverse), _stream())
    _raise_on(err, lib, f"fused_flow ({route})")
    return route, y, ld


def fused_flow(
    x: torch.Tensor,
    h_proj: torch.Tensor,
    an_scale: torch.Tensor,
    an_bias: torch.Tensor,
    ortho: torch.Tensor,
    w1y: torch.Tensor,
    b1: torch.Tensor,
    wm: torch.Tensor,
    bm: torch.Tensor,
    wout: torch.Tensor,
    bout: torch.Tensor,
    *,
    inverse: bool,
    n_cond: int,
    mode: str = MODE_3XTF32,
) -> tuple[torch.Tensor, torch.Tensor] | torch.Tensor:
    """Run the whole flow in one kernel launch. Forward returns `(z, logdet)`,
    inverse returns `y`. A CPU tensor takes `fused_flow_reference` (float32
    in every mode); a CUDA tensor launches the kernel of `flow_route` for
    `mode` (3xTF32, one TF32 pass, or float32 FMA), or raises. Counts its
    launches in `launches`, and by route in `route_launches`."""
    _check_mode(mode)
    args = dict(h_proj=h_proj, an_scale=an_scale, an_bias=an_bias, ortho=ortho,
                w1y=w1y, b1=b1, wm=wm, bm=bm, wout=wout, bout=bout)
    if x.device.type == "cpu":
        return fused_flow_reference(x, **args, inverse=inverse, n_cond=n_cond)
    if x.device.type != "cuda":
        raise ValueError(f"fused_flow runs on CPU or CUDA tensors, not {x.device}")
    _check_args(x, args, n_cond)
    route, y, ld = _launch_flow(x, args, inverse=inverse, n_cond=n_cond, mode=mode)
    if x.shape[0]:
        fused_flow.launches += 1
        fused_flow.route_launches[route] += 1
    return y if inverse else (y, ld)


fused_flow.launches = 0  # type: ignore[attr-defined]
fused_flow.route_launches = collections.Counter()  # type: ignore[attr-defined]


# ---------------------------------------------------------------------------
# Training: K2a (forward that keeps each step's input rows) and K2b (backward)
# ---------------------------------------------------------------------------
#
# The JAX package's training kernels (`bcnf_tpu/ops/flow_kernel.py:345-706`)
# store only the (S, B, size) step inputs in the forward; the backward
# recomputes each step's MLP from them. Training rows carry their own
# conditions: h_proj is (S, B, Hp), row r uses h_proj[k, r].


def _train_step_mlp(k: int, x_a: torch.Tensor, h_proj: torch.Tensor, w1y: torch.Tensor, b1: torch.Tensor,
                    wm: torch.Tensor, bm: torch.Tensor, mm: Callable = torch.matmul,
                    ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Step k's MLP up to its last hidden layer: pre-activations and activations."""
    acts = [mm(x_a, w1y[k]) + b1[k] + h_proj[k]]
    hs = [gelu(acts[0])]
    for i in range(wm.shape[1]):
        acts.append(mm(hs[-1], wm[k, i]) + bm[k, i])
        hs.append(gelu(acts[-1]))
    return acts, hs


def fused_flow_train_reference(
    x: torch.Tensor,
    h_proj: torch.Tensor,
    an_scale: torch.Tensor,
    an_bias: torch.Tensor,
    ortho: torch.Tensor,
    w1y: torch.Tensor,
    b1: torch.Tensor,
    wm: torch.Tensor,
    bm: torch.Tensor,
    wout: torch.Tensor,
    bout: torch.Tensor,
    *,
    mm: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = torch.matmul,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2a (`_flow_fwd_train_kernel`,
    `bcnf_tpu/ops/flow_kernel.py:382-431`): returns `(z, logdet, bound)`,
    `bound[k]` being the rows' input to step k. Differentiable by autograd.
    `mm` takes every product of the coupling MLP (`tf32.matmul_3xtf32`, the
    default mode's tensor-core arithmetic; `tf32.matmul_tf32`, the one-pass
    mode's); the mixes stay float32, as JAX pins them to HIGHEST."""
    B, size = x.shape
    S = h_proj.shape[0]
    d_a = w1y.shape[1]
    ld = x.new_zeros((B,))
    bound = []
    for k in range(S):
        inner = k < S - 1
        bound.append(x)
        if inner:
            x = x * an_scale[k] + an_bias[k]
            ld = ld + torch.sum(torch.log(torch.abs(an_scale[k])))
        _, hs = _train_step_mlp(k, x[:, :d_a], h_proj, w1y, b1, wm, bm, mm)
        out = mm(hs[-1], wout[k]) + bout[k]
        t, s = out[:, : size - d_a], torch.tanh(out[:, size - d_a:])
        x = torch.cat([x[:, :d_a], torch.exp(s) * x[:, d_a:] + t], dim=-1)
        ld = ld + torch.sum(s, dim=-1)
        if inner:
            x = x @ ortho[k]
    return x, ld, torch.stack(bound)


def fused_flow_train_backward_reference(
    bound: torch.Tensor,
    h_proj: torch.Tensor,
    dz: torch.Tensor,
    dld: torch.Tensor,
    an_scale: torch.Tensor,
    an_bias: torch.Tensor,
    ortho: torch.Tensor,
    w1y: torch.Tensor,
    b1: torch.Tensor,
    wm: torch.Tensor,
    bm: torch.Tensor,
    wout: torch.Tensor,
    bout: torch.Tensor,
    *,
    mm: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = torch.matmul,
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K2b, output by output as
    `_flow_bwd_train_kernel` (`bcnf_tpu/ops/flow_kernel.py:434-538`): from the
    step inputs `bound` and the cotangents `dz`, `dld`, returns
    `(dx, dh_proj, dan_scale, dan_bias, dw1y, db1, dwm, dbm, dwout, dbout)`.
    The final step's ActNorm grads are zero; the mixes get none. `mm` takes
    every product of the coupling MLP and its weight grads
    (`tf32.matmul_3xtf32`, the default mode's tensor-core arithmetic;
    `tf32.matmul_tf32`, the one-pass mode's); the mixes stay float32 and the
    bias and ActNorm grads are float32 sums, as in the JAX kernel."""
    S, B, size = bound.shape
    d_a = w1y.shape[1]
    d_b = size - d_a
    dhp, dan_s, dan_b = torch.zeros_like(h_proj), torch.zeros_like(an_scale), torch.zeros_like(an_bias)
    dw1y, db1, dwm, dbm = torch.zeros_like(w1y), torch.zeros_like(b1), torch.zeros_like(wm), torch.zeros_like(bm)
    dwout, dbout = torch.zeros_like(wout), torch.zeros_like(bout)
    dld_total = torch.sum(dld)
    dx = dz
    for k in range(S - 1, -1, -1):
        inner = k < S - 1
        x_k = bound[k]
        x1 = x_k * an_scale[k] + an_bias[k] if inner else x_k
        x_a, x1_b = x1[:, :d_a], x1[:, d_a:]
        acts, hs = _train_step_mlp(k, x_a, h_proj, w1y, b1, wm, bm, mm)
        out = mm(hs[-1], wout[k]) + bout[k]
        s = torch.tanh(out[:, d_b:])
        es = torch.exp(s)

        dx2 = dx @ ortho[k].T if inner else dx
        dz_b = dx2[:, d_a:]
        ds = dz_b * es * x1_b + dld[:, None]
        dout = torch.cat([dz_b, ds * (1.0 - s * s)], dim=-1)
        dwout[k] = mm(hs[-1].T, dout)
        dbout[k] = torch.sum(dout, dim=0)
        dh = mm(dout, wout[k].T)
        for i in range(wm.shape[1] - 1, -1, -1):
            da = gelu_grad(acts[i + 1]) * dh
            dwm[k, i] = mm(hs[i].T, da)
            dbm[k, i] = torch.sum(da, dim=0)
            dh = mm(da, wm[k, i].T)
        da0 = gelu_grad(acts[0]) * dh
        dw1y[k] = mm(x_a.T, da0)
        db1[k] = torch.sum(da0, dim=0)
        dhp[k] = da0
        dx1 = torch.cat([dx2[:, :d_a] + mm(da0, w1y[k].T), dz_b * es], dim=-1)
        if inner:
            dan_s[k] = torch.sum(dx1 * x_k, dim=0) + dld_total / an_scale[k]
            dan_b[k] = torch.sum(dx1, dim=0)
            dx = dx1 * an_scale[k]
        else:
            dx = dx1
    return dx, dhp, dan_s, dan_b, dw1y, db1, dwm, dbm, dwout, dbout


def train_keep_reference(
    bound: torch.Tensor,
    h_proj: torch.Tensor,
    an_scale: torch.Tensor,
    an_bias: torch.Tensor,
    ortho: torch.Tensor,
    w1y: torch.Tensor,
    b1: torch.Tensor,
    wm: torch.Tensor,
    bm: torch.Tensor,
    wout: torch.Tensor,
    bout: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version of what the strict K2a keeps for the strict K2b,
    from the step inputs `bound`, laid out as `fma_keep_floats` counts it
    (`csrc/flow_fma.cu`: `fma_keep_act`, `fma_keep_s`): for each step k, h_l
    = gelu(a_l) for l = 0 .. nh, then gelu'(a_l) for l = 0 .. nh, each of Bp
    = `fma_keep_rows` rows, h row-major (Bp, Hp), gelu' a row group of G
    rows at a time in a G x Hp block (`fma_keep_grad_at`); after every step's, each
    step's s = tanh(s'), (B, d_b). Rows past B are what the kernel computes
    for its last row group's rows past the batch, which the strict K2b never
    reads: the flow of a zero row, conditioned on h_proj[k, r % B]. With it
    the strict K2b runs on the plain version's inputs."""
    S, B, size = bound.shape
    d_a, Hp = w1y.shape[1], w1y.shape[2]
    Bp, G = fma_keep_rows(B, Hp), 4 * fma_lane_rows(Hp)
    at = fma_keep_grad_at(Hp).to(bound.device)
    args = (an_scale, an_bias, ortho, w1y, b1, wm, bm, wout, bout)

    def blocks(g: torch.Tensor) -> torch.Tensor:  # gelu' (Bp, Hp) as the keep lays out its row groups' blocks
        out = torch.empty_like(g).view(Bp // G, G * Hp)
        out[:, at] = g.view(Bp // G, G, Hp).transpose(1, 2).reshape(Bp // G, G * Hp)
        return out

    if Bp > B:
        wrap = torch.arange(B, Bp, device=bound.device) % B
        past = fused_flow_train_reference(bound.new_zeros((Bp - B, size)), h_proj[:, wrap], *args)[2]
        bound, h_proj = torch.cat([bound, past], dim=1), torch.cat([h_proj, h_proj[:, wrap]], dim=1)
    acts_and_grads, ss = [], []
    for k in range(S):
        x1 = bound[k] * an_scale[k] + an_bias[k] if k < S - 1 else bound[k]
        acts, hs = _train_step_mlp(k, x1[:, :d_a], h_proj, w1y, b1, wm, bm)
        ss.append(torch.tanh((hs[-1][:B] @ wout[k] + bout[k])[:, d_a - size:]))
        acts_and_grads += hs + [blocks(gelu_grad(a)) for a in acts]
    return torch.cat([t.reshape(-1) for t in acts_and_grads + ss])


def _check_train_args(x: torch.Tensor, h_proj: torch.Tensor, args: dict[str, torch.Tensor],
                      first: int | None = None) -> None:
    if (x.dim() != 2 or h_proj.dim() != 3
            or (h_proj.shape[1] != x.shape[0] if first is None else not 0 <= first <= h_proj.shape[1] - x.shape[0])):
        raise ValueError(
            f"fused_flow_train: rows carry their own conditions, so h_proj must be (S, B, H) for x of "
            f"(B, size), or hold rows first .. first + B - 1 given `first`; got x {tuple(x.shape)}, h_proj "
            f"{tuple(h_proj.shape)}, first {first}"
        )
    if x.device.type == "cuda":
        _check_args(x, dict(h_proj=h_proj, **args), h_proj.shape[1])


def fused_flow_train_fwd(
    x: torch.Tensor, h_proj: torch.Tensor, an_scale: torch.Tensor, an_bias: torch.Tensor,
    ortho: torch.Tensor, w1y: torch.Tensor, b1: torch.Tensor, wm: torch.Tensor, bm: torch.Tensor,
    wout: torch.Tensor, bout: torch.Tensor, *, mode: str = MODE_3XTF32, wstages: torch.Tensor | None = None,
    keep: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2a: `(z, logdet, bound)` in one launch. A CPU tensor takes
    `fused_flow_train_reference` (float32 in every mode); a CUDA tensor
    launches the forward kernel `flow_route` gives for `mode` (the row tiles
    with their step-input store in 3xTF32 or one TF32 pass, the `wgmma`
    forward of either mode, which reads the hidden weights as
    `prepare_train_weights` lays them out for the mode: pass them as
    `wstages`, or they are prepared here; at Hp 768 and 1024 the wide
    forward of the mode with its step-input store, on `prepare_wide_weights`'
    layout for the mode, passed or prepared in the same way; strict, the float32 FMA kernel with
    its step-input store, which also fills `keep` with what the strict K2b
    reads: pass `train_keep`'s buffer, else it raises), or raises. Counts its
    launches in `launches`, by mode in `mode_launches` and by route in
    `route_launches`."""
    args = dict(an_scale=an_scale, an_bias=an_bias, ortho=ortho, w1y=w1y, b1=b1, wm=wm, bm=bm,
                wout=wout, bout=bout)
    _check_train_args(x, h_proj, args)
    if keep is None and _strict_route(x, h_proj, w1y.shape[1], mode):  # raises
        _checked_keep(keep, ROUTE_FMA, x.shape[0], h_proj.shape[0], x.shape[1], w1y.shape[1], wm.shape[1],
                      h_proj.shape[2], x.device, "fused_flow_train_fwd")
    return _train_fwd(x, h_proj, args, mode, wstages, keep)


def _train_fwd(x: torch.Tensor, h_proj: torch.Tensor, args: dict[str, torch.Tensor], mode: str,
               wstages: torch.Tensor | None, keep: torch.Tensor | None,
               first: int | None = None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`fused_flow_train_fwd`, where the strict route may also keep nothing
    (keep None: the forward of a step whose backward runs in row chunks) and,
    given `first`, runs on rows first .. first + B - 1 of h_proj's (as the
    chunked backward runs it again on a chunk's step inputs, into the
    chunk's keep)."""
    _check_mode(mode, TRAIN_MODES)
    _check_train_args(x, h_proj, args, first)
    if x.device.type == "cpu":
        rows = h_proj if first is None else h_proj[:, first:first + x.shape[0]]
        return fused_flow_train_reference(x, rows, **args)
    if x.device.type != "cuda":
        raise ValueError(f"fused_flow_train runs on CPU or CUDA tensors, not {x.device}")

    from bcnf_tpu_torch.ops._build import load_library

    B, size = x.shape
    S, N, Hp = h_proj.shape
    an_scale, an_bias, ortho, w1y, b1, wm, bm, wout, bout = args.values()
    d_a, nh = w1y.shape[1], wm.shape[1]
    route = flow_route(Hp, size, d_a, False, mode)
    if route is None:
        raise ValueError(f"fused_flow_train_fwd: no kernel takes size {size}, d_a {d_a} at hidden width {Hp} ({mode})")
    if first is not None and route != ROUTE_FMA:
        raise ValueError(f"fused_flow_train_fwd: row ranges (first) are the strict route's, not {route}'s")
    if keep is not None:
        _checked_keep(keep, route, B, S, size, d_a, nh, Hp, x.device, "fused_flow_train_fwd")
    z = torch.empty_like(x)
    ld = torch.empty((B,), dtype=x.dtype, device=x.device)
    bound = torch.empty((S, B, size), dtype=x.dtype, device=x.device)
    if B == 0:
        return z, ld, bound
    lib = load_library(ROUTE_LIBRARY[route])
    with torch.cuda.device(x.device):  # the forward with its step-input store, N = B
        if route in FWD_WGMMA_ROUTES:
            staged = route_weights(route, wm, wstages)
            err = lib.bcnf_flow_fwd_wgmma(
                *_ptrs(x, h_proj, an_scale, an_bias, ortho, w1y, b1, staged, bm, wout, bout, z, ld, bound),
                B, B, S, size, d_a, nh, Hp, _stream())
        elif route in WIDE_FWD_ROUTES:
            passes = 1 if route in WIDE_TF32_ROUTES else 3
            if wstages is not None and tuple(wstages.shape) == (2, *_wide_weights_shape(S, nh, Hp, passes)):
                wstages = wstages[0]  # a step's layout for K2a and the wide K2b: K2a reads Wm's
            staged = route_weights(route, wm, wstages)
            err = lib.bcnf_flow_forward_wide(
                *_ptrs(x, h_proj, an_scale, an_bias, ortho, w1y, b1, staged, bm, wout, bout, z, ld, bound),
                B, B, S, size, d_a, nh, Hp, wide_fwd_rows(B), WG_ALL, _stream())
        elif route == ROUTE_FMA:  # row r takes h_proj[k, first + r]: the kernel reads them N rows a step apart
            err = lib.bcnf_fused_flow_train(
                *_ptrs(x, h_proj[:, first or 0:], an_scale, an_bias, ortho, w1y, b1, wm, bm, wout, bout, z, ld,
                       bound),
                ctypes.c_void_p(None if keep is None else keep.data_ptr()), B, N, S, size, d_a, nh, Hp, _stream())
        else:
            err = lib.bcnf_flow_rows(
                *_ptrs(x, h_proj, an_scale, an_bias, ortho, w1y, b1, wm, bm, wout, bout, z, ld, bound),
                B, B, S, size, d_a, nh, Hp, 0, _stream())
    _raise_on(err, lib, f"fused_flow_train_fwd ({route})")
    fused_flow_train_fwd.launches += 1
    fused_flow_train_fwd.mode_launches[mode] += 1
    fused_flow_train_fwd.route_launches[route] += 1
    return z, ld, bound


fused_flow_train_fwd.launches = 0  # type: ignore[attr-defined]
fused_flow_train_fwd.mode_launches = collections.Counter()  # type: ignore[attr-defined]
fused_flow_train_fwd.route_launches = collections.Counter()  # type: ignore[attr-defined]


def train_weights(x: torch.Tensor, h_proj: torch.Tensor, wm: torch.Tensor, d_a: int, mode: str) -> torch.Tensor | None:
    """The hidden weights of a training step as `prepare_train_weights` lays
    them out for `mode` (hi; in 3xTF32 hi and lo), prepared once for K2a and
    K2b where either runs on its `wgmma` route (a CUDA tensor in the 3xTF32
    or the one-pass mode at the widths those routes hold); at Hp 768 and
    1024, where K2b runs on the wide route of the mode,
    `prepare_wide_train_weights` for the mode (both directions; K2a's wide
    forward reads the first); None where
    neither reads a shared layout (K2a's wide forward with K2b on its row
    tiles lays out its own)."""
    if x.device.type != "cuda" or mode not in TF32_MODES:
        return None
    Hp, size, nh = h_proj.shape[-1], x.shape[1], wm.shape[1]
    if train_bwd_route(Hp, size, d_a, nh, mode) in WIDE_TRAIN_ROUTES:
        return prepare_wide_train_weights(wm, 3 if mode == MODE_3XTF32 else 1)
    if (flow_route(Hp, size, d_a, False, mode) in FWD_WGMMA_ROUTES
            or train_bwd_route(Hp, size, d_a, nh, mode) in (ROUTE_WGMMA, ROUTE_WGMMA_TF32)):
        return prepare_train_weights(wm, 3 if mode == MODE_3XTF32 else 1)
    return None


def train_keep(x: torch.Tensor, h_proj: torch.Tensor, wm: torch.Tensor, d_a: int, mode: str) -> torch.Tensor | None:
    """An empty buffer for what the strict K2a keeps for the strict K2b
    (`fma_keep_floats`: each step's h_l and gelu'(a_l), and s; 2.32 GB at the
    flagship's 4096 rows) on x's rows, where K2a runs on its float32 FMA
    route (a CUDA tensor in `MODE_FMA`), which requires it; None elsewhere.
    K2a fills it, K2b reads it: the training step hands it from one to the
    other, or, where the backward runs in row chunks (`strict_chunks`), the
    backward makes one for the largest chunk, which serves every chunk."""
    if not _strict_route(x, h_proj, d_a, mode):
        return None
    (B, size), (S, _, Hp), nh = x.shape, h_proj.shape, wm.shape[1]
    return torch.empty((fma_keep_floats(B, S, size, d_a, nh, Hp),), dtype=torch.float32, device=x.device)


def _checked_keep(keep: torch.Tensor | None, route: str, B: int, S: int, size: int, d_a: int, nh: int, Hp: int,
                  device: torch.device, what: str) -> torch.Tensor:
    """`keep` if it is what `train_keep` gives for this call, else raises."""
    n = fma_keep_floats(B, S, size, d_a, nh, Hp)
    if keep is None:
        raise ValueError(f"{what}: the strict route needs the strict K2a's keep ({n} float32): pass "
                         f"keep=train_keep(...) to fused_flow_train_fwd and the same buffer to fused_flow_train_bwd")
    if (route != ROUTE_FMA or keep.dtype != torch.float32 or keep.device != device or not keep.is_contiguous()
            or keep.numel() != n or keep.data_ptr() % 16):
        raise ValueError(f"{what}: keep must be {n} contiguous float32 on {device}, 16-byte aligned, on the strict "
                         f"route (got {keep.numel()} {keep.dtype} on {keep.device}, route {route})")
    return keep


BWD_ROWS, BWD_WEIGHT_GRADS, BWD_ACTNORM = 1, 2, 4  # K2b's parts


def fused_flow_train_bwd(
    bound: torch.Tensor, h_proj: torch.Tensor, dz: torch.Tensor, dld: torch.Tensor,
    an_scale: torch.Tensor, an_bias: torch.Tensor, ortho: torch.Tensor, w1y: torch.Tensor,
    b1: torch.Tensor, wm: torch.Tensor, bm: torch.Tensor, wout: torch.Tensor, bout: torch.Tensor,
    *, mode: str = MODE_3XTF32, wstages: torch.Tensor | None = None, keep: torch.Tensor | None = None,
    chunk_rows: int | None = None,
) -> tuple[torch.Tensor, ...]:
    """K2b: every grad of K2a's outputs, in one call of the kernel's entry
    point (which enqueues a few launches per step). Returns `(dx, dh_proj,
    dan_scale, dan_bias, dw1y, db1, dwm, dbm, dwout, dbout)`. A CPU tensor
    takes `fused_flow_train_backward_reference` (float32 in every mode); a
    CUDA tensor launches the kernels of `train_bwd_route` for `mode` (the row
    tiles of `csrc/flow_train_kernel.cu`, at Hp <= 544 the `wgmma` route of
    `csrc/flow_train_wgmma.cu` built for the mode, on `wstages` as
    `prepare_train_weights` lays out `wm` for it, or on weights it prepares;
    at Hp 768 and 1024 the wide route of `csrc/flow_wide_train_wgmma.cu`
    built for the mode, on `prepare_wide_train_weights`' layout for the mode,
    passed or prepared in the same way;
    strict, the float32 FMA kernels of `csrc/flow_train_fma.cu`, on what the
    strict K2a kept in `keep` for these inputs: without it, it raises), or
    raises. Strict, where `strict_chunks` splits the rows (`chunk_rows`, or
    the card's memory), it takes no keep: for each chunk it runs K2a again on
    the chunk's step inputs into the keep, then K2b on the chunk's rows, and
    sums the weight and ActNorm grads over the chunks; one keep and one
    scratch, allocated once, serve every chunk (counted in `allocations`; on
    the CPU, the plain backward a chunk). Counts its calls (one a chunk) in
    `launches`, by mode in `mode_launches` and by route in
    `route_launches`; the chunks' K2a runs count as K2a's."""
    _check_mode(mode, TRAIN_MODES)
    args = dict(an_scale=an_scale, an_bias=an_bias, ortho=ortho, w1y=w1y, b1=b1, wm=wm, bm=bm,
                wout=wout, bout=bout)
    _check_train_args(dz, h_proj, args)
    S, B, size = bound.shape
    if tuple(bound.shape) != (h_proj.shape[0], *dz.shape) or tuple(dld.shape) != (dz.shape[0],):
        raise ValueError(f"fused_flow_train_bwd: bound {tuple(bound.shape)}, dz {tuple(dz.shape)} and "
                         f"dld {tuple(dld.shape)} do not match h_proj {tuple(h_proj.shape)}")
    chunks = strict_chunks(dz, h_proj, wm, w1y.shape[1], mode, chunk_rows)
    if chunks is not None:
        if keep is not None:
            raise ValueError("fused_flow_train_bwd: in row chunks the backward makes each chunk's keep (keep must "
                             "be None)")
        return _strict_train_bwd_chunks(bound, h_proj, dz, dld, args, chunks)
    if dz.device.type == "cpu":
        return fused_flow_train_backward_reference(bound, h_proj, dz, dld, **args)
    if dz.device.type != "cuda":
        raise ValueError(f"fused_flow_train runs on CPU or CUDA tensors, not {dz.device}")
    for name, t in (("bound", bound), ("dld", dld)):
        if t.dtype != torch.float32 or t.device != dz.device or not t.is_contiguous():
            raise ValueError(f"fused_flow_train_bwd: {name} must be contiguous float32 on {dz.device}")

    grads = (torch.empty_like(dz), torch.empty_like(h_proj), torch.empty_like(an_scale),
             torch.empty_like(an_bias), torch.empty_like(w1y), torch.empty_like(b1), torch.empty_like(wm),
             torch.empty_like(bm), torch.empty_like(wout), torch.empty_like(bout))
    if B == 0:
        return tuple(g.zero_() for g in grads)
    route = _train_bwd_parts(bound, h_proj, dz, dld, args, grads, BWD_ROWS | BWD_WEIGHT_GRADS | BWD_ACTNORM, mode,
                             wstages, keep)
    fused_flow_train_bwd.launches += 1
    fused_flow_train_bwd.mode_launches[mode] += 1
    fused_flow_train_bwd.route_launches[route] += 1
    return grads


def strict_chunk_buffers(chunks: list[tuple[int, int]], S: int, size: int, d_a: int, nh: int,
                         Hp: int) -> tuple[int, int]:
    """Floats of the one keep (`fma_keep_floats`) and the one K2b scratch
    (`fma_train_scratch_floats`) that serve every row chunk of the strict
    backward: each sized for the largest chunk, which may be the last
    (`row_chunks` joins a short tail to it). A chunk of fewer rows uses the
    first floats of each, as the kernels lay them out for its rows."""
    rows = max(end - first for first, end in chunks)
    return fma_keep_floats(rows, S, size, d_a, nh, Hp), fma_train_scratch_floats(rows, S, size, d_a, nh, Hp)


def _strict_train_bwd_chunks(bound: torch.Tensor, h_proj: torch.Tensor, dz: torch.Tensor, dld: torch.Tensor,
                             args: dict[str, torch.Tensor], chunks: list[tuple[int, int]]) -> tuple[torch.Tensor, ...]:
    """The strict backward in row chunks (`fused_flow_train_bwd`): dx and
    dh_proj written chunk by chunk, the other grads summed over the chunks
    in their order. On the card one keep, one K2b scratch and one set of a
    chunk's weight and ActNorm grads are allocated before the first chunk
    and serve every chunk (`strict_chunk_buffers`; counted in
    `fused_flow_train_bwd.allocations`), so that the allocator is not asked
    for a chunk's gigabytes again at every chunk; the first chunk writes its
    grads into the sums, each later one into that set, added to the sums."""
    dx, dhp = torch.empty_like(dz), torch.empty_like(h_proj)
    if dz.device.type == "cpu":  # the plain backward recomputes the MLP from the step inputs
        sums = []
        for first, end in chunks:
            g = fused_flow_train_backward_reference(bound[:, first:end], h_proj[:, first:end], dz[first:end],
                                                    dld[first:end], **args)
            dx[first:end], dhp[:, first:end] = g[0], g[1]
            sums = list(g[2:]) if not sums else [t.add_(c) for t, c in zip(sums, g[2:])]
        return (dx, dhp, *sums)
    (S, _, size), Hp = bound.shape, h_proj.shape[-1]
    d_a, nh = args["w1y"].shape[1], args["wm"].shape[1]
    n_keep, n_scratch = strict_chunk_buffers(chunks, S, size, d_a, nh, Hp)
    keep = torch.empty((n_keep,), dtype=torch.float32, device=dz.device)
    scratch = torch.empty((n_scratch,), dtype=torch.float32, device=dz.device)
    fused_flow_train_bwd.allocations.update(("keep", "scratch"))
    weights = [t for name, t in args.items() if name != "ortho"]  # the grads' shapes: dx and dh_proj's come first
    sums, part = [torch.empty_like(t) for t in weights], [torch.empty_like(t) for t in weights]
    for i, (first, end) in enumerate(chunks):
        x = bound[0, first:end]
        mine = keep[:fma_keep_floats(end - first, S, size, d_a, nh, Hp)]
        _train_fwd(x, h_proj, args, MODE_FMA, None, mine, first)
        route = _train_bwd_parts(bound, h_proj, dz, dld, args, (dx, dhp, *(part if i else sums)),
                                 BWD_ROWS | BWD_WEIGHT_GRADS | BWD_ACTNORM, MODE_FMA, None, mine, (first, end), scratch)
        fused_flow_train_bwd.launches += 1
        fused_flow_train_bwd.mode_launches[MODE_FMA] += 1
        fused_flow_train_bwd.route_launches[route] += 1
        if i:
            for t, c in zip(sums, part):
                t.add_(c)
    return (dx, dhp, *sums)


def _train_bwd_parts(bound: torch.Tensor, h_proj: torch.Tensor, dz: torch.Tensor, dld: torch.Tensor,
                     args: dict[str, torch.Tensor], grads: tuple[torch.Tensor, ...], parts: int,
                     mode: str = MODE_3XTF32, wstages: torch.Tensor | None = None,
                     keep: torch.Tensor | None = None, rows: tuple[int, int] | None = None,
                     scratch: torch.Tensor | None = None) -> str:
    """Launch K2b's parts on checked CUDA tensors into `grads`, uncounted, on
    the route `train_bwd_route` gives; returns the route. The rows kernels
    (`BWD_ROWS`; on the tensor-core routes one a step, with the copy of dz
    that starts the carried dx; strict, one for every step) and the
    weight-grad passes (`BWD_WEIGHT_GRADS`; one a step, strict one for every
    step), then the rest (`BWD_ACTNORM`: the ActNorm grads; on the `wgmma`
    route also dWout, dbout, dW1y and db1, summed from the rows kernels'
    partials). The wrapper runs all three; chip_smoke.py times each alone.
    The `wgmma` route reads the hidden weights as `prepare_train_weights`
    lays them out, the wide routes as `prepare_wide_train_weights` does for
    their mode (on tiles of `wide_fwd_rows(B)` rows): pass them as `wstages`, or they are
    prepared here. The
    strict route reads what the strict K2a kept in `keep` (required), and
    takes `rows` = (first, end): the grads of those rows alone (dx and
    dh_proj into those rows of `grads`' first two, the rest their sums),
    from a keep of end - first rows. `scratch`, float32 on the card, lends
    its first floats to the kernels' scratch (the chunked backward's one
    scratch for every chunk); by default one is allocated for the call."""
    from bcnf_tpu_torch.ops._build import load_library

    S, B, size = bound.shape
    Hp = h_proj.shape[-1]
    d_a, nh = args["w1y"].shape[1], args["wm"].shape[1]
    route = train_bwd_route(Hp, size, d_a, nh, mode)
    if route is None:
        raise ValueError(f"fused_flow_train_bwd: no kernel takes size {size}, d_a {d_a}, {nh} hidden layers at "
                         f"hidden width {Hp} ({mode})")
    first, end = (0, B) if rows is None else rows
    if rows is not None and (route != ROUTE_FMA or not 0 <= first < end <= B):
        raise ValueError(f"fused_flow_train_bwd: rows {rows} of {B} on route {route} (row ranges are the strict "
                         f"route's)")
    tensors = list(args.values())
    if route in (ROUTE_WGMMA, ROUTE_WGMMA_TF32):
        passes = 3 if route == ROUTE_WGMMA else 1
        tensors[5] = prepare_train_weights(args["wm"], passes) if wstages is None else _checked_wstages(
            wstages, _train_weights_shape(S, nh, Hp, passes), args["wm"], f"fused_flow_train_bwd ({route})")
    elif route in WIDE_TRAIN_ROUTES:
        passes = 1 if route == ROUTE_WIDE_TRAIN_TF32 else 3
        tensors[5] = prepare_wide_train_weights(args["wm"], passes) if wstages is None else _checked_wstages(
            wstages, (2, *_wide_weights_shape(S, nh, Hp, passes)), args["wm"], f"fused_flow_train_bwd ({route})",
            exact=True)
    if route == ROUTE_FMA or keep is not None:
        tensors.append(_checked_keep(keep, route, end - first, S, size, d_a, nh, Hp, dz.device,
                                     "fused_flow_train_bwd"))
    lib = load_library(TRAIN_BWD_LIBRARY[route])
    shape = (B, S, size, d_a, nh, Hp)
    if route in (ROUTE_WGMMA, ROUTE_WGMMA_TF32):
        n_scratch, entry = lib.bcnf_flow_train_wgmma_scratch(*shape), lib.bcnf_flow_train_bwd_wgmma
    elif route in WIDE_TRAIN_ROUTES:  # on tiles of the wide forward's rows
        shape = (*shape, wide_fwd_rows(B))
        n_scratch, entry = lib.bcnf_flow_train_wide_scratch(*shape), lib.bcnf_flow_train_bwd_wide
    elif route == ROUTE_FMA:  # the rows first .. end - 1 of B
        n_scratch, entry = lib.bcnf_flow_train_fma_scratch(end - first, *shape[1:]), lib.bcnf_flow_train_bwd_fma
        shape = (B, first, end - first, *shape[1:])
    else:
        n_scratch, entry = lib.bcnf_flow_train_bwd_scratch(*shape), lib.bcnf_flow_train_bwd
    if scratch is None:
        scratch = torch.empty((n_scratch,), dtype=torch.float32, device=dz.device)
    elif scratch.dtype != torch.float32 or scratch.device != dz.device or scratch.numel() < n_scratch:
        raise ValueError(f"fused_flow_train_bwd: scratch must hold {n_scratch} float32 on {dz.device}, got "
                         f"{scratch.numel()} {scratch.dtype} on {scratch.device}")
    scratch = scratch[:n_scratch]
    with torch.cuda.device(dz.device):
        err = entry(*_ptrs(bound, h_proj, dz, dld, *tensors, *grads, scratch), *shape, parts, _stream())
    _raise_on(err, lib, f"fused_flow_train_bwd ({route})")
    return route


def train_bwd_wgmma_layout(Hp: int, size: int, d_a: int, nh: int, B: int,
                           mode: str = MODE_TF32) -> tuple[int, int, int, int]:
    """K2b's `wgmma` route in `mode` at this shape on the current card (the
    occupancy calculator's numbers, `csrc/flow_train_wgmma.cu`): the rows
    kernel's blocks, its clusters resident at once on the card, the
    weight-grad pass's blocks a step, and its blocks resident on an SM."""
    from bcnf_tpu_torch.ops._build import load_library

    lib = load_library(TRAIN_BWD_LIBRARY[ROUTE_WGMMA if mode == MODE_3XTF32 else ROUTE_WGMMA_TF32])
    out = (ctypes.c_int * 4)()
    _raise_on(lib.bcnf_flow_train_wgmma_layout(Hp, size, d_a, nh, B, out), lib, "train_bwd_wgmma_layout")
    return tuple(out)


fused_flow_train_bwd.launches = 0  # type: ignore[attr-defined]
fused_flow_train_bwd.mode_launches = collections.Counter()  # type: ignore[attr-defined]
fused_flow_train_bwd.route_launches = collections.Counter()  # type: ignore[attr-defined]
# buffers the chunked strict backward allocates for all its chunks: "keep", "scratch"
fused_flow_train_bwd.allocations = collections.Counter()  # type: ignore[attr-defined]


_TRAIN_ARGS = ("an_scale", "an_bias", "ortho", "w1y", "b1", "wm", "bm", "wout", "bout")


class _FusedFlowTrain(torch.autograd.Function):
    """K2a forward, K2b backward: the custom VJP of the JAX package
    (`bcnf_tpu/ops/flow_kernel.py:653-672`), both in the kernel mode given
    first (the backward runs in the forward's mode, whatever the context it
    runs in). The mixes get zero grads. Where K2a or K2b runs on its `wgmma`
    route, the hidden weights are prepared once in the forward
    (`train_weights`) and held for the backward: twice Wm's bytes in one pass
    (246 MB at the flagship's 26 steps of 4 layers at Hp 544), four times in
    3xTF32 (hi and lo, 492 MB), from K2a to K2b; at Hp 768 and 1024 Wm and
    Wm^T in float32, or rounded to TF32 in one pass
    (`prepare_wide_train_weights`: 1.07 GB at the wide config's 32 steps of
    4 layers at Hp 1024). Strict, K2a keeps each
    layer's activations and gelu' for K2b (`train_keep`, 2.32 GB at the
    flagship's 4096 rows), unless the rows take more than one chunk
    (`strict_chunks`: past 13,088 rows at the flagship's shape on an 80 GB
    card): then the backward runs K2a again a chunk, into one keep that
    serves every chunk."""

    @staticmethod
    def forward(ctx: Any, mode: str, chunk_rows: int | None, x: torch.Tensor, h_proj: torch.Tensor,
                *args: torch.Tensor) -> tuple[torch.Tensor, ...]:
        wstages = train_weights(x, h_proj, args[5], args[3].shape[1], mode)
        chunked = strict_chunks(x, h_proj, args[5], args[3].shape[1], mode, chunk_rows) is not None
        keep = None if chunked else train_keep(x, h_proj, args[5], args[3].shape[1], mode)
        z, ld, bound = _train_fwd(x, h_proj, dict(zip(_TRAIN_ARGS, args)), mode, wstages, keep)
        ctx.save_for_backward(bound, h_proj, *args)
        ctx.mode, ctx.chunk_rows, ctx.wstages, ctx.keep = mode, chunk_rows, wstages, keep
        return z, ld

    @staticmethod
    def backward(ctx: Any, dz: torch.Tensor, dld: torch.Tensor) -> tuple[torch.Tensor | None, ...]:
        bound, h_proj, *args = ctx.saved_tensors  # an unused output's cotangent arrives as zeros
        dx, dhp, dan_s, dan_b, dw1y, db1, dwm, dbm, dwout, dbout = fused_flow_train_bwd(
            bound, h_proj, dz.contiguous(), dld.contiguous(), *args, mode=ctx.mode, wstages=ctx.wstages, keep=ctx.keep,
            chunk_rows=ctx.chunk_rows)
        return None, None, dx, dhp, dan_s, dan_b, torch.zeros_like(args[2]), dw1y, db1, dwm, dbm, dwout, dbout


def fused_flow_train(
    x: torch.Tensor,
    h_proj: torch.Tensor,
    an_scale: torch.Tensor,
    an_bias: torch.Tensor,
    ortho: torch.Tensor,
    w1y: torch.Tensor,
    b1: torch.Tensor,
    wm: torch.Tensor,
    bm: torch.Tensor,
    wout: torch.Tensor,
    bout: torch.Tensor,
    *,
    mode: str = MODE_3XTF32,
    chunk_rows: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable `(z, logdet)` of the whole flow for training
    (`bcnf_tpu/ops/flow_kernel.py::fused_flow_train`): K2a forward, K2b
    backward, both in `mode` (3xTF32, one TF32 pass or float32 FMA). Arguments as
    `stack_flow_params`/`pad_hidden` give them, with one condition row per
    row of `x` (h_proj is (S, B, Hp)); raises otherwise. In `MODE_FMA`,
    `chunk_rows` forces the strict backward's row chunks (`strict_chunks`;
    by default the card's memory decides them, and a CPU tensor takes none)."""
    return _FusedFlowTrain.apply(mode, chunk_rows, x, h_proj, an_scale, an_bias, ortho, w1y, b1, wm, bm, wout, bout)
