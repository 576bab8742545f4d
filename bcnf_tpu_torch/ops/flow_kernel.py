"""The whole RealNVP flow in CUDA kernels: host side.

- K1, `fused_flow`, replaces `bcnf_tpu/ops/flow_kernel.py::fused_flow` (the
  Pallas TPU kernel `_flow_kernel`). Its route is chosen by mode and shape
  (`flow_route`), never by catching a failure:
  - the default mode (the "highest"/"float32" contract, which the JAX model
    serves with its "x3" kernel mode) runs 3xTF32 on the tensor cores: the
    inverse on `wgmma` (`csrc/flow_wgmma.cu`, with the hidden weights
    prepared once a call by `prepare_weights`) at padded widths up to 544,
    the row-tile kernel above that (`rows_flow_kernel` in
    `csrc/flow_kernel.cu`); the forward on the row-tile kernel;
  - the reduced mode (the "default", "bfloat16" and "BF16_BF16_F32_X3"
    precisions, which the JAX model serves with its "default" kernel mode)
    runs the same kernels built with one TF32 pass a product (the `*_tf32`
    libraries, `ops/_build.py`); its `wgmma` inverse streams hi-only weight
    stages (`prepare_weights(wm, passes=1)`);
  - the strict mode (`CondRealNVP(pallas_strict=True)`, as the JAX model's
    strict flag forces its exact-float32 kernel mode) runs the float32 FMA
    kernel (`flow_kernel` in `csrc/flow_kernel.cu`) both ways.
- K4, the per-coupling kernel, is K1 at one step (`ops/coupling_kernel.py`).
- K2a/K2b, `fused_flow_train`, replace `fused_flow_train` and its custom VJP
  (`fwd_call`/`bwd_call` of `_make_fused_flow_train`): a
  `torch.autograd.Function` whose forward is K2a (`fused_flow_train_fwd`,
  the row-tile kernel with its step-input store) and whose backward is K2b
  (`fused_flow_train_bwd`, `csrc/flow_train_kernel.cu`). Both run their
  square hidden products on the tensor cores in 3xTF32 (`csrc/flow_rows.cuh`),
  or in one TF32 pass in the reduced mode.

The kernel modes (`KERNEL_MODES`): `MODE_3XTF32`, `MODE_TF32` (one pass) and
`MODE_FMA` (strict, K1 only). A CPU tensor takes the plain version, float32,
in every mode, as JAX on the CPU computes float32 at every precision.

This module stacks and pads the kernels' arguments, checks them, launches
them on PyTorch's current stream, and holds their plain PyTorch versions
(`fused_flow_reference`, `fused_flow_train_reference`,
`fused_flow_train_backward_reference`), which serve CPU tensors (the tests)
and which `chip_smoke.py` holds the kernels against on the card.

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
# "highest" kernel mode; K1 only).
MODE_3XTF32, MODE_TF32, MODE_FMA = "3xtf32", "tf32", "fma"
KERNEL_MODES = (MODE_3XTF32, MODE_TF32, MODE_FMA)
TF32_MODES = (MODE_3XTF32, MODE_TF32)  # the tensor-core modes: K2a, K2b and K4 have no float32 FMA mode
# K1's routes (`flow_route`): 3xTF32 on `wgmma` (the inverse at TN <= 17),
# 3xTF32 on the row tiles, float32 FMA (strict), and the one-pass `wgmma`
# and row tiles; each route's library (`ops/_build.py`).
ROUTE_WGMMA, ROUTE_ROWS, ROUTE_FMA = "wgmma", "rows", "fma"
ROUTE_WGMMA_TF32, ROUTE_ROWS_TF32 = "wgmma_tf32", "rows_tf32"
ROUTE_LIBRARY = {ROUTE_WGMMA: "flow_wgmma", ROUTE_ROWS: "flow_kernel", ROUTE_FMA: "flow_kernel",
                 ROUTE_WGMMA_TF32: "flow_wgmma_tf32", ROUTE_ROWS_TF32: "flow_kernel_tf32"}
WGMMA_MAX_TN = 17  # the widest width the wgmma inverse holds (Hp 544; csrc/flow_wgmma.cu)
ROUTE_TRAIN_BWD = "train_bwd"  # K2b's rows kernel, for `kernel_smem` (csrc/flow_train_kernel.cu: launch_rows)
# The limits the kernels' launchers check, by the header that defines each:
# the dynamic shared memory a block may use, and the weight-grad jobs one
# AtbJobs launch holds (K2b's nh + 3 a step).
_LIMIT_HEADERS = {"kSmemLimit": "flow_common.cuh", "kAtbMaxJobs": "atb.cuh"}


@functools.cache
def kernel_limit(name: str) -> int:
    """A limit of `_LIMIT_HEADERS`, read from the `constexpr` in its header
    under `csrc/`, so that the gates and the launchers' checks share one
    number. Read at first use, not at import."""
    text = (Path(__file__).resolve().parent / "csrc" / _LIMIT_HEADERS[name]).read_text()
    match = re.search(rf"constexpr\s+\w+\s+{name}\s*=\s*(\d+)\s*;", text)
    if match is None:
        raise RuntimeError(f"no constexpr {name} in csrc/{_LIMIT_HEADERS[name]}")
    return int(match.group(1))


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
    `launch`, `launch_rows`; `csrc/flow_wgmma.cu`: `wg_smem`), and of K2b's
    rows kernel (`ROUTE_TRAIN_BWD`; `csrc/flow_train_kernel.cu`: `launch_rows`)."""
    tn, n_out = Hp // 32, 2 * (size - d_a)
    if route in (ROUTE_WGMMA, ROUTE_WGMMA_TF32):  # tile, 2 stages of hi (and lo), x, x Q^T, [t | s'], 4 barriers
        stage = (16 if route == ROUTE_WGMMA else 8) * Hp
        return 4 * (64 * (Hp + 4) + 2 * stage + 64 * (2 * size + n_out)) + 32
    if route in (ROUTE_ROWS, ROUTE_ROWS_TF32, ROUTE_TRAIN_BWD):  # tile, the 3-stage ring (csrc/flow_rows.cuh), then
        BM, BK = (32, 16) if tn <= 17 else (16, 8)
        stage = max(BK * (Hp + 8), Hp * (BK + 4))
        if route == ROUTE_TRAIN_BWD:  # ... K2b's rows' state, BM x (5 size + n_out + d_a + 1)
            return 4 * (BM * (Hp + 4) + 3 * stage + BM * (5 * size + n_out + d_a + 1))
        return 4 * (BM * (Hp + 4) + 3 * stage + BM * (2 * size + n_out + 1))  # ... x, x Q, [t | s'], logdet
    if route == ROUTE_FMA:  # tile, x, x Q, [t | s'], logdet, and the least double buffer it takes (BK = 4)
        BM = 64 if tn <= 17 else 32
        return 4 * (BM * Hp + BM * (2 * size + n_out + 1) + 2 * 4 * Hp)
    raise ValueError(f"unknown route {route!r}")


def _check_mode(mode: str, modes: tuple[str, ...] = KERNEL_MODES) -> None:
    if mode not in modes:
        raise ValueError(f"kernel mode {mode!r} is not one of {modes}")


def flow_route(Hp: int, size: int, d_a: int, inverse: bool, mode: str = MODE_3XTF32) -> str | None:
    """Which of K1's kernels runs this call, by mode and shape: strict
    (`MODE_FMA`) takes the float32 FMA kernel; the default and the one-pass
    mode the `wgmma` inverse where it holds the width and the shape, else
    the row tiles, each built for its mode. None where no kernel takes the
    shape (its shared memory; then the model's gate stays closed, as JAX's
    `inverse_fused_flow` returns None)."""
    _check_mode(mode)
    if Hp % 32 or Hp // 32 not in KERNEL_TN or not 0 < d_a < size:
        return None
    wgmma, rows = (ROUTE_WGMMA_TF32, ROUTE_ROWS_TF32) if mode == MODE_TF32 else (ROUTE_WGMMA, ROUTE_ROWS)
    if mode == MODE_FMA:
        candidates = (ROUTE_FMA,)
    elif inverse and Hp // 32 <= WGMMA_MAX_TN:
        candidates = (wgmma, rows)
    else:
        candidates = (rows,)
    return next((r for r in candidates if kernel_smem(r, Hp, size, d_a) <= kernel_limit("kSmemLimit")), None)


def train_kernels_take(Hp: int, size: int, d_a: int, nh: int) -> bool:
    """Whether K2a and K2b take this shape (in either mode): a width they
    are compiled for, K2b's nh + 3 weight-grad jobs a step within one
    launch's (`kAtbMaxJobs`), and both rows kernels' shared memory within a
    block's (`kSmemLimit`); the checks of their launchers
    (`csrc/flow_kernel.cu`, `csrc/flow_train_kernel.cu`), which return
    cudaErrorInvalidValue past them."""
    if Hp % 32 or Hp // 32 not in KERNEL_TN or not 0 < d_a < size or nh < 1:
        return False
    if nh + 3 > kernel_limit("kAtbMaxJobs"):
        return False
    return all(kernel_smem(r, Hp, size, d_a) <= kernel_limit("kSmemLimit") for r in (ROUTE_ROWS, ROUTE_TRAIN_BWD))


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32, rounded to nearest with ties away from zero (the bits
    of `cvt.rna.tf32.f32`, csrc/mma_tf32.cuh: `tf32_rna`), kept in float32."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def prepare_weights(wm: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """The stacked, padded hidden weights `wm` (S, nh, Hp, Hp), stored (in,
    out), as the `wgmma` inverse reads them (`csrc/flow_wgmma.cu`), on `wm`'s
    device: transposed to K-major (out, in), split into ``hi = tf32(w)``
    (rounded) and ``lo = w - hi`` (exact; the tensor cores read its top 19
    bits), and laid out stage by stage, 8 input rows a stage, each stage
    holding hi then lo in the order of `wgmma`'s core matrices (8 outputs x 4
    inputs, 128 contiguous bytes; the two along the inputs side by side), so
    that one bulk copy moves a stage. Shape (S, nh, Hp/8 stages, 2 [hi, lo],
    Hp/8 output groups, 2 input halves, 8 outputs, 4 inputs). With
    `passes=1` (the one-pass kernel) a stage holds hi alone: (S, nh, Hp/8,
    1, ...), half the bytes."""
    if passes not in (1, 3):
        raise ValueError(f"prepare_weights: a product takes 1 or 3 passes, not {passes}")
    S, nh, Hp, _ = wm.shape
    g = Hp // 8
    # w^T[n, k] with n = 8 ng + r and k = 8 s + 4 kg + c, to (s, ng, kg, r, c)
    wt = wm.transpose(-1, -2).reshape(S, nh, g, 8, g, 2, 4).permute(0, 1, 4, 2, 5, 3, 6).contiguous()
    hi = _round_tf32(wt)
    return torch.stack([hi, wt - hi] if passes == 3 else [hi], dim=3)


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


WG_PRODUCTS, WG_COPIES = 1, 2  # the `wgmma` inverse's parts (csrc/flow_wgmma.cu)


def _launch_flow(x: torch.Tensor, args: dict[str, torch.Tensor], *, inverse: bool, n_cond: int, mode: str,
                 wstages: torch.Tensor | None = None, parts: int = WG_PRODUCTS | WG_COPIES,
                 ) -> tuple[str, torch.Tensor, torch.Tensor | None]:
    """Launch K1 on checked CUDA tensors, uncounted, on the route
    `flow_route` gives for `mode`; returns `(route, y, logdet or None)`. The
    `wgmma` routes read the hidden weights as `prepare_weights` gives them
    for the mode: pass them as `wstages`, or they are prepared here. `parts`
    other than both runs one part of the `wgmma` inverse alone, to time it
    (chip_smoke.py):
    its products on stale weight stages (`WG_PRODUCTS`), or the weights'
    stream without the products (`WG_COPIES`); y is then not the inverse."""
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
        if route in (ROUTE_WGMMA, ROUTE_WGMMA_TF32):
            passes = 1 if route == ROUTE_WGMMA_TF32 else 3
            tensors[6] = prepare_weights(args["wm"], passes) if wstages is None else wstages
            err = lib.bcnf_flow_inverse_wgmma(*_ptrs(x, *tensors, y), B, n_cond, S, size, d_a, nh, Hp, parts, _stream())
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


def _train_library(source: str, mode: str) -> str:
    """The library of a training kernel in `mode` (`ops/_build.py`)."""
    from bcnf_tpu_torch.ops._build import ONE_PASS

    return source + ONE_PASS if mode == MODE_TF32 else source


def _check_train_args(x: torch.Tensor, h_proj: torch.Tensor, args: dict[str, torch.Tensor]) -> None:
    if x.dim() != 2 or h_proj.dim() != 3 or h_proj.shape[1] != x.shape[0]:
        raise ValueError(
            f"fused_flow_train: rows carry their own conditions, so h_proj must be (S, B, H) for x of "
            f"(B, size); got x {tuple(x.shape)} and h_proj {tuple(h_proj.shape)}"
        )
    if x.device.type == "cuda":
        _check_args(x, dict(h_proj=h_proj, **args), x.shape[0])


def fused_flow_train_fwd(
    x: torch.Tensor, h_proj: torch.Tensor, an_scale: torch.Tensor, an_bias: torch.Tensor,
    ortho: torch.Tensor, w1y: torch.Tensor, b1: torch.Tensor, wm: torch.Tensor, bm: torch.Tensor,
    wout: torch.Tensor, bout: torch.Tensor, *, mode: str = MODE_3XTF32,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2a: `(z, logdet, bound)` in one launch. A CPU tensor takes
    `fused_flow_train_reference` (float32 in every mode); a CUDA tensor
    launches the kernel built for `mode` (3xTF32 or one TF32 pass), or raises.
    Counts its launches in `launches`, and by mode in `mode_launches`."""
    _check_mode(mode, TF32_MODES)
    args = dict(an_scale=an_scale, an_bias=an_bias, ortho=ortho, w1y=w1y, b1=b1, wm=wm, bm=bm,
                wout=wout, bout=bout)
    _check_train_args(x, h_proj, args)
    if x.device.type == "cpu":
        return fused_flow_train_reference(x, h_proj, **args)
    if x.device.type != "cuda":
        raise ValueError(f"fused_flow_train runs on CPU or CUDA tensors, not {x.device}")

    from bcnf_tpu_torch.ops._build import load_library

    lib = load_library(_train_library("flow_kernel", mode))
    B, size = x.shape
    S, _, Hp = h_proj.shape
    z = torch.empty_like(x)
    ld = torch.empty((B,), dtype=x.dtype, device=x.device)
    bound = torch.empty((S, B, size), dtype=x.dtype, device=x.device)
    if B == 0:
        return z, ld, bound
    with torch.cuda.device(x.device):  # the row-tile kernel with its step-input store, N = B
        err = lib.bcnf_flow_rows(
            *_ptrs(x, h_proj, an_scale, an_bias, ortho, w1y, b1, wm, bm, wout, bout, z, ld, bound),
            B, B, S, size, w1y.shape[1], wm.shape[1], Hp, 0, _stream(),
        )
    _raise_on(err, lib, "fused_flow_train_fwd")
    fused_flow_train_fwd.launches += 1
    fused_flow_train_fwd.mode_launches[mode] += 1
    return z, ld, bound


fused_flow_train_fwd.launches = 0  # type: ignore[attr-defined]
fused_flow_train_fwd.mode_launches = collections.Counter()  # type: ignore[attr-defined]


BWD_ROWS, BWD_WEIGHT_GRADS, BWD_ACTNORM = 1, 2, 4  # K2b's parts


def fused_flow_train_bwd(
    bound: torch.Tensor, h_proj: torch.Tensor, dz: torch.Tensor, dld: torch.Tensor,
    an_scale: torch.Tensor, an_bias: torch.Tensor, ortho: torch.Tensor, w1y: torch.Tensor,
    b1: torch.Tensor, wm: torch.Tensor, bm: torch.Tensor, wout: torch.Tensor, bout: torch.Tensor,
    *, mode: str = MODE_3XTF32,
) -> tuple[torch.Tensor, ...]:
    """K2b: every grad of K2a's outputs, in one call of the kernel's entry
    point (which enqueues a few launches per step, `csrc/flow_train_kernel.cu`).
    Returns `(dx, dh_proj, dan_scale, dan_bias, dw1y, db1, dwm, dbm, dwout,
    dbout)`. A CPU tensor takes `fused_flow_train_backward_reference` (float32
    in every mode); a CUDA tensor launches the kernel built for `mode`, or
    raises. Counts its calls in `launches`, and by mode in `mode_launches`."""
    _check_mode(mode, TF32_MODES)
    args = dict(an_scale=an_scale, an_bias=an_bias, ortho=ortho, w1y=w1y, b1=b1, wm=wm, bm=bm,
                wout=wout, bout=bout)
    _check_train_args(dz, h_proj, args)
    S, B, size = bound.shape
    if tuple(bound.shape) != (h_proj.shape[0], *dz.shape) or tuple(dld.shape) != (dz.shape[0],):
        raise ValueError(f"fused_flow_train_bwd: bound {tuple(bound.shape)}, dz {tuple(dz.shape)} and "
                         f"dld {tuple(dld.shape)} do not match h_proj {tuple(h_proj.shape)}")
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
    _train_bwd_parts(bound, h_proj, dz, dld, args, grads, BWD_ROWS | BWD_WEIGHT_GRADS | BWD_ACTNORM, mode)
    fused_flow_train_bwd.launches += 1
    fused_flow_train_bwd.mode_launches[mode] += 1
    return grads


def _train_bwd_parts(bound: torch.Tensor, h_proj: torch.Tensor, dz: torch.Tensor, dld: torch.Tensor,
                     args: dict[str, torch.Tensor], grads: tuple[torch.Tensor, ...], parts: int,
                     mode: str = MODE_3XTF32) -> None:
    """Launch K2b's parts on checked CUDA tensors into `grads`, uncounted:
    per step the rows kernel (`BWD_ROWS`, with the copy of dz that starts
    the carried dx) and the weight-grad pass (`BWD_WEIGHT_GRADS`), then the
    ActNorm grads (`BWD_ACTNORM`). The wrapper runs all three; chip_smoke.py
    times each alone."""
    from bcnf_tpu_torch.ops._build import load_library

    lib = load_library(_train_library("flow_train_kernel", mode))
    S, B, size = bound.shape
    Hp = h_proj.shape[-1]
    d_a, nh = args["w1y"].shape[1], args["wm"].shape[1]
    scratch = torch.empty((lib.bcnf_flow_train_bwd_scratch(B, S, size, d_a, nh, Hp),),
                          dtype=torch.float32, device=dz.device)
    with torch.cuda.device(dz.device):
        err = lib.bcnf_flow_train_bwd(
            *_ptrs(bound, h_proj, dz, dld, *args.values(), *grads, scratch),
            B, S, size, d_a, nh, Hp, parts, _stream(),
        )
    _raise_on(err, lib, "fused_flow_train_bwd")


fused_flow_train_bwd.launches = 0  # type: ignore[attr-defined]
fused_flow_train_bwd.mode_launches = collections.Counter()  # type: ignore[attr-defined]


class _FusedFlowTrain(torch.autograd.Function):
    """K2a forward, K2b backward: the custom VJP of the JAX package
    (`bcnf_tpu/ops/flow_kernel.py:653-672`), both in the kernel mode given
    first (the backward runs in the forward's mode, whatever the context it
    runs in). The mixes get zero grads."""

    @staticmethod
    def forward(ctx: Any, mode: str, x: torch.Tensor, h_proj: torch.Tensor,
                *args: torch.Tensor) -> tuple[torch.Tensor, ...]:
        z, ld, bound = fused_flow_train_fwd(x, h_proj, *args, mode=mode)
        ctx.save_for_backward(bound, h_proj, *args)
        ctx.mode = mode
        return z, ld

    @staticmethod
    def backward(ctx: Any, dz: torch.Tensor, dld: torch.Tensor) -> tuple[torch.Tensor | None, ...]:
        bound, h_proj, *args = ctx.saved_tensors  # an unused output's cotangent arrives as zeros
        dx, dhp, dan_s, dan_b, dw1y, db1, dwm, dbm, dwout, dbout = fused_flow_train_bwd(
            bound, h_proj, dz.contiguous(), dld.contiguous(), *args, mode=ctx.mode)
        return None, dx, dhp, dan_s, dan_b, torch.zeros_like(args[2]), dw1y, db1, dwm, dbm, dwout, dbout


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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable `(z, logdet)` of the whole flow for training
    (`bcnf_tpu/ops/flow_kernel.py::fused_flow_train`): K2a forward, K2b
    backward, both in `mode` (3xTF32 or one TF32 pass). Arguments as
    `stack_flow_params`/`pad_hidden` give them, with one condition row per
    row of `x` (h_proj is (S, B, Hp)); raises otherwise."""
    return _FusedFlowTrain.apply(mode, x, h_proj, an_scale, an_bias, ortho, w1y, b1, wm, bm, wout, bout)
