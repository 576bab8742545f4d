"""One LSTM direction's recurrence in CUDA kernels: host side.

K3a, `lstm_direction_fwd`, replaces `bcnf_tpu/ops/lstm_kernel.py::run_fwd`
(the Pallas TPU kernel `_fwd_kernel`); K3b, `lstm_direction_bwd`, replaces
`run_bwd` (`_bwd_kernel`). Both kernels are in `csrc/lstm_kernel.cu`.
`_FusedLSTMDirection` is the custom VJP of the JAX package
(`lstm_kernel.py:177-191`) as a `torch.autograd.Function`, and
`fused_direction` the counterpart of its `fused_direction`: the input
projection ``x @ W_ih + b_ih + b_hh`` is one `torch.matmul` outside the
kernels, as JAX leaves it to XLA, so its grads come from autograd.

Layout contract (the JAX kernel's): time-major ``xp (T, B, 4H)`` with gate
order i, f, g, o; ``W_hh (H, 4H)``; ``hs, cs (T, B, H)``, float32. Unlike
the TPU kernel there is no batch-tiling rule: the kernels mask the ragged
last tile, so every batch runs (JAX falls back to its scan where ``B`` does
not tile, `lstm_kernel.py:208-211`).

This module checks the kernels' arguments, launches them on PyTorch's
current stream, and holds their plain PyTorch versions
(`lstm_direction_fwd_reference`, `lstm_direction_bwd_reference`), which
serve CPU tensors (the tests) and which `chip_smoke.py` holds the kernels
against on the card.
"""

from __future__ import annotations

import ctypes
from collections.abc import Callable
from typing import Any

import torch
import torch.nn.functional as F

from bcnf_tpu_torch.ops.flow_kernel import _ptrs, _raise_on, padded_width

# The kernels pad each gate to Hp = 32 * TN units, split over a cluster of
# 8 blocks; these are the TN they are compiled for (`csrc/lstm_kernel.cu`).
LSTM_KERNEL_TN = (1, 2, 3, 4, 5, 6, 7, 8)


def pad_gates(w_hh: torch.Tensor, Hp: int) -> torch.Tensor:
    """`W_hh (H, 4H)` zero-padded to `(Hp, 4Hp)`, each gate block on its own,
    so gate g's unit j stays in column ``g*Hp + j``. Exact: padded units see
    zero weights and a zero projection, so their c = 0.5*0 + 0.5*tanh(0) = 0
    and h = 0 at every step, and their zero rows add nothing."""
    H = w_hh.shape[0]
    p = Hp - H
    return F.pad(w_hh.reshape(H, 4, H), (0, p, 0, 0, 0, p)).reshape(Hp, 4 * Hp)


def _gate_math(gates: torch.Tensor, c_prev: torch.Tensor, H: int) -> tuple[torch.Tensor, ...]:
    """`_gate_math` of the JAX kernel (`lstm_kernel.py:36-43`)."""
    i = torch.sigmoid(gates[:, :H])
    f = torch.sigmoid(gates[:, H: 2 * H])
    g = torch.tanh(gates[:, 2 * H: 3 * H])
    o = torch.sigmoid(gates[:, 3 * H:])
    c = f * c_prev + i * g
    return i, f, g, o, c, o * torch.tanh(c)


def lstm_direction_fwd_reference(xp: torch.Tensor, w_hh: torch.Tensor, reverse: bool, *,
                                 mm: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = torch.matmul,
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3a (`_fwd_kernel`, `lstm_kernel.py:46-62`):
    `(hs, cs)`, each `(T, B, H)`. `mm` takes the step products (the tests
    pass `tf32.matmul_3xtf32`, the kernel's tensor-core arithmetic)."""
    T, B, G = xp.shape
    H = G // 4
    h = xp.new_zeros((B, H))
    c = xp.new_zeros((B, H))
    hs, cs = [h] * T, [c] * T
    for tau in range(T):
        t = T - 1 - tau if reverse else tau
        _, _, _, _, c, h = _gate_math(xp[t] + mm(h, w_hh), c, H)
        hs[t], cs[t] = h, c
    return torch.stack(hs), torch.stack(cs)


def lstm_direction_bwd_reference(xp: torch.Tensor, w_hh: torch.Tensor, hs: torch.Tensor, cs: torch.Tensor,
                                 dhs: torch.Tensor, reverse: bool, *,
                                 mm: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = torch.matmul,
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3b, output by output as `_bwd_kernel`
    (`lstm_kernel.py:65-114`): walks the steps in the opposite order of the
    forward, recomputes each step's gates from the saved `h_prev`, `c_prev`
    (zeros at the forward's first step), and returns `(dxp, dW_hh)`. `mm`
    takes every product (the tests pass `tf32.matmul_3xtf32`, the kernel's
    tensor-core arithmetic)."""
    T, B, G = xp.shape
    H = G // 4
    dxp = torch.empty_like(xp)
    dw_hh = w_hh.new_zeros((H, G))
    dh_next = xp.new_zeros((B, H))
    dc_next = xp.new_zeros((B, H))
    zeros = xp.new_zeros((B, H))
    for tau in range(T):
        t = tau if reverse else T - 1 - tau
        first = t == (T - 1 if reverse else 0)  # the forward's first step
        t_prev = t + 1 if reverse else t - 1
        h_prev = zeros if first else hs[t_prev]
        c_prev = zeros if first else cs[t_prev]
        i, f, g, o, c, _ = _gate_math(xp[t] + mm(h_prev, w_hh), c_prev, H)
        tanh_c = torch.tanh(c)
        dh = dhs[t] + dh_next
        do = dh * tanh_c
        dc = dh * o * (1.0 - tanh_c * tanh_c) + dc_next
        dgates = torch.cat([dc * g * i * (1.0 - i), dc * c_prev * f * (1.0 - f),
                            dc * i * (1.0 - g * g), do * o * (1.0 - o)], dim=-1)
        dxp[t] = dgates
        dh_next = mm(dgates, w_hh.T)
        dc_next = dc * f
        dw_hh = dw_hh + mm(h_prev.T, dgates)
    return dxp, dw_hh


def _check(what: str, tensors: dict[str, torch.Tensor], shapes: dict[str, tuple[int, ...]]) -> None:
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, the others on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {shapes[name]}")


def _shapes(xp: torch.Tensor) -> tuple[int, int, int]:
    if xp.dim() != 3 or xp.shape[2] % 4:
        raise ValueError(f"xp must be time-major (T, B, 4H), got {tuple(xp.shape)}")
    T, B, G = xp.shape
    return T, B, G // 4


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def lstm_direction_fwd(xp: torch.Tensor, w_hh: torch.Tensor, reverse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """K3a: `(hs, cs)` of one direction in one launch (the kernel pads and
    orders W_hh's columns itself as it loads them). A CPU tensor takes
    `lstm_direction_fwd_reference`; a CUDA tensor launches the kernel (or
    raises)."""
    T, B, H = _shapes(xp)
    if xp.device.type == "cpu":
        return lstm_direction_fwd_reference(xp, w_hh, reverse)
    if xp.device.type != "cuda":
        raise ValueError(f"lstm_direction_fwd runs on CPU or CUDA tensors, not {xp.device}")
    _check("lstm_direction_fwd", {"xp": xp, "w_hh": w_hh}, {"xp": (T, B, 4 * H), "w_hh": (H, 4 * H)})
    Hp = padded_width(H, LSTM_KERNEL_TN)

    from bcnf_tpu_torch.ops._build import load_library

    lib = load_library("lstm_kernel")
    hs = torch.empty((T, B, H), dtype=xp.dtype, device=xp.device)
    cs = torch.empty_like(hs)
    if hs.numel() == 0:
        return hs, cs
    with torch.cuda.device(xp.device):
        err = lib.bcnf_lstm_fwd(*_ptrs(xp, w_hh, hs, cs), T, B, H, Hp, int(reverse), _stream())
    _raise_on(err, lib, "lstm_direction_fwd")
    lstm_direction_fwd.launches += 1
    return hs, cs


lstm_direction_fwd.launches = 0  # type: ignore[attr-defined]


def fwd_layout(B: int, H: int, device: torch.device) -> dict[str, int]:
    """K3a's launch at batch B and hidden size H on a card: rows a cluster,
    clusters, the clusters the card holds at once, and so the waves."""
    from bcnf_tpu_torch.ops._build import load_library

    lib = load_library("lstm_kernel")
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        _raise_on(lib.bcnf_lstm_fwd_layout(B, padded_width(H, LSTM_KERNEL_TN), out), lib, "lstm_direction_fwd layout")
    rows, clusters, active = out
    return {"rows": rows, "clusters": clusters, "resident_clusters": active,
            "waves": -(-clusters // active) if active else 0}


BWD_RECURRENCE, BWD_DW = 1, 2  # K3b's parts


def lstm_direction_bwd(xp: torch.Tensor, w_hh: torch.Tensor, hs: torch.Tensor, cs: torch.Tensor,
                       dhs: torch.Tensor, reverse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """K3b: `(dxp, dW_hh)` of one direction, in its two parts (the
    recurrence, then the deterministic AᵀB pass for `dW_hh` and the
    fixed-order sum of its row chunks, `csrc/lstm_kernel.cu`), counted as
    one call. A CPU tensor takes
    `lstm_direction_bwd_reference`; a CUDA tensor launches the kernels (or
    raises)."""
    T, B, H = _shapes(xp)
    if xp.device.type == "cpu":
        return lstm_direction_bwd_reference(xp, w_hh, hs, cs, dhs, reverse)
    if xp.device.type != "cuda":
        raise ValueError(f"lstm_direction_bwd runs on CPU or CUDA tensors, not {xp.device}")
    seq = (T, B, H)
    _check("lstm_direction_bwd", {"xp": xp, "w_hh": w_hh, "hs": hs, "cs": cs, "dhs": dhs},
           {"xp": (T, B, 4 * H), "w_hh": (H, 4 * H), "hs": seq, "cs": seq, "dhs": seq})
    dxp = torch.empty_like(xp)
    dw_hh = torch.empty_like(w_hh)
    if xp.numel() == 0:
        return dxp, dw_hh.zero_()
    _bwd_parts(xp, w_hh, hs, cs, dhs, reverse, dxp, dw_hh, BWD_RECURRENCE | BWD_DW)
    lstm_direction_bwd.launches += 1
    return dxp, dw_hh


def _bwd_parts(xp: torch.Tensor, w_hh: torch.Tensor, hs: torch.Tensor, cs: torch.Tensor, dhs: torch.Tensor,
               reverse: bool, dxp: torch.Tensor, dw_hh: torch.Tensor, parts: int) -> None:
    """Launch K3b's parts on checked CUDA tensors, uncounted: the recurrence
    (`BWD_RECURRENCE`: dxp) and the dW_hh pass (`BWD_DW`: from hs and dxp).
    The wrapper runs both; chip_smoke.py times each alone."""
    from bcnf_tpu_torch.ops._build import load_library

    T, B, H = _shapes(xp)
    lib = load_library("lstm_kernel")
    with torch.cuda.device(xp.device):
        if parts & BWD_RECURRENCE:
            Hp = padded_width(H, LSTM_KERNEL_TN)
            err = lib.bcnf_lstm_bwd_rec(*_ptrs(xp, pad_gates(w_hh, Hp), hs, cs, dhs, dxp), T, B, H, Hp,
                                        int(reverse), _stream())
            _raise_on(err, lib, "lstm_direction_bwd (recurrence)")
        if parts & BWD_DW:
            scratch = torch.empty((lib.bcnf_lstm_bwd_scratch(T, B, H),), dtype=torch.float32, device=xp.device)
            err = lib.bcnf_lstm_bwd_dw(*_ptrs(hs, dxp, dw_hh, scratch), T, B, H, int(reverse), _stream())
            _raise_on(err, lib, "lstm_direction_bwd (dW_hh)")


lstm_direction_bwd.launches = 0  # type: ignore[attr-defined]


class _FusedLSTMDirection(torch.autograd.Function):
    """K3a forward, K3b backward over `(xp, W_hh)`: the custom VJP of the JAX
    package (`lstm_kernel.py:177-191`), which saves `xp, W_hh, hs, cs`."""

    @staticmethod
    def forward(ctx: Any, xp: torch.Tensor, w_hh: torch.Tensor, reverse: bool) -> torch.Tensor:
        hs, cs = lstm_direction_fwd(xp, w_hh, reverse)
        ctx.save_for_backward(xp, w_hh, hs, cs)
        ctx.reverse = reverse
        return hs

    @staticmethod
    def backward(ctx: Any, dhs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, None]:
        xp, w_hh, hs, cs = ctx.saved_tensors
        dxp, dw_hh = lstm_direction_bwd(xp, w_hh, hs, cs, dhs.contiguous(), ctx.reverse)
        return dxp, dw_hh, None


def fused_direction(params: dict, x: torch.Tensor, hidden_size: int, reverse: bool) -> torch.Tensor:
    """The fused counterpart of `ops/lstm._direction_scan`: `(B, T, F)` ->
    `(B, T, H)` (`bcnf_tpu/ops/lstm_kernel.py:195-216`). The hoisted input
    projection is computed time-major, `(T, B, 4H)`, by one matmul."""
    if params["w_hh"].shape != (hidden_size, 4 * hidden_size):
        raise ValueError(f"w_hh has shape {tuple(params['w_hh'].shape)} for hidden size {hidden_size}")
    xp = torch.matmul(x.transpose(0, 1), params["w_ih"]) + params["b_ih"] + params["b_hh"]
    return _FusedLSTMDirection.apply(xp.contiguous(), params["w_hh"].contiguous(), reverse).transpose(0, 1)
