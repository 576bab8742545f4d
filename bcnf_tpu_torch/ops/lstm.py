"""LSTM (port of `bcnf_tpu/ops/lstm.py`): a plain time loop, or the fused
recurrence kernels.

The input projection ``x @ W_ih`` for all timesteps is one matmul before the
loop (`_direction_scan`, `bcnf_tpu/ops/lstm.py:53-71`); each step then does one
``(B, H) @ (H, 4H)`` matmul. The JAX package runs this outside any Pallas
kernel by default (`ops/lstm.py:27-38`), and the port's time loop is its
counterpart (plain `torch.matmul`). On a CUDA tensor each direction runs
through `ops/lstm_kernel.fused_direction` instead (K3a forward, K3b
backward), as the JAX package routes it under ``BCNF_FUSED_LSTM=1``
(`ops/lstm.py:74-83`); `_fused_enabled` says when. Weights are ``(in, 4H)``
with gate order ``i, f, g, o``.
"""

from __future__ import annotations

import math
import os

import torch

from bcnf_tpu_torch.ops.nn import Params, dropout, uniform


def lstm_cell_init(generator: torch.Generator, input_size: int, hidden_size: int) -> Params:
    k = 1.0 / math.sqrt(hidden_size)
    return {
        "w_ih": uniform(generator, (input_size, 4 * hidden_size), k),
        "w_hh": uniform(generator, (hidden_size, 4 * hidden_size), k),
        "b_ih": uniform(generator, (4 * hidden_size,), k),
        "b_hh": uniform(generator, (4 * hidden_size,), k),
    }


def _fused_enabled(device: torch.device) -> bool:
    """Gate for the fused recurrence (`ops/lstm_kernel.py`) on a tensor of
    `device`: ``BCNF_FUSED_LSTM=1`` takes it and ``0`` (or any other value)
    keeps the time loop, on any device; unset, a CUDA tensor takes the
    kernels and a CPU tensor the loop, so the CPU computes what JAX's
    default computes.

    The default is the card's measurement, not the JAX package's (whose gate
    is off by a measurement of its own accelerator, `bcnf_tpu/ops/lstm.py:27-38`):
    on an H100 the kernels beat the time loop at every published
    configuration `chip_smoke.py` times (PERF.md, the fused LSTM's table)."""
    flag = os.environ.get("BCNF_FUSED_LSTM", "")
    if flag:
        return flag == "1"
    return device.type == "cuda"


def _direction_scan(params: Params, x: torch.Tensor, hidden_size: int, reverse: bool) -> torch.Tensor:
    """Run one direction over `(B, T, F)` as a time loop; returns `(B, T, H)`."""
    B, T = x.shape[0], x.shape[1]
    # the steps' slices are taken at once: indexing `x_proj[:, t]` would make
    # autograd add a zero-filled (B, T, 4H) grad per step in the backward
    x_steps = (x @ params["w_ih"] + params["b_ih"] + params["b_hh"]).unbind(1)  # T x (B, 4H)
    h = x.new_zeros((B, hidden_size))
    c = x.new_zeros((B, hidden_size))
    hs: list[torch.Tensor] = [h] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = x_steps[t] + h @ params["w_hh"]
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs[t] = h
    return torch.stack(hs, dim=1)


def _direction(params: Params, x: torch.Tensor, hidden_size: int, reverse: bool) -> torch.Tensor:
    """One LSTM direction: the fused recurrence where `_fused_enabled` says
    so for `x`'s device, else the time loop. The fused kernels take any
    batch, so no batch falls back (the JAX kernel needs one that tiles)."""
    if _fused_enabled(x.device):
        from bcnf_tpu_torch.ops.lstm_kernel import fused_direction

        return fused_direction(params, x, hidden_size, reverse)
    return _direction_scan(params, x, hidden_size, reverse)


def lstm_init(
    generator: torch.Generator,
    input_size: int,
    hidden_size: int,
    num_layers: int,
    bidirectional: bool = False,
) -> Params:
    """Multi-layer (optionally bidirectional) LSTM parameters."""
    layers = []
    in_dim = input_size
    for _ in range(num_layers):
        layer = {"fwd": lstm_cell_init(generator, in_dim, hidden_size)}
        if bidirectional:
            layer["bwd"] = lstm_cell_init(generator, in_dim, hidden_size)
        layers.append(layer)
        in_dim = hidden_size * (2 if bidirectional else 1)
    return {"layers": layers}


def lstm_apply(
    params: Params,
    x: torch.Tensor,
    hidden_size: int,
    dropout_rate: float = 0.0,
    generator: torch.Generator | None = None,
    train: bool = False,
) -> torch.Tensor:
    """Apply the LSTM to `(B, T, F)`; returns `(B, T, H*dirs)`. Inter-layer
    dropout matches torch `nn.LSTM(dropout=...)`: every layer but the last."""
    n = len(params["layers"])
    for li, layer in enumerate(params["layers"]):
        out = _direction(layer["fwd"], x, hidden_size, reverse=False)
        if "bwd" in layer:
            back = _direction(layer["bwd"], x, hidden_size, reverse=True)
            out = torch.cat([out, back], dim=-1)
        if li < n - 1 and dropout_rate > 0.0:
            out = dropout(generator, out, dropout_rate, train)
        x = out
    return x
