"""The conditional RealNVP in plain PyTorch, and the pieces its encoders
(`encoders/<type>.py`) are made of.

Weights come as the benchmark's tree: a linear layer ``{"w": (in, out),
"b": (out,)}`` applied as ``x @ w + b``; an LSTM cell ``{"w_ih", "w_hh",
"b_ih", "b_hh"}`` with gates i, f, g, o; the flow's inner blocks stacked on
a leading axis (``blocks.coupling.a.layers[l].w`` is (K, in, out)), the final
coupling apart. The conditioner's first layer takes ``[y_a, h]``; its
condition part ``h @ W1[d_a:]`` is computed once a condition row. Dropout
is inverted dropout drawn with ``torch.rand`` from the generator given, one
draw a layer in the order the layers run: the encoder's between LSTM layers,
then each step's after each hidden layer.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def float32_products() -> Iterator[None]:
    """cuBLAS and cuDNN in float32: TF32 off inside, restored on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU in its tanh form, the form the published model trains with."""
    return F.gelu(x, approximate="tanh")


def dropout(generator: torch.Generator | None, x: torch.Tensor, rate: float) -> torch.Tensor:
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=generator.device) < keep
    return torch.where(mask.to(x.device), x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


# -- encoders ----------------------------------------------------------------


def lstm_direction(cell: dict, x: torch.Tensor, reverse: bool) -> torch.Tensor:
    """One direction over (B, T, F) as a time loop; returns (B, T, H)."""
    H = cell["w_hh"].shape[0]
    steps = (x @ cell["w_ih"] + cell["b_ih"] + cell["b_hh"]).unbind(1)
    h = x.new_zeros((x.shape[0], H))
    c = x.new_zeros((x.shape[0], H))
    out: list[torch.Tensor] = [h] * len(steps)
    for t in (range(len(steps) - 1, -1, -1) if reverse else range(len(steps))):
        i, f, g, o = torch.chunk(steps[t] + h @ cell["w_hh"], 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[t] = h
    return torch.stack(out, dim=1)


def lstm(params: dict, x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """A multi-layer, optionally bidirectional LSTM with dropout between
    layers; (B, T, F) to (B, T, H * directions)."""
    layers = params["layers"]
    for li, layer in enumerate(layers):
        out = lstm_direction(layer["fwd"], x, reverse=False)
        if "bwd" in layer:
            out = torch.cat([out, lstm_direction(layer["bwd"], x, reverse=True)], dim=-1)
        if li < len(layers) - 1:
            out = dropout(generator, out, rate)
        x = out
    return x


def pool(x: torch.Tensor, how: str) -> torch.Tensor:
    return x.mean(dim=1) if how == "mean" else x.amax(dim=1)


def encode(feature_networks: list[dict], params: dict, condition: torch.Tensor,
           generator: torch.Generator | None = None) -> torch.Tensor:
    """The feature-network stack over one condition (trajectories (B, T, F)),
    each network in turn by its plain encoder (`encoders/<type>.py`)."""
    from benchmark.reference import encoders

    x = condition
    for spec, p in zip(feature_networks, params["nets"]):
        x = encoders.find(spec["type"]).encode(spec.get("kwargs") or {}, p, x, generator)
    return x


# -- the flow -----------------------------------------------------------------


class Flow:
    """The flow of one weight tree: K inner blocks [ActNorm, coupling, mix]
    and a final coupling, every coupling affine with a tanh-bounded log
    scale, its conditioner an MLP over [y_a, h] with GELU between layers."""

    def __init__(self, params: dict, size: int, dropout_rate: float = 0.0) -> None:
        self.size, self.d_a = size, math.ceil(size / 2)
        self.rate = dropout_rate
        blocks = params["blocks"]
        self.K = blocks["ortho"].shape[0]
        inner = blocks["coupling"]["a"]["layers"]
        final = params["final"]["a"]["layers"]
        # step k's conditioner layers; step K is the final coupling
        self.steps = [[{"w": l["w"][k], "b": l["b"][k]} for l in inner] for k in range(self.K)] + [final]
        self.ortho = blocks["ortho"]
        an = blocks.get("actnorm")
        self.an_scale = an["scale"] if an is not None else None
        self.an_bias = an["bias"] if an is not None else None

    def projections(self, h: torch.Tensor) -> list[torch.Tensor]:
        """Each step's h @ W1[d_a:], (N, H) a step."""
        return [h @ layers[0]["w"][self.d_a:] for layers in self.steps]

    def _coeffs(self, k: int, y_a: torch.Tensor, proj: torch.Tensor,
                generator: torch.Generator | None) -> tuple[torch.Tensor, torch.Tensor]:
        layers = self.steps[k]
        x = y_a @ layers[0]["w"][: self.d_a] + layers[0]["b"] + proj
        for i in range(len(layers) - 1):
            if i > 0:
                x = linear(layers[i], x)
            x = dropout(generator, gelu(x), self.rate)
        t, s = torch.chunk(linear(layers[-1], x), 2, dim=-1)
        return t, torch.tanh(s)

    def inverse(self, z: torch.Tensor, projs: list[torch.Tensor]) -> torch.Tensor:
        """Rows z (R, size) to theta, row r conditioned on `projs[k][r]`."""
        for k in range(self.K, -1, -1):
            if k < self.K:
                z = z @ self.ortho[k].T
            z_a, z_b = z[:, : self.d_a], z[:, self.d_a:]
            t, s = self._coeffs(k, z_a, projs[k], None)
            z = torch.cat([z_a, (z_b - t) * torch.exp(-s)], dim=-1)
            if k < self.K and self.an_scale is not None:
                z = (z - self.an_bias[k]) / self.an_scale[k]
        return z

    def forward(self, y: torch.Tensor, projs: list[torch.Tensor],
                generator: torch.Generator | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """Rows y (B, size) to (z, log|det J|), row b conditioned on `projs[k][b]`."""
        log_det = y.new_zeros(y.shape[0])
        for k in range(self.K + 1):
            if k < self.K and self.an_scale is not None:
                y = y * self.an_scale[k] + self.an_bias[k]
                log_det = log_det + torch.sum(torch.log(torch.abs(self.an_scale[k])))
            y_a, y_b = y[:, : self.d_a], y[:, self.d_a:]
            t, s = self._coeffs(k, y_a, projs[k], generator)
            y = torch.cat([y_a, torch.exp(s) * y_b + t], dim=-1)
            log_det = log_det + torch.sum(s, dim=-1)
            if k < self.K:
                y = y @ self.ortho[k]
        return y, log_det


def nll(z: torch.Tensor, log_det: torch.Tensor) -> torch.Tensor:
    """The mean negative log-likelihood without its constant, the published
    training loss."""
    return torch.mean(0.5 * torch.sum(z * z, dim=1) - log_det)
