"""The `LSTM` feature network: a (bidirectional) multi-layer LSTM with
dropout between its layers, a linear layer on every step's output, then
pooled over time; (B, T, F) to (B, output_size)."""

from benchmark import work
from benchmark.reference.model import linear, lstm, pool


def encode(kwargs, params, x, generator=None):
    out = lstm(params["lstm"], x, float(kwargs.get("dropout", 0.0)), generator)
    return pool(linear(params["linear"], out), kwargs.get("pooling", "mean"))


def flops(kwargs, frames, rows):
    dirs = 2 if kwargs.get("bidirectional") else 1
    H = kwargs["hidden_size"]
    return (work.lstm_flops(kwargs["input_size"], H, kwargs["num_layers"], dirs, frames, rows)
            + 2.0 * rows * frames * dirs * H * kwargs["output_size"])
