"""The `DualDomainLSTM` feature network: one LSTM over the trajectory and
one over its real FFT along time (real and imaginary parts side by side),
each pooled over time, then an MLP (GELU and dropout between its layers)."""

import torch

from benchmark import work
from benchmark.reference.model import dropout, gelu, linear, lstm, pool


def encode(kwargs, params, x, generator=None):
    rate, how = float(kwargs.get("dropout", 0.0)), kwargs.get("pooling", "mean")
    h_time = lstm(params["time"], x, rate, generator)
    f = torch.fft.rfft(x, dim=1)
    h_freq = lstm(params["freq"], torch.cat([f.real, f.imag], dim=-1), rate, generator)
    x = torch.cat([pool(h_time, how), pool(h_freq, how)], dim=-1)
    fc, fc_rate = params["fc"]["layers"], float(kwargs.get("fc_dropout", 0.0))
    for q in fc[:-1]:
        x = dropout(generator, gelu(linear(q, x)), fc_rate)
    return linear(fc[-1], x)


def flops(kwargs, frames, rows):
    dirs = 2 if kwargs.get("bidirectional") else 1
    H, F, layers = kwargs["hidden_size"], kwargs["input_size"], kwargs.get("num_layers", 1)
    total = work.lstm_flops(F, H, layers, dirs, frames, rows) + work.lstm_flops(2 * F, H, layers, dirs,
                                                                                 frames // 2 + 1, rows)
    sizes = [2 * dirs * H] + list(kwargs["fc_sizes"])
    return total + 2.0 * rows * sum(a * b for a, b in zip(sizes, sizes[1:]))
