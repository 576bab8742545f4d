"""CNN video-frame conditioner (port of `bcnf_tpu/models/cnn.py`, reference
`src/bcnf/models/cnn.py:7-117`).

Encodes `(B, n_cams, T, H, W)` grayscale videos into per-frame features
`(B, T, output_size_lin)` for a downstream sequence network
(`configs/runs/videos_CNN_LSTM_large.yaml`). The JAX module's design is kept:

- every camera and frame is folded into one conv batch (one tower), or each
  camera goes through its own tower (`num_CNN` > 1);
- the layer plan copies the reference's padding formula
  (``((s-1)*size - s + k) // 2``) with its index quirk: the padding of layer
  i+1 comes from `strides[i]`/`kernel_sizes[i]`, its conv from
  `kernel_sizes[i+1]`/`strides[i+1]`, so the feature shapes are the JAX
  package's;
- each conv is followed by ReLU, dropout and a 2x2 max-pool; the head's
  input is `final_output_size * 2`, the reference's hard-coded two-camera
  factor.

The convolutions are `F.conv2d` (cuDNN on the card) and the pooling
`F.max_pool2d`: the JAX package computes them outside any Pallas kernel, with
XLA's conv or, in training, an im2col product that only works around a TPU
compile time. One conv path serves both; the tests hold it against both
JAX branches. Weights are OIHW, torch's layout and JAX's, so the bridge
copies them as they are.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from bcnf_tpu_torch.models.feature_network import FeatureNetwork
from bcnf_tpu_torch.ops.nn import Params, dropout, linear_apply, linear_init, uniform


def _conv_init(generator: torch.Generator, c_in: int, c_out: int, k: int) -> Params:
    """torch's `nn.Conv2d` default: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(c_in * k * k)
    return {"w": uniform(generator, (c_out, c_in, k, k), bound), "b": uniform(generator, (c_out,), bound)}


class CNN(FeatureNetwork):
    def __init__(
        self,
        hidden_channels: Sequence[int],
        kernel_sizes: Sequence[int],
        strides: Sequence[int],
        output_size_lin: int,
        output_size: int,
        image_input_size: tuple[int, int] = (90, 160),
        dropout_prob: float = 0.5,
        num_CNN: int = 1,
        verbose: bool = False,
    ) -> None:
        self.input_size = tuple(image_input_size)
        self.output_size = output_size  # the reference keeps the ctor arg (`cnn.py:22`)
        self.output_size_lin = output_size_lin
        self.hidden_channels = list(hidden_channels)
        self.kernel_sizes = list(kernel_sizes)
        self.strides = list(strides)
        self.dropout_prob = dropout_prob
        self.num_CNN = num_CNN

        # the layer plan (c_in, c_out, kernel, stride, padding) and the
        # feature-map shapes, as `bcnf_tpu/models/cnn.py:116-140` computes them
        h, w = image_input_size
        self.plan: list[tuple[int, int, int, int, tuple[int, int]]] = []
        c_in = 1
        s0, k0 = self.strides[0], self.kernel_sizes[0]
        pad = (((s0 - 1) * h - s0 + k0) // 2, ((s0 - 1) * w - s0 + k0) // 2)
        self.plan.append((c_in, self.hidden_channels[0], k0, s0, pad))
        h = ((h + 2 * pad[0] - k0) // s0 + 1) // 2  # conv, then the 2x2 max-pool
        w = ((w + 2 * pad[1] - k0) // s0 + 1) // 2
        c_in = self.hidden_channels[0]
        for i in range(len(self.hidden_channels) - 1):
            # the reference's quirk: padding from strides[i]/kernel_sizes[i],
            # the conv from kernel_sizes[i+1]/strides[i+1]
            sp, kp = self.strides[i], self.kernel_sizes[i]
            pad = (((sp - 1) * h - sp + kp) // 2, ((sp - 1) * w - sp + kp) // 2)
            s, k = self.strides[i + 1], self.kernel_sizes[i + 1]
            self.plan.append((c_in, self.hidden_channels[i + 1], k, s, pad))
            h = ((h + 2 * pad[0] - k) // s + 1) // 2
            w = ((w + 2 * pad[1] - k) // s + 1) // 2
            c_in = self.hidden_channels[i + 1]
        self.final_output_size = c_in * h * w
        if verbose:
            print(f"CNN plan: {self.plan}, final feature size {self.final_output_size}")

    def init(self, generator: torch.Generator) -> Params:
        towers = [[_conv_init(generator, ci, co, k) for ci, co, k, _, _ in self.plan] for _ in range(self.num_CNN)]
        # the hard-coded two-camera fusion factor (reference `cnn.py:69`)
        return {"towers": towers, "head": linear_init(generator, self.final_output_size * 2, self.output_size_lin)}

    def _tower(self, tower: list[Params], x: torch.Tensor, generator: torch.Generator | None,
               train: bool) -> torch.Tensor:
        for p, (_, _, _, stride, pad) in zip(tower, self.plan):
            x = F.relu(F.conv2d(x, p["w"], p["b"], stride=stride, padding=pad))
            x = dropout(generator, x, self.dropout_prob, train)
            x = F.max_pool2d(x, 2)
        return x.reshape(x.shape[0], -1)

    def apply(self, params: Params, x: torch.Tensor, generator: torch.Generator | None = None,
              train: bool = False) -> torch.Tensor:
        """`(B, n_cams, T, H, W)` -> `(B, T, output_size_lin)` (reference `cnn.py:78-113`)."""
        B, n_cams, T, H, W = x.shape
        x = x.transpose(0, 1)  # (cams, B, T, H, W)
        if self.num_CNN > 1:
            y = torch.stack([self._tower(params["towers"][c], x[c].reshape(B * T, 1, H, W), generator, train)
                             for c in range(self.num_CNN)])  # (cams, B*T, F)
        else:
            y = self._tower(params["towers"][0], x.reshape(n_cams * B * T, 1, H, W), generator, train)
        y = y.reshape(n_cams, B, T, -1).permute(1, 2, 0, 3).reshape(B, T, -1)  # cameras concatenated per frame
        return linear_apply(params["head"], y)
