"""Conditioner (feature) networks of the port (`bcnf_tpu/models/feature_network.py`).

Each network is a static-config object with ``init(generator) -> params``
and ``apply(params, x, generator=None, train=False) -> features``; the stack
consumes one raw condition per `ConcatenateCondition` marker, as the
reference does (`feature_network.py:46-69`).

`LSTMFeatureNetwork` pools over the **time** axis: the SURVEY.md Q1 fix the
JAX package carries (`bcnf_tpu/models/feature_network.py:188-229`).
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from bcnf_tpu_torch.ops.lstm import lstm_apply, lstm_init
from bcnf_tpu_torch.ops.nn import Params, linear_apply, linear_init


class FeatureNetwork:
    """Base: static config + init/apply (reference `feature_network.py:10-25`)."""

    input_size: Any = None
    output_size: Any = None

    def init(self, generator: torch.Generator) -> Params:
        return {}

    def apply(self, params: Params, x: torch.Tensor, generator: torch.Generator | None = None,
              train: bool = False) -> torch.Tensor:
        raise NotImplementedError


class Identity(FeatureNetwork):
    """`None` feature-network placeholder (reference `factories.py:55-56`)."""

    def apply(self, params: Params, x: torch.Tensor, generator: torch.Generator | None = None,
              train: bool = False) -> torch.Tensor:
        return x


class ConcatenateCondition(FeatureNetwork):
    """Marker that consumes one raw condition and concatenates it to the
    current features (reference `feature_network.py:76-88`)."""

    def __init__(self, input_size: int | None = None, output_size: int | None = None, dim: int = -1) -> None:
        self.input_size = input_size
        self.output_size = output_size
        self.dim = dim

    def apply(self, params: Params, x: torch.Tensor, generator: torch.Generator | None = None,
              train: bool = False) -> torch.Tensor:
        return x


class FeatureNetworkStack(FeatureNetwork):
    """Sequential composition of feature networks (reference `feature_network.py:28-73`)."""

    def __init__(self, feature_networks: Sequence[FeatureNetwork | None] | None) -> None:
        if feature_networks is None or all(fn is None for fn in feature_networks):
            raise ValueError("Feature network stack must contain at least one feature network.")
        self.feature_networks = [fn for fn in feature_networks if fn is not None]
        self.n_distinct_conditions = sum(
            1 for fn in self.feature_networks if isinstance(fn, ConcatenateCondition)
        )
        self.input_size = self.feature_networks[0].input_size
        self.output_size = self.feature_networks[-1].output_size

    def init(self, generator: torch.Generator) -> Params:
        return {"nets": [fn.init(generator) for fn in self.feature_networks]}

    def apply(self, params: Params, *conditions: torch.Tensor, generator: torch.Generator | None = None,
              train: bool = False) -> torch.Tensor:
        if len(conditions) != self.n_distinct_conditions:
            raise ValueError(
                f"Expected {self.n_distinct_conditions} conditions, but got {len(conditions)}."
            )
        consume = 0
        current: torch.Tensor | None = None
        for i, fn in enumerate(self.feature_networks):
            if isinstance(fn, ConcatenateCondition):
                cond = conditions[consume]
                x = cond if current is None else torch.cat([current, cond], dim=fn.dim)
                current = fn.apply(params["nets"][i], x, generator, train)
                consume += 1
            else:
                current = fn.apply(params["nets"][i], current, generator, train)
        return current


class LSTMFeatureNetwork(FeatureNetwork):
    """LSTM encoder with linear head + time pooling (reference `feature_network.py:148-178`)."""

    def __init__(
        self,
        input_size: int,
        hidden_size: int,
        output_size: int,
        num_layers: int,
        dropout: float = 0.0,
        bidirectional: bool = False,
        pooling: str = "mean",
    ) -> None:
        if pooling not in ("mean", "max"):
            raise ValueError(f'Pooling method {pooling} not supported. Use either "mean" or "max".')
        self.input_size = input_size
        self.output_size = output_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dropout_rate = dropout
        self.bidirectional = bidirectional
        self.pooling = pooling

    def init(self, generator: torch.Generator) -> Params:
        dirs = 2 if self.bidirectional else 1
        return {
            "lstm": lstm_init(generator, self.input_size, self.hidden_size, self.num_layers, self.bidirectional),
            "linear": linear_init(generator, self.hidden_size * dirs, self.output_size),
        }

    def apply(self, params: Params, x: torch.Tensor, generator: torch.Generator | None = None,
              train: bool = False) -> torch.Tensor:
        h = lstm_apply(params["lstm"], x, self.hidden_size, self.dropout_rate, generator, train)
        h = linear_apply(params["linear"], h)  # (B, T, out)
        if self.pooling == "mean":
            return h.mean(dim=1)
        return h.amax(dim=1)
