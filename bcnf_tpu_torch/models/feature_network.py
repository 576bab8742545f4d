"""Conditioner (feature) networks of the port (`bcnf_tpu/models/feature_network.py`).

Each network is a static-config object with ``init(generator) -> params``
and ``apply(params, x, generator=None, train=False) -> features``; the stack
consumes one raw condition per `ConcatenateCondition` marker, as the
reference does (`feature_network.py:46-69`).

`LSTMFeatureNetwork` pools over the **time** axis: the SURVEY.md Q1 fix the
JAX package carries (`bcnf_tpu/models/feature_network.py:188-229`). Every
LSTM here runs through `ops/lstm.lstm_apply`, so on a CUDA tensor each of
their directions runs on the fused recurrence kernels (``BCNF_FUSED_LSTM=0``
keeps the time loop; `ops/lstm._fused_enabled`). The Transformer's
positional embeddings are the JAX package's full-width ones (SURVEY.md Q10),
and `DualDomainFC` keeps its two documented divergences from the reference.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from bcnf_tpu_torch.ops.attention import (
    sinusoidal_positional_embeddings,
    transformer_block_apply,
    transformer_block_init,
)
from bcnf_tpu_torch.ops.lstm import lstm_apply, lstm_init
from bcnf_tpu_torch.ops.nn import Params, dropout, get_activation, linear_apply, linear_init


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


class FrExpFeatureNetwork(FeatureNetwork):
    """Mantissa/exponent split (reference `feature_network.py:91-111`;
    `bcnf_tpu/models/feature_network.py:118-132`): ``[mantissa, exponent]``,
    or ``[sign, |mantissa|, exponent]`` with `separate_sign`. It sits on
    data: no gradient flows through it. `torch.frexp` gives IEEE results for
    subnormal inputs, where `jnp.frexp` on the CPU flushes them
    (ROADMAP.md, differences by design)."""

    def __init__(self, input_size: int, separate_sign: bool = False) -> None:
        self.separate_sign = separate_sign
        self.input_size = input_size
        self.output_size = input_size * (2 + int(separate_sign))

    def apply(self, params: Params, x: torch.Tensor, generator: torch.Generator | None = None,
              train: bool = False) -> torch.Tensor:
        mantissa, exponent = torch.frexp(x.detach())
        exponent = exponent.to(x.dtype)
        if self.separate_sign:
            return torch.cat([torch.sign(mantissa), mantissa.abs(), exponent], dim=-1)
        return torch.cat([mantissa, exponent], dim=-1)


class FullyConnectedFeatureNetwork(FeatureNetwork):
    """MLP over the flattened input (reference `feature_network.py:114-145`;
    `bcnf_tpu/models/feature_network.py:135-185`). ``flatten=False`` applies
    it over the last axis only (per frame), the JAX package's form of the
    reference's legacy two-stage schema."""

    def __init__(
        self,
        sizes: Sequence[int],
        activation: str = "GELU",
        dropout: float = 0.0,
        batch_norm: bool = False,
        flatten: bool = True,
    ) -> None:
        if batch_norm:
            raise NotImplementedError("batch_norm is unused by all reference run configs and is not supported")
        self.sizes = list(sizes)
        self.input_size = self.sizes[0]
        self.output_size = self.sizes[-1]
        self.act = get_activation(activation if isinstance(activation, str) else "GELU")
        self.dropout_rate = dropout
        self.flatten = flatten

    def init(self, generator: torch.Generator) -> Params:
        return {"layers": [linear_init(generator, self.sizes[i], self.sizes[i + 1])
                           for i in range(len(self.sizes) - 1)]}

    def apply(self, params: Params, x: torch.Tensor, generator: torch.Generator | None = None,
              train: bool = False) -> torch.Tensor:
        if self.flatten:
            x = x.reshape(x.shape[0], -1)  # reference `:144`
        layers = params["layers"]
        if not layers:
            return x
        for p in layers[:-1]:
            x = dropout(generator, self.act(linear_apply(p, x)), self.dropout_rate, train)
        return linear_apply(layers[-1], x)


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


class Transformer(FeatureNetwork):
    """Transformer encoder with first-token readout (reference
    `feature_network.py:263-307`; `bcnf_tpu/models/feature_network.py:232-282`):
    embed, dropout, the optional positional embeddings, `n_blocks` post-norm
    blocks, dropout, then a linear layer on the first token."""

    def __init__(
        self,
        input_size: int,
        trf_size: int,
        n_heads: int,
        ff_size: int,
        n_blocks: int,
        output_size: int,
        dropout: float = 0.5,
        trf_dropout: float = 0.1,
        add_positional_embeddings: bool = False,
    ) -> None:
        self.input_size = input_size
        self.output_size = output_size
        self.trf_size = trf_size
        self.n_heads = n_heads
        self.ff_size = ff_size
        self.n_blocks = n_blocks
        self.dropout_rate = dropout
        self.trf_dropout = trf_dropout
        self.add_positional_embeddings = add_positional_embeddings

    def init(self, generator: torch.Generator) -> Params:
        return {
            "embed": linear_init(generator, self.input_size, self.trf_size),
            "blocks": [transformer_block_init(generator, self.trf_size, self.ff_size, self.n_heads)
                       for _ in range(self.n_blocks)],
            "out": linear_init(generator, self.trf_size, self.output_size),
        }

    def apply(self, params: Params, x: torch.Tensor, generator: torch.Generator | None = None,
              train: bool = False) -> torch.Tensor:
        x = dropout(generator, linear_apply(params["embed"], x), self.dropout_rate, train)
        if self.add_positional_embeddings:
            x = x + sinusoidal_positional_embeddings(x.shape[1], self.trf_size, x.device)[None]
        for blk in params["blocks"]:
            x = transformer_block_apply(blk, x, self.n_heads, self.trf_dropout, generator, train)
        x = dropout(generator, x, self.dropout_rate, train)
        return linear_apply(params["out"], x[:, 0, :])  # first-token readout (reference `:305`)


class VerboseLSTM(FeatureNetwork):
    """Per-layer LSTM stack that also exposes every layer's hidden states
    (reference `feature_network.py:310-348`; `bcnf_tpu/models/feature_network.py:285-336`):
    `num_layers` single-layer LSTMs with dropout between them. ``apply``
    returns the last layer's sequence, ``apply_verbose`` the pair ``(x, h)``,
    ``h`` of shape ``(B, num_layers, T, H*dirs)``."""

    def __init__(
        self,
        input_size: int,
        hidden_size: int,
        num_layers: int,
        dropout: float = 0.0,
        bidirectional: bool = False,
    ) -> None:
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dropout_rate = dropout
        self.bidirectional = bidirectional
        self.output_size = hidden_size * (2 if bidirectional else 1)

    def init(self, generator: torch.Generator) -> Params:
        in_sizes = [self.input_size] + [self.output_size] * (self.num_layers - 1)
        return {"layers": [lstm_init(generator, n, self.hidden_size, 1, self.bidirectional) for n in in_sizes]}

    def apply_verbose(self, params: Params, x: torch.Tensor, generator: torch.Generator | None = None,
                      train: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        hs = []
        for i, layer in enumerate(params["layers"]):
            x = lstm_apply(layer, x, self.hidden_size)
            hs.append(x)
            if i < self.num_layers - 1:
                x = dropout(generator, x, self.dropout_rate, train)
        return x, torch.stack(hs, dim=1)  # reference `:347`

    def apply(self, params: Params, x: torch.Tensor, generator: torch.Generator | None = None,
              train: bool = False) -> torch.Tensor:
        return self.apply_verbose(params, x, generator, train)[0]


class DualDomainLSTM(FeatureNetwork):
    """A time LSTM and an LSTM over the rfft of the input along time
    (``[real, imag]`` features), each pooled over its steps, fused by an MLP
    (reference `feature_network.py:350-398`; `bcnf_tpu/models/feature_network.py:339-394`)."""

    def __init__(
        self,
        input_size: int,
        hidden_size: int,
        fc_sizes: Sequence[int],
        fc_dropout: float = 0.0,
        num_layers: int = 1,
        dropout: float = 0.0,
        bidirectional: bool = False,
        pooling: str = "mean",
    ) -> None:
        if pooling not in ("mean", "max"):
            raise ValueError(f"Invalid pooling method: {pooling}")
        self.input_size = input_size
        self.output_size = list(fc_sizes)[-1]
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dropout_rate = dropout
        self.bidirectional = bidirectional
        self.pooling = pooling
        dirs = 2 if bidirectional else 1
        self.fc = FullyConnectedFeatureNetwork(sizes=[hidden_size * dirs * 2] + list(fc_sizes), dropout=fc_dropout)

    def init(self, generator: torch.Generator) -> Params:
        return {
            "time": lstm_init(generator, self.input_size, self.hidden_size, self.num_layers, self.bidirectional),
            "freq": lstm_init(generator, self.input_size * 2, self.hidden_size, self.num_layers, self.bidirectional),
            "fc": self.fc.init(generator),
        }

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=1) if self.pooling == "mean" else x.amax(dim=1)

    def apply(self, params: Params, x: torch.Tensor, generator: torch.Generator | None = None,
              train: bool = False) -> torch.Tensor:
        h_time = lstm_apply(params["time"], x, self.hidden_size, self.dropout_rate, generator, train)
        f = torch.fft.rfft(x, dim=1)  # over time (reference `:383`)
        h_freq = lstm_apply(params["freq"], torch.cat([f.real, f.imag], dim=-1), self.hidden_size,
                            self.dropout_rate, generator, train)
        fused = torch.cat([self._pool(h_time), self._pool(h_freq)], dim=-1)
        return self.fc.apply(params["fc"], fused, generator, train)


class DualDomainTransformer(FeatureNetwork):
    """A time transformer and a transformer over the rfft of the input along
    time (T//2+1 tokens of ``[real, imag]``, width 2C), each read out at its
    first token, fused by an MLP (reference `feature_network.py:401-471`;
    `bcnf_tpu/models/feature_network.py:397-441`)."""

    def __init__(
        self,
        input_size: int,
        trf_size: int,
        n_heads: int,
        ff_size: int,
        n_blocks: int,
        fc_sizes: Sequence[int],
        fc_dropout: float = 0.5,
        trf_dropout: float = 0.1,
        dropout: float = 0.5,
        add_positional_embeddings: bool = False,
    ) -> None:
        self.input_size = input_size
        self.output_size = list(fc_sizes)[-1]
        common = dict(trf_size=trf_size, n_heads=n_heads, ff_size=ff_size, n_blocks=n_blocks, output_size=trf_size,
                      dropout=dropout, trf_dropout=trf_dropout, add_positional_embeddings=add_positional_embeddings)
        self.time_trf = Transformer(input_size=input_size, **common)
        self.freq_trf = Transformer(input_size=input_size * 2, **common)
        self.fc = FullyConnectedFeatureNetwork(sizes=[trf_size * 2] + list(fc_sizes), dropout=fc_dropout)

    def init(self, generator: torch.Generator) -> Params:
        return {"time": self.time_trf.init(generator), "freq": self.freq_trf.init(generator),
                "fc": self.fc.init(generator)}

    def apply(self, params: Params, x: torch.Tensor, generator: torch.Generator | None = None,
              train: bool = False) -> torch.Tensor:
        x_time = self.time_trf.apply(params["time"], x, generator, train)
        f = torch.fft.rfft(x, dim=1)  # over time
        x_freq = self.freq_trf.apply(params["freq"], torch.cat([f.real, f.imag], dim=-1), generator, train)
        return self.fc.apply(params["fc"], torch.cat([x_time, x_freq], dim=-1), generator, train)


class DualDomainFC(FeatureNetwork):
    """A time MLP and an MLP over the FFT of the flattened input, fused by an
    MLP (reference `feature_network.py:474-525`;
    `bcnf_tpu/models/feature_network.py:444-495`).

    The JAX package's two deliberate divergences from the reference, which
    cannot run its published DFC configs as written, are kept as they are:
    the frequency MLP takes the **full** FFT of the flattened input (whose
    ``[real, imag]`` is exactly the declared ``input_size * 2`` features),
    and the fusion MLP is sized from the actual concatenation,
    ``2 * sizes[-1]``.
    """

    def __init__(
        self,
        input_size: int,
        sizes: Sequence[int],
        fc_sizes: Sequence[int],
        dropout: float = 0.5,
        add_positional_embeddings: bool = False,
    ) -> None:
        self.input_size = input_size
        self.output_size = list(fc_sizes)[-1]
        self.time_fc = FullyConnectedFeatureNetwork(sizes=[input_size] + list(sizes), dropout=dropout)
        self.freq_fc = FullyConnectedFeatureNetwork(sizes=[input_size * 2] + list(sizes), dropout=dropout)
        self.fc = FullyConnectedFeatureNetwork(sizes=[2 * list(sizes)[-1]] + list(fc_sizes), dropout=dropout)

    def init(self, generator: torch.Generator) -> Params:
        return {"time": self.time_fc.init(generator), "freq": self.freq_fc.init(generator),
                "fc": self.fc.init(generator)}

    def apply(self, params: Params, x: torch.Tensor, generator: torch.Generator | None = None,
              train: bool = False) -> torch.Tensor:
        x_time = self.time_fc.apply(params["time"], x, generator, train)
        f = torch.fft.fft(x.reshape(x.shape[0], -1), dim=-1)  # the full FFT: 2 * input_size features
        x_freq = self.freq_fc.apply(params["freq"], torch.cat([f.real, f.imag], dim=-1), generator, train)
        return self.fc.apply(params["fc"], torch.cat([x_time, x_freq], dim=-1), generator, train)
