"""Named custom layers selectable via config (port of `bcnf_tpu/models/layers.py`,
reference `src/bcnf/models/layers.py`).

Feature-network wrappers over the dense-layer families of `ops/nn.py`, so
the reference's layer classes (`AnyGLU`, `FFTLayer`, `FFTEnrichLayer`,
`LinearFFTEnriched`) exist by name in feature stacks; the same families serve
as the coupling MLP's layer (`model.kwargs.layer`).
"""

from __future__ import annotations

from typing import Any

import torch

from bcnf_tpu_torch.models.feature_network import FeatureNetwork
from bcnf_tpu_torch.ops.nn import Params, fft_enrich, fft_features, get_dense_layer


class AnyGLU(FeatureNetwork):
    """Gated linear unit with a configurable gate activation:
    ``value(x) * act(gate(x))`` (reference `layers.py:9-31`)."""

    def __init__(self, input_size: int, output_size: int, activation: str = "GELU",
                 activation_kwargs: dict[str, Any] | None = None) -> None:
        self.input_size = input_size
        self.output_size = output_size
        self._family = get_dense_layer("AnyGLU", {"activation": activation, "activation_kwargs": activation_kwargs})

    def init(self, generator: torch.Generator) -> Params:
        return self._family.init(generator, self.input_size, self.output_size)

    def apply(self, params: Params, x: torch.Tensor, generator: torch.Generator | None = None,
              train: bool = False) -> torch.Tensor:
        return self._family.apply(params, x)


class FFTLayer(FeatureNetwork):
    """rfft over the last axis with 'forward' norm, real and imaginary parts
    concatenated (reference `layers.py:34-45`)."""

    def __init__(self, input_size: int | None = None) -> None:
        self.input_size = input_size
        self.output_size = 2 * (input_size // 2 + 1) if input_size else None

    def apply(self, params: Params, x: torch.Tensor, generator: torch.Generator | None = None,
              train: bool = False) -> torch.Tensor:
        return fft_features(x)


class FFTEnrichLayer(FeatureNetwork):
    """The input with its FFT features concatenated (reference `layers.py:48-57`)."""

    def __init__(self, input_size: int | None = None) -> None:
        self.input_size = input_size
        self.output_size = input_size + 2 * (input_size // 2 + 1) if input_size else None

    def apply(self, params: Params, x: torch.Tensor, generator: torch.Generator | None = None,
              train: bool = False) -> torch.Tensor:
        return fft_enrich(x)


class LinearFFTEnriched(FeatureNetwork):
    """A linear layer over ``[x, rfft(x)]`` (reference `layers.py:60-78`)."""

    def __init__(self, input_size: int, output_size: int) -> None:
        self.input_size = input_size
        self.output_size = output_size
        self._family = get_dense_layer("LinearFFTEnriched")

    def init(self, generator: torch.Generator) -> Params:
        return self._family.init(generator, self.input_size, self.output_size)

    def apply(self, params: Params, x: torch.Tensor, generator: torch.Generator | None = None,
              train: bool = False) -> torch.Tensor:
        return self._family.apply(params, x)
