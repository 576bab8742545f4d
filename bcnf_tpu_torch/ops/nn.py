"""Dense building blocks over parameter dicts (port of `bcnf_tpu/ops/nn.py`).

Layouts match the JAX package so weights copy across unchanged: a linear
layer is ``{"w": (in, out), "b": (out,)}`` and applies as ``x @ w + b``.
Initialization is torch's `nn.Linear` default, U(-1/sqrt(fan_in),
1/sqrt(fan_in)), drawn from an explicit `torch.Generator`.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch
import torch.nn.functional as F

Params = dict


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh form of GELU: `jax.nn.gelu`'s default (`bcnf_tpu/ops/nn.py:29`)
    and what both Pallas kernels compute. torch's exact default differs by up
    to 4e-4."""
    return F.gelu(x, approximate="tanh")


def gelu_grad(x: torch.Tensor) -> torch.Tensor:
    """d gelu / dx of the tanh form, as `jax.vjp(jax.nn.gelu)` gives it in the
    training kernel's backward (`bcnf_tpu/ops/flow_kernel.py:515`):
    0.5 (1 + tanh u) + 0.5 x (1 - tanh^2 u) sqrt(2/pi) (1 + 3 * 0.044715 x^2)."""
    k0 = math.sqrt(2.0 / math.pi)
    t = torch.tanh(k0 * (x + 0.044715 * x**3))
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * k0 * (1.0 + 3.0 * 0.044715 * x * x)


ACTIVATIONS: dict[str, Callable[..., torch.Tensor]] = {
    "GELU": gelu,
    "RELU": F.relu,
    "SILU": F.silu,
    "SIGMOID": torch.sigmoid,
    "TANH": torch.tanh,
    "ELU": F.elu,
    "LEAKYRELU": F.leaky_relu,
    "SOFTPLUS": F.softplus,
    "MISH": F.mish,
    "IDENTITY": lambda x: x,
}


def get_activation(name: str, **kwargs: Any) -> Callable[[torch.Tensor], torch.Tensor]:
    key = name.upper()
    if key not in ACTIVATIONS:
        raise NotImplementedError(f"Activation {name} not implemented")
    fn = ACTIVATIONS[key]
    if kwargs:
        return lambda x: fn(x, **kwargs)
    return fn


def uniform(generator: torch.Generator, shape: tuple[int, ...], bound: float) -> torch.Tensor:
    """U(-bound, bound) float32 draw on the generator's (CPU) device."""
    return (torch.rand(shape, generator=generator, dtype=torch.float32) * 2.0 - 1.0) * bound


def linear_init(generator: torch.Generator, in_dim: int, out_dim: int) -> Params:
    """torch.nn.Linear default init: U(-k, k) with k = 1/sqrt(fan_in)."""
    k = 1.0 / math.sqrt(in_dim)
    return {"w": uniform(generator, (in_dim, out_dim), k), "b": uniform(generator, (out_dim,), k)}


def linear_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"] + params["b"]


def dropout(generator: torch.Generator | None, x: torch.Tensor, rate: float, train: bool) -> torch.Tensor:
    """Inverted dropout; identity when not training, at rate 0, or without a
    generator (as the JAX version is without a key)."""
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=generator.device) < keep
    return torch.where(mask.to(x.device), x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class DenseLayer:
    """A named dense-layer family: init(generator, in, out) + apply(params, x)."""

    def __init__(self, name: str, init: Callable, apply: Callable) -> None:
        self.name = name
        self.init = init
        self.apply = apply


def get_dense_layer(layer: str, layer_kwargs: dict | None = None) -> DenseLayer:
    """Resolve a dense-layer family by config name (reference `factories.py:61-73`).
    Only `Linear` is ported so far."""
    name = layer.lower()
    if name == "linear":
        return DenseLayer("Linear", linear_init, linear_apply)
    if name in ("anyglu", "linearfftenriched"):
        raise NotImplementedError(
            f"Layer {layer} is not ported yet (ROADMAP.md, 'Other conditioners')"
        )
    raise NotImplementedError(f"Layer {layer} not implemented")
