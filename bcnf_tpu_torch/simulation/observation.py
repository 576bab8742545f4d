"""Simple observation models (port of `bcnf_tpu/simulation/observation.py`)."""

from __future__ import annotations

import torch


def gaussian_observation_noise(generator: torch.Generator, p: torch.Tensor, std: float = 0.1) -> torch.Tensor:
    """Add Gaussian noise, drawn from `generator` on its device, while the
    object is airborne (z > 0)."""
    return add_airborne_noise(p, torch.randn(p.shape, generator=generator, device=generator.device), std)


def add_airborne_noise(p: torch.Tensor, eps: torch.Tensor, std: float) -> torch.Tensor:
    """`p + std * eps` where the object is airborne (z > 0), else `p`: the
    observation model on given standard-normal draws `eps`."""
    noise = std * eps
    return p + torch.where(p[..., -1:] > 0, noise, torch.zeros_like(noise))


def simple_2D_camera_observation(
    p: torch.Tensor, generator: torch.Generator | None = None, noise: bool = False, std: float = 0.1
) -> torch.Tensor:
    """Project onto the x-z plane."""
    if noise:
        if generator is None:
            raise ValueError("noise=True requires a generator")
        return gaussian_observation_noise(generator, p, std=std)[..., [0, 2]]
    return p[..., [0, 2]]
