"""Prior sampling over the physical parameters (port of
`bcnf_tpu/simulation/priors.py`).

Each distribution draws a whole batch from an explicit `torch.Generator`, on
that generator's device, in a fixed order. The reference's quirks are kept,
since they define the data distribution:

- the xy-components of x0 / v0 / w are sampled in polar form; for `gaussian`
  the radius is ``sqrt(|N(0,1)|) * std + mean``; for `uniform` x0 takes
  ``sqrt(U(min,max))`` while v0 / w take plain ``U(min,max)``;
- the thrust magnitude for `gaussian` is ``cbrt(|N(0,1)|) * std + mean``,
  with uniform spherical angles phi ~ U(0,2pi), theta ~ U(0,pi);
- gravity is vertical only: ``g_z = -sample(g)``, ``g_x = g_y = 0``;
- the drag coefficient is ``b = rho * A * Cd`` with ``A = pi*r**2``.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from bcnf_tpu_torch.errors import ConfigError


def _uniform(generator: torch.Generator, shape: tuple[int, ...], low: float, high: float) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (high - low) + low


def sample_from_config(generator: torch.Generator, spec: dict[str, Any], shape: tuple[int, ...]) -> torch.Tensor:
    """Draw `shape` samples from a prior spec `{distribution, min, max, mean, std, shape, scale}`
    on the generator's device.

    `gaussian` returns *raw* N(0,1) samples: scaling by mean/std is the
    caller's job, as in the reference.
    """
    dist = spec["distribution"]
    if dist == "uniform":
        if "min" not in spec or "max" not in spec:
            raise ConfigError("min and max must be defined for uniform distribution")
        return _uniform(generator, shape, float(spec["min"]), float(spec["max"]))
    if dist == "gaussian":
        return torch.randn(shape, generator=generator, device=generator.device)
    if dist == "gamma":
        if "shape" not in spec or "scale" not in spec:
            raise ConfigError("shape and scale must be defined for gamma distribution")
        alpha = torch.full(shape, float(spec["shape"]), device=generator.device)
        return torch._standard_gamma(alpha, generator=generator) * float(spec["scale"])
    raise ConfigError(f"Unknown distribution type: {dist}")


def _polar_radius(generator: torch.Generator, spec: dict, n: int, transform: str) -> torch.Tensor:
    """Radius of polar/spherical coordinates, with the reference's
    per-distribution transform quirks (see the module docstring)."""
    raw = sample_from_config(generator, spec, (n,))
    dist = spec["distribution"]
    if dist == "gaussian":
        if transform == "sqrt":
            return torch.sqrt(raw.abs()) * float(spec["std"]) + float(spec["mean"])
        if transform == "cbrt":
            return torch.pow(raw.abs(), 1.0 / 3.0) * float(spec["std"]) + float(spec["mean"])
        return raw * float(spec["std"]) + float(spec["mean"])
    if dist == "uniform" and transform == "sqrt_uniform":
        return torch.sqrt(raw)
    return raw


def _scalar(generator: torch.Generator, spec: dict, n: int) -> torch.Tensor:
    """z-component sampling: a gaussian is scaled by mean/std."""
    raw = sample_from_config(generator, spec, (n,))
    if spec["distribution"] == "gaussian":
        return raw * float(spec["std"]) + float(spec["mean"])
    return raw


def _sample_batch(generator: torch.Generator, n: int, num_cams: int, cfg: dict) -> dict[str, torch.Tensor]:
    two_pi = 2 * math.pi
    # initial position: polar xy + separate z
    x0_xy = cfg["x0"]["x0_xy"]
    r_x = _polar_radius(generator, x0_xy, n, "sqrt" if x0_xy["distribution"] == "gaussian" else "sqrt_uniform")
    phi = _uniform(generator, (n,), 0.0, two_pi)
    x0_x, x0_y = r_x * torch.cos(phi), r_x * torch.sin(phi)
    x0_z = _scalar(generator, cfg["x0"]["x0_z"], n)

    # initial velocity
    r_v = _polar_radius(generator, cfg["v0"]["v0_xy"], n, "sqrt")
    phi_v = _uniform(generator, (n,), 0.0, two_pi)
    v0_x, v0_y = r_v * torch.cos(phi_v), r_v * torch.sin(phi_v)
    v0_z = _scalar(generator, cfg["v0"]["v0_z"], n)

    # wind
    r_w = _polar_radius(generator, cfg["w"]["w_xy"], n, "sqrt")
    phi_w = _uniform(generator, (n,), 0.0, two_pi)
    w_x, w_y = r_w * torch.cos(phi_w), r_w * torch.sin(phi_w)
    w_z = _scalar(generator, cfg["w"]["w_z"], n)

    # thrust: spherical
    r_a = _polar_radius(generator, cfg["a"], n, "cbrt")
    phi_a = _uniform(generator, (n,), 0.0, two_pi)
    theta_a = _uniform(generator, (n,), 0.0, math.pi)
    a_x = r_a * torch.sin(theta_a) * torch.cos(phi_a)
    a_y = r_a * torch.sin(theta_a) * torch.sin(phi_a)
    a_z = r_a * torch.cos(theta_a)

    # gravity, air density, ball radius, drag
    g_z = -sample_from_config(generator, cfg["g"], (n,))
    rho = sample_from_config(generator, cfg["rho"], (n,))
    r_ball = sample_from_config(generator, cfg["r_ball"], (n,))
    area = math.pi * r_ball**2
    cd = sample_from_config(generator, cfg["Cd"], (n,))
    b = rho * area * cd
    m = sample_from_config(generator, cfg["m"], (n,))

    # camera geometry
    cam_radian = sample_from_config(generator, cfg["cam_radian"], (n, max(num_cams - 1, 1)))
    cam_radius = sample_from_config(generator, cfg["cam_radius"], (n,))
    cam_angles = sample_from_config(generator, cfg["cam_angle"], (n, num_cams))
    cam_heights = sample_from_config(generator, cfg["cam_heights"], (n, num_cams))

    zeros = torch.zeros(n, device=generator.device)
    return {
        "x0_x": x0_x, "x0_y": x0_y, "x0_z": x0_z,
        "v0_x": v0_x, "v0_y": v0_y, "v0_z": v0_z,
        "g_x": zeros, "g_y": zeros.clone(), "g_z": g_z,
        "w_x": w_x, "w_y": w_y, "w_z": w_z,
        "b": b, "m": m,
        "a_x": a_x, "a_y": a_y, "a_z": a_z,
        "cam_radian_array": cam_radian[:, : num_cams - 1],
        "r": r_ball, "A": area, "Cd": cd, "rho": rho,
        "cam_radius": cam_radius,
        "cam_angles": cam_angles,
        "cam_heights": cam_heights,
    }


def sample_ballistic_parameters(
    generator: torch.Generator,
    n: int,
    prior_config: dict,
    num_cams: int = 2,
) -> dict[str, torch.Tensor]:
    """Draw `n` parameter sets from the prior on the generator's device."""
    return _sample_batch(generator, n, num_cams, prior_config)
