"""Monotonic rational-quadratic splines (port of `bcnf_tpu/models/splines.py`;
Durkan et al. 2019, neural spline flows).

The JAX package's working RQS transform, the coupling of
`model.kwargs.coupling: rqs`, written the same way: identity linear tails
outside ``[-tail_bound, tail_bound]``, boundary derivatives padded so the
slope at the tails is exactly 1, the bin found by a comparison-sum (no
`searchsorted`), and the inverse solved in closed form.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def n_spline_params(num_bins: int) -> int:
    """Parameters per transformed dimension: K widths + K heights + (K-1) interior derivatives."""
    return 3 * num_bins - 1


def _knots(unnormalized: torch.Tensor, min_bin: float, tail_bound: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(knot positions (..., K+1) from -tail_bound to tail_bound exactly,
    bin sizes (..., K)) from unnormalized bin sizes."""
    num_bins = unnormalized.shape[-1]
    sizes = min_bin + (1 - min_bin * num_bins) * torch.softmax(unnormalized, dim=-1)
    # the K-long sums run along a leading axis: on an H100, torch's scan
    # along the innermost axis took 5.2 ms for 100,000 x 9 rows of 8 bins,
    # 86% of an RQS flow's inverse (chip_smoke.py phase 13's profile)
    cum = torch.cumsum(sizes.movedim(-1, 0), dim=0).movedim(0, -1)
    cum = (2 * tail_bound) * F.pad(cum, (1, 0)) - tail_bound
    edge = cum.new_full(cum.shape[:-1] + (1,), tail_bound)
    cum = torch.cat([-edge, cum[..., 1:-1], edge], dim=-1)
    return cum, cum[..., 1:] - cum[..., :-1]


def rational_quadratic_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    inverse: bool = False,
    tail_bound: float = 3.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Unconstrained RQS with linear tails outside ``[-tail_bound, tail_bound]``
    (`bcnf_tpu/models/splines.py:30-139`).

    Shapes: ``inputs (...,)``; ``unnormalized_widths/heights (..., K)``;
    ``unnormalized_derivatives (..., K-1)``. Returns ``(outputs,
    log_abs_det)`` elementwise.
    """
    num_bins = unnormalized_widths.shape[-1]
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    # clamped so the spline is defined everywhere; outside rows take the identity below
    x = torch.clamp(inputs, -tail_bound, tail_bound)

    # boundary derivatives: the value whose softplus is exactly 1 - min_derivative
    constant = math.log(math.expm1(1.0 - min_derivative))
    derivatives = min_derivative + F.softplus(F.pad(unnormalized_derivatives, (1, 1), value=constant))
    cumwidths, widths = _knots(unnormalized_widths, min_bin_width, tail_bound)
    cumheights, heights = _knots(unnormalized_heights, min_bin_height, tail_bound)

    # the bin: (number of knots <= x) - 1, clipped
    knots = cumheights if inverse else cumwidths
    idx = (torch.sum(knots[..., :-1] <= x[..., None], dim=-1) - 1).clamp(0, num_bins - 1)[..., None]

    def take(arr: torch.Tensor) -> torch.Tensor:
        return torch.gather(arr, -1, idx)[..., 0]

    in_cumwidths = take(cumwidths[..., :-1])
    in_widths = take(widths)
    in_cumheights = take(cumheights[..., :-1])
    in_heights = take(heights)
    in_delta = take(heights / widths)
    in_d = take(derivatives[..., :-1])
    in_d_plus = take(derivatives[..., 1:])

    if inverse:
        y_rel = x - in_cumheights
        term = y_rel * (in_d + in_d_plus - 2 * in_delta)
        a = in_heights * (in_delta - in_d) + term
        b = in_heights * in_d - term
        c = -in_delta * y_rel
        discriminant = torch.clamp(b**2 - 4 * a * c, min=0.0)
        root = (2 * c) / (-b - torch.sqrt(discriminant))
        outputs = root * in_widths + in_cumwidths
        theta_one_minus_theta = root * (1 - root)
        denominator = in_delta + (in_d + in_d_plus - 2 * in_delta) * theta_one_minus_theta
        derivative_numerator = in_delta**2 * (
            in_d_plus * root**2 + 2 * in_delta * theta_one_minus_theta + in_d * (1 - root) ** 2
        )
        logabsdet = -(torch.log(derivative_numerator) - 2 * torch.log(denominator))
    else:
        theta = (x - in_cumwidths) / in_widths
        theta_one_minus_theta = theta * (1 - theta)
        numerator = in_heights * (in_delta * theta**2 + in_d * theta_one_minus_theta)
        denominator = in_delta + (in_d + in_d_plus - 2 * in_delta) * theta_one_minus_theta
        outputs = in_cumheights + numerator / denominator
        derivative_numerator = in_delta**2 * (
            in_d_plus * theta**2 + 2 * in_delta * theta_one_minus_theta + in_d * (1 - theta) ** 2
        )
        logabsdet = torch.log(derivative_numerator) - 2 * torch.log(denominator)

    outputs = torch.where(inside, outputs, inputs)
    logabsdet = torch.where(inside, logabsdet, torch.zeros_like(logabsdet))
    return outputs, logabsdet
