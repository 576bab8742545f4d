"""Synthetic camera renderer (port of `bcnf_tpu/simulation/camera.py`).

Two renderers, batched over leading axes (rows, cameras, frames) on the
inputs' device:

- ``mode='mc'``: the reference's Monte-Carlo frame: 5000 Gaussian points
  around the ball, projected to angle space and binned into a histogram by
  counting (an overflow bin takes the points out of view). The draw and the
  binning are split: `render_frame_mc_points` bins given points, so a test
  can feed both packages the same points.
- ``mode='analytic'``: the expected histogram of the same points, from
  separable normal-CDF differences in angle space. Deterministic, and its
  images differ from MC's by design.

Each frame is `(H, W) = (ratio[1]*10, ratio[0]*10)` with the reference's
`flipud(vals.T)` orientation.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MC_SAMPLES = 5000
RADIUS_TO_STD = 1.0 / 1.644854  # std covering 90% of mass


def rotate_vector(vector: torch.Tensor, angle_degrees: float | torch.Tensor) -> torch.Tensor:
    """Rotate a vector upwards by `angle_degrees` in its vertical plane."""
    angle = torch.as_tensor(angle_degrees, dtype=vector.dtype, device=vector.device) * (math.pi / 180)
    r = torch.linalg.vector_norm(vector, dim=-1)
    theta = torch.arccos(vector[..., 2] / r) - angle
    phi = torch.arctan2(vector[..., 1], vector[..., 0])
    return torch.stack(
        [
            r * torch.sin(theta) * torch.cos(phi),
            r * torch.sin(theta) * torch.sin(phi),
            r * torch.cos(theta),
        ],
        dim=-1,
    )


def get_cams_position(
    cam_radians: torch.Tensor,
    cam_circle_radius: torch.Tensor,
    cam_heights: torch.Tensor,
    legacy_pairing: bool = False,
) -> torch.Tensor:
    """Camera positions on a circle, shape `(..., n_cams, 3)`.

    The reference iterates the 2-tuple `(cam_radiants, cam_heights)` itself,
    so with 2 cameras camera 1 gets (radian[0], height=radian[1]) and camera
    2 gets (radian=height[0], height[1]). The default is the intended `zip`
    pairing; ``legacy_pairing=True`` reproduces the reference's geometry.
    """
    if legacy_pairing:
        pairs = torch.stack([cam_radians, cam_heights], dim=-2)  # (..., 2, n_cams)
        rad = pairs[..., :, 0]
        hgt = pairs[..., :, 1]
    else:
        rad, hgt = cam_radians, cam_heights
    radius = torch.as_tensor(cam_circle_radius)[..., None]
    return torch.stack([-radius * torch.cos(rad), radius * torch.sin(rad), hgt], dim=-1)


def _camera_frame(cam_pos: torch.Tensor, viewing_angle: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The camera's basis: viewing direction, its orthogonal, and up."""
    focus = torch.stack([torch.zeros_like(cam_pos[..., 0]), torch.zeros_like(cam_pos[..., 1]), cam_pos[..., 2]], dim=-1)
    d = focus - cam_pos
    cam_dir = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    cam_dir = rotate_vector(cam_dir, viewing_angle)
    cam_up = rotate_vector(cam_dir, 90.0)
    cam_orth = torch.linalg.cross(cam_dir, cam_up)
    return cam_dir, cam_orth, cam_up


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (u * v).sum(dim=-1)


def _angles(v: torch.Tensor, cam_dir: torch.Tensor, cam_orth: torch.Tensor,
            cam_up: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Horizontal and vertical view angles of `v` (..., 3) against a camera
    basis that broadcasts against it."""
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    along = _dot(v, cam_dir)
    ph = torch.arctan2(_dot(v, cam_orth), along)
    th = torch.arctan2(_dot(v, cam_up), along)
    return ph, th


def _fov(ratio: tuple[int, int], fov_horizontal: float) -> tuple[float, float]:
    aspect = ratio[0] / ratio[1]
    phi = (fov_horizontal / 2) * (np.pi / 180)
    theta = (fov_horizontal / aspect / 2) * (np.pi / 180)
    return phi, theta


def render_frame_mc_points(
    points: torch.Tensor,
    cam_pos: torch.Tensor,
    viewing_angle: torch.Tensor,
    ratio: tuple[int, int] = (16, 9),
    fov_horizontal: float = 70.0,
) -> torch.Tensor:
    """Bin the sample points `(..., S, 3)` of each frame into its normalised
    `(..., H, W)` image; `cam_pos` `(..., 3)` and `viewing_angle` `(...)`."""
    W, H = ratio[0] * 10, ratio[1] * 10
    phi, theta = _fov(ratio, fov_horizontal)
    cam_dir, cam_orth, cam_up = _camera_frame(cam_pos, viewing_angle)
    ph, th = _angles(points - cam_pos[..., None, :], cam_dir[..., None, :], cam_orth[..., None, :],
                     cam_up[..., None, :])

    ix = torch.floor((ph + phi) / (2 * phi) * W).to(torch.int64)
    iy = torch.floor((th + theta) / (2 * theta) * H).to(torch.int64)
    # np.histogram2d includes the right edge in the last bin
    ix = torch.where(ph == phi, W - 1, ix)
    iy = torch.where(th == theta, H - 1, iy)
    valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    flat = torch.where(valid, iy * W + ix, H * W)  # overflow bin for points out of view
    batch = flat.shape[:-1]
    n_frames = math.prod(batch)
    offsets = torch.arange(n_frames, device=flat.device).reshape(batch + (1,)) * (H * W + 1)
    counts = torch.bincount((flat + offsets).reshape(-1), minlength=n_frames * (H * W + 1))
    hist = counts.reshape(batch + (H * W + 1,))[..., :-1].to(points.dtype).reshape(batch + (H, W))

    total = hist.sum(dim=(-2, -1), keepdim=True)
    img = torch.where(total > 0, hist / torch.where(total > 0, total, torch.ones_like(total)), torch.zeros_like(hist))
    # orientation: rows top to bottom = decreasing th (the reference's flipud(vals.T))
    return img.flip(-2)


def render_frame_mc(
    generator: torch.Generator,
    ball_pos: torch.Tensor,
    cam_pos: torch.Tensor,
    viewing_angle: torch.Tensor,
    radius: torch.Tensor,
    ratio: tuple[int, int] = (16, 9),
    fov_horizontal: float = 70.0,
) -> torch.Tensor:
    """Monte-Carlo frames: `MC_SAMPLES` Gaussian points around each ball
    position `(..., 3)`, drawn from `generator` (on the inputs' device), binned
    by `render_frame_mc_points`."""
    noise = torch.randn(ball_pos.shape[:-1] + (MC_SAMPLES, 3), generator=generator, device=generator.device)
    points = ball_pos[..., None, :] + (radius * RADIUS_TO_STD)[..., None, None] * noise
    return render_frame_mc_points(points, cam_pos, viewing_angle, ratio, fov_horizontal)


def render_frame_analytic(
    ball_pos: torch.Tensor,
    cam_pos: torch.Tensor,
    viewing_angle: torch.Tensor,
    radius: torch.Tensor,
    ratio: tuple[int, int] = (16, 9),
    fov_horizontal: float = 70.0,
) -> torch.Tensor:
    """Expected-histogram frames `(..., H, W)` from separable Gaussian CDFs.

    The ball's centre projects to angles (ph0, th0); the angular spread is
    ``atan(std / distance)``. A bin's mass is the product of per-axis normal
    CDF differences, normalised over the in-view mass like the MC path.
    """
    W, H = ratio[0] * 10, ratio[1] * 10
    phi, theta = _fov(ratio, fov_horizontal)
    cam_dir, cam_orth, cam_up = _camera_frame(cam_pos, viewing_angle)

    d = ball_pos - cam_pos
    dist = torch.linalg.vector_norm(d, dim=-1)
    ph0, th0 = _angles(d, cam_dir, cam_orth, cam_up)
    ang_std = torch.arctan(radius * RADIUS_TO_STD / dist)

    xedges = torch.linspace(-phi, phi, W + 1, device=d.device)
    yedges = torch.linspace(-theta, theta, H + 1, device=d.device)
    cdf_x = torch.special.ndtr((xedges - ph0[..., None]) / ang_std[..., None])
    cdf_y = torch.special.ndtr((yedges - th0[..., None]) / ang_std[..., None])
    mass_x = torch.diff(cdf_x, dim=-1)  # (..., W)
    mass_y = torch.diff(cdf_y, dim=-1)  # (..., H)
    img = mass_y[..., :, None] * mass_x[..., None, :]  # (..., H, W)

    behind = _dot(d, cam_dir) <= 0  # a ball behind the camera never renders
    total = img.sum(dim=(-2, -1))
    keep = ~(behind | (total < 1e-12))
    img = torch.where(keep[..., None, None],
                      img / torch.where(total > 0, total, torch.ones_like(total))[..., None, None],
                      torch.zeros_like(img))
    return img.flip(-2)


def record_trajectory(
    trajectory: torch.Tensor,
    cam_pos: torch.Tensor,
    viewing_angle: torch.Tensor,
    radius: torch.Tensor,
    generator: torch.Generator | None = None,
    ratio: tuple[int, int] = (16, 9),
    fov_horizontal: float = 70.0,
    mode: str = "analytic",
) -> torch.Tensor:
    """Render trajectories `(..., T, 3)` into videos `(..., T, H, W)`;
    `cam_pos` `(..., 3)`, `viewing_angle` and `radius` `(...)` hold one
    camera and ball per trajectory."""
    cam_pos, viewing_angle, radius = cam_pos[..., None, :], viewing_angle[..., None], radius[..., None]
    shape = torch.broadcast_shapes(trajectory.shape, cam_pos.shape)
    trajectory, cam_pos = trajectory.expand(shape), cam_pos.expand(shape)
    viewing_angle, radius = viewing_angle.expand(shape[:-1]), radius.expand(shape[:-1])
    if mode == "mc":
        if generator is None:
            raise ValueError("mode='mc' requires a generator")
        return render_frame_mc(generator, trajectory, cam_pos, viewing_angle, radius, ratio, fov_horizontal)
    return render_frame_analytic(trajectory, cam_pos, viewing_angle, radius, ratio, fov_horizontal)
