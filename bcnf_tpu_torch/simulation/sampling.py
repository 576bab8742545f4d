"""Dataset generation: prior sampling + rejection filters + simulation
(port of `bcnf_tpu/simulation/sampling.py`).

Candidates are drawn a batch at a time on the device (priors -> filters ->
trajectories -> optional renders), every acceptance mask is computed
branch-free, and accepted rows are compacted on the host until exactly `n`
rows are accepted. The acceptance rules are the reference's:

- runaway filter: reject when ``g_z + a_z > 0``;
- underground filter: reject when ``x0_z < 0``;
- traveled-distance filter: accept if ``d/50 > 0.75``, else with probability
  ``sqrt(d/50)``;
- visibility filter: accept if ``vis > 0.75``, else with probability
  ``sigmoid((vis - 0.5) * 10)``, where ``vis`` is the mean per-frame pixel
  sum over all cameras.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from bcnf_tpu_torch.config import load_yaml
from bcnf_tpu_torch.simulation.camera import MC_SAMPLES, get_cams_position, record_trajectory
from bcnf_tpu_torch.simulation.observation import gaussian_observation_noise
from bcnf_tpu_torch.simulation.physics import n_steps_for, point_of_impact, simulate_trajectory
from bcnf_tpu_torch.simulation.priors import sample_ballistic_parameters
from bcnf_tpu_torch.utils.misc import resolve_device

# the MC renderer's sample points held at once: it renders this many points'
# worth of rows per chunk (~100 MB a (points, 3) float32 tensor)
RENDER_CHUNK_POINTS = 8_000_000


def _vectors(p: dict[str, torch.Tensor], *names: str) -> list[torch.Tensor]:
    return [torch.stack([p[f"{k}_x"], p[f"{k}_y"], p[f"{k}_z"]], dim=-1) for k in names]


def generate_data_old(
    generator: torch.Generator | None = None,
    x0_pdf: Callable | None = None,
    v0_pdf: Callable | None = None,
    g_pdf: Callable | None = None,
    w_pdf: Callable | None = None,
    b_pdf: Callable | None = None,
    m_pdf: Callable | None = None,
    rho_pdf: Callable | None = None,
    r_pdf: Callable | None = None,
    a_pdf: Callable | None = None,
    T: float = 2.0,
    dt: float = 1 / 30,
    N: int = 1,
    break_on_impact: bool = False,
    seed: int | None = None,
    device: str | torch.device | None = None,
) -> dict[str, np.ndarray]:
    """Legacy lambda-prior dataset API.

    Each `*_pdf` is `fn(size) -> np.ndarray` sampling that parameter; the
    defaults are the reference's lambda defaults, drawn from NumPy's
    generator seeded by `seed` (`generator` is unused, as the JAX package's
    `key` is). The trajectories are simulated as one batch on `device`.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x0 = (x0_pdf or (lambda size: rng.uniform(0, 10, size=size)))((N, 3))
    v0 = (v0_pdf or (lambda size: rng.uniform(-10, 10, size=size) + np.array([0, 0, 9])))((N, 3))
    g = (g_pdf or (lambda size: rng.normal(9.81, 0.1, size=size) * np.array([0, 0, -1])))((N, 3))
    w = (w_pdf or (lambda size: rng.normal(0, 1, size=size) * np.array([1, 1, 0.1])))((N, 3))
    b = (b_pdf or (lambda size: rng.uniform(0, 1, size=size)))((N,))
    m = (m_pdf or (lambda size: rng.uniform(0.5, 1.5, size=size)))((N,))
    rho = (rho_pdf or (lambda size: rng.uniform(1.0, 1.5, size=size)))((N,))
    r = (r_pdf or (lambda size: rng.uniform(0.05, 0.15, size=size)))((N,))
    a = (a_pdf or (lambda size: rng.uniform(0, 0, size=size)))((N, 3))

    def t(x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    X = simulate_trajectory(
        t(x0), t(v0), t(g), t(w), t(b), t(m), t(rho), t(r), t(a),
        n_steps=n_steps_for(T, dt), dt=float(dt), break_on_impact=break_on_impact, n_substeps=4,
    )
    return {
        "trajectories": X.cpu().numpy(),
        "x0_x": x0[:, 0], "x0_y": x0[:, 1], "x0_z": x0[:, 2],
        "v0_x": v0[:, 0], "v0_y": v0[:, 1], "v0_z": v0[:, 2],
        "g_x": g[:, 0], "g_y": g[:, 1], "g_z": g[:, 2],
        "w_x": w[:, 0], "w_y": w[:, 1], "w_z": w[:, 2],
        "b": b, "m": m, "rho": rho, "r": r,
        "a_x": a[:, 0], "a_y": a[:, 1], "a_z": a[:, 2],
    }


def accept_visibility(generator: torch.Generator, visibility: torch.Tensor) -> torch.Tensor:
    """Vectorised visibility acceptance."""
    u = torch.rand(visibility.shape, generator=generator, device=generator.device)
    soft = 1.0 / (1.0 + torch.exp(-(visibility - 0.5) * 10.0)) > u
    return (visibility > 0.75) | soft


def accept_traveled_distance(generator: torch.Generator, distance: torch.Tensor) -> torch.Tensor:
    """Vectorised traveled-distance acceptance."""
    ratio = distance / 50.0
    u = torch.rand(distance.shape, generator=generator, device=generator.device)
    return (ratio > 0.75) | (torch.sqrt(ratio.clamp(min=0.0)) > u)


def _stage_params(
    generator: torch.Generator, batch: int, prior_config: dict, num_cams: int, dt: float, do_filter: bool,
    stats: dict | None = None,
) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """A batch of prior draws and its acceptance by the cheap filters and
    the traveled distance. The impact loop runs only on the rows that the
    runaway and underground filters kept: the others are rejected whatever
    their distance."""
    p = sample_ballistic_parameters(generator, batch, prior_config, num_cams)
    accept = torch.ones(batch, dtype=torch.bool, device=generator.device)
    if do_filter:
        accept &= ~(p["g_z"] + p["a_z"] > 0)  # runaway
        accept &= ~(p["x0_z"] < 0)  # start underground
        x0, v0, g, w, a = _vectors(p, "x0", "v0", "g", "w", "a")
        rows = accept.nonzero().squeeze(-1)
        poi = point_of_impact(x0[rows], v0[rows], g[rows], w[rows], p["b"][rows], p["m"][rows], p["rho"][rows],
                              p["r"][rows], a[rows], dt=dt, stats=stats)
        distance = torch.zeros(batch, device=generator.device)
        distance[rows] = torch.linalg.vector_norm(poi - x0[rows], dim=-1)
        accept &= accept_traveled_distance(generator, distance)
    return p, accept


def _stage_trajectory(
    p: dict[str, torch.Tensor], n_steps: int, dt: float, break_on_impact: bool, n_substeps: int = 4,
) -> torch.Tensor:
    x0, v0, g, w, a = _vectors(p, "x0", "v0", "g", "w", "a")
    # n_substeps=4: the prior's stiff-drag tail (c = 0.5*b/m up to ~3 with
    # |v| ~ 40) exceeds RK4's stability region at dt ~ 1/15; the reference's
    # LSODA is adaptive and survives. Substepping covers the tail cheaply.
    return simulate_trajectory(
        x0, v0, g, w, p["b"], p["m"], p["rho"], p["r"], a,
        n_steps=n_steps, dt=dt, break_on_impact=break_on_impact, n_substeps=n_substeps,
    )


def _stage_render(
    generator: torch.Generator,
    p: dict[str, torch.Tensor],
    trajectory: torch.Tensor,
    cam_radians: torch.Tensor,
    num_cams: int,
    ratio: tuple[int, int],
    fov_horizontal: float,
    renderer: str,
    legacy_cam_geometry: bool,
    keep_videos: bool,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """Render every camera; returns (videos `(batch, num_cams, T, H, W)`, or
    None unless `keep_videos`, and the visibility `(batch,)`). Rows are
    rendered in chunks, so the MC renderer's points stay within
    `RENDER_CHUNK_POINTS`."""
    cams_pos = get_cams_position(
        cam_radians, p["cam_radius"], p["cam_heights"], legacy_pairing=legacy_cam_geometry
    )  # (batch, num_cams, 3)
    batch, n_frames = trajectory.shape[0], trajectory.shape[1]
    per_row = num_cams * n_frames * (MC_SAMPLES if renderer == "mc" else 1)
    chunk = max(1, RENDER_CHUNK_POINTS // per_row)
    videos, vis = [], []
    for s in range(0, batch, chunk):
        sl = slice(s, s + chunk)
        v = record_trajectory(
            trajectory[sl, None], cams_pos[sl], p["cam_angles"][sl], p["r"][sl, None].expand(-1, num_cams),
            generator=generator, ratio=ratio, fov_horizontal=fov_horizontal, mode=renderer,
        )  # (chunk, num_cams, T, H, W)
        # mean per-frame pixel sum over cameras
        vis.append(v.sum(dim=(2, 3, 4)).sum(dim=1) / (num_cams * n_frames))
        if keep_videos:
            videos.append(v)
    return (torch.cat(videos) if keep_videos else None), torch.cat(vis)


def generate_data(
    config_file: str | None = None,
    n: int = 100,
    output_type: str = "parameters",
    dt: float = 1 / 30,
    T: float = 4,
    ratio: tuple = (16, 9),
    fov_horizontal: float = 70.0,
    cam1_radian: float = 0.0,
    num_cams: int = 2,
    break_on_impact: bool = True,
    do_filter: bool = True,
    verbose: bool = False,
    seed: int | None = None,
    prior_config: dict | None = None,
    renderer: str = "mc",
    legacy_cam_geometry: bool = False,
    batch_size: int | None = None,
    observation_noise: float = 0.0,
    device: str | torch.device | None = None,
    stats: dict | None = None,
    **_: Any,
) -> dict[str, list]:
    """Generate an accepted dataset of exactly `n` rows on `device` (default CUDA).

    Returns the reference's dict-of-lists schema (the keys of
    `sample_ballistic_parameters`, with `cam_radian_array` led by
    `cam1_radian`, plus `trajectories` / `videos`).

    `observation_noise > 0` applies the airborne Gaussian observation model
    to the emitted `trajectories` only: the filters and renders see the
    clean trajectory. `stats`, when given, gets the number of batches drawn
    (``"batches"``), the rows rejected (``"rejected"``) and the steps each
    impact loop ran (``"impact_steps"``).
    """
    if output_type not in ("videos", "trajectories", "parameters"):
        raise ValueError('output_type must be one of "videos", "trajectories", or "parameters"')

    if prior_config is None:
        if config_file is None:
            raise ValueError("either config_file or prior_config must be given")
        prior_config = load_yaml(config_file).to_dict()

    dev = resolve_device(device)
    render = output_type == "videos"
    n_steps = n_steps_for(T, dt)
    if batch_size is None:
        batch_size = 128 if (render or do_filter) else min(max(n, 64), 4096)

    generator = torch.Generator(device=dev)
    if seed is None:  # entropy from the OS
        generator.seed()
    else:
        generator.manual_seed(seed)
    data: dict[str, list] = {}
    accepted = 0
    rejected = 0
    if stats is not None:
        stats.update(batches=0, rejected=0, impact_steps=[])

    while accepted < n:
        impact = {}
        p, accept = _stage_params(generator, batch_size, prior_config, num_cams, float(dt), bool(do_filter), impact)
        trajectory = _stage_trajectory(p, n_steps, float(dt), bool(break_on_impact))

        out = dict(p)
        # prepend the fixed first-camera radian
        cam_radians = torch.cat(
            [torch.full((batch_size, 1), float(cam1_radian), device=dev), p["cam_radian_array"]], dim=-1
        )
        out["cam_radian_array"] = cam_radians

        if render or do_filter:
            videos, vis = _stage_render(
                generator, p, trajectory, cam_radians, num_cams, tuple(ratio),
                float(fov_horizontal), renderer, bool(legacy_cam_geometry), render,
            )
            if do_filter:
                accept &= accept_visibility(generator, vis)
            if render:
                out["videos"] = videos

        if observation_noise > 0:
            out["trajectories"] = gaussian_observation_noise(generator, trajectory, std=float(observation_noise))
        else:
            out["trajectories"] = trajectory
        out = {k: v.cpu().numpy() for k, v in out.items()}
        mask = accept.cpu().numpy()
        # Safety net (deliberate divergence from the reference): reject
        # trajectories the fixed-step integrator failed on (non-finite); the
        # reference's adaptive LSODA never emits NaN, and keeping them would
        # poison training.
        mask &= np.isfinite(out["trajectories"]).all(axis=(1, 2))
        idx = np.nonzero(mask)[0][: n - accepted]
        rejected += int((~mask).sum())
        for k, v in out.items():
            data.setdefault(k, []).extend(v[idx])
        accepted += len(idx)
        if stats is not None:
            stats["batches"] += 1
            stats["rejected"] = rejected
            if "steps" in impact:
                stats["impact_steps"].append(impact["steps"])
        if verbose:
            total = accepted + rejected
            print(f"accepted={accepted}/{n} rejected={rejected} ratio={accepted / max(total, 1):.3f}")

    if output_type == "parameters":
        data.pop("videos", None)
        data.pop("trajectories", None)
    elif output_type == "trajectories":
        data.pop("videos", None)

    return data
