"""Posterior predictive checking by resimulation (port of
`bcnf_tpu/simulation/resimulation.py`).

The `(M, N)` grid of posterior parameter sets is simulated as one batched
RK4 integration on the device, or, on a data mesh, as one integration per
shard of its N axis.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from bcnf_tpu_torch.config import ParameterIndexMapping
from bcnf_tpu_torch.parallel.mesh import Mesh, batch_sharding, gather, replicate, sample_sharded
from bcnf_tpu_torch.simulation.physics import n_steps_for, simulate_trajectory
from bcnf_tpu_torch.utils.misc import resolve_device

# parameter names the simulator takes, in canonical order
_SIM_KEYS = [
    "x0_x", "x0_y", "x0_z", "v0_x", "v0_y", "v0_z",
    "g_x", "g_y", "g_z", "w_x", "w_y", "w_z",
    "b", "m", "rho", "r", "a_x", "a_y", "a_z",
]


def _assemble(
    y_hat: torch.Tensor,
    mapping: ParameterIndexMapping,
    fixed: dict[str, np.ndarray],
) -> dict[str, torch.Tensor]:
    """Merge learned parameters (columns of `y_hat`, `(M, N, D)`) with fixed
    per-trajectory values: a learned value overrides a fixed one, and a
    learned `g` gives `g_z`."""
    M, N = y_hat.shape[:2]
    dev = y_hat.device
    out: dict[str, torch.Tensor] = {}
    for k in _SIM_KEYS:
        if k in mapping or (k == "g_z" and "g" in mapping):
            out[k] = y_hat[..., mapping[k if k in mapping else "g"]]
        elif k in fixed:
            out[k] = torch.as_tensor(np.asarray(fixed[k], np.float32), device=dev).broadcast_to((M, N))
        else:
            out[k] = torch.zeros((M, N), device=dev)
    return out


def resimulate(
    model: Any,
    params: Any,
    T: float,
    dt: float,
    data_dict: dict[str, Any],
    y_hat: np.ndarray | torch.Tensor | None = None,
    *conditions: torch.Tensor,
    m_samples: int = 1000,
    break_on_impact: bool = False,
    generator: torch.Generator | None = None,
    sample_batch_size: int = 250,
    verbose: bool = False,
    device: str | torch.device | None = None,
    mesh: Any = None,
) -> np.ndarray:
    """Sample posteriors and re-run the simulator on `device` (default CUDA;
    the params must live there); returns `(N, M, T, 3)`.

    Without `y_hat`, `m_samples` draws per condition row come from
    `model.sample` in chunks of `sample_batch_size`, from `generator`
    (default: seed 0 on `device`).

    With `mesh` (`bcnf_tpu/simulation/resimulation.py:67-111`; without one,
    a mesh of one shard on `device`) the condition rows are sharded over the mesh and the params replicated; each chunk of
    draws is drawn once for all rows (`sample_sharded`), so the draws are one
    device's. The resimulation grid is sharded over its N axis, each shard
    integrating its trajectories on its device, and gathered in shard order.
    """
    mesh = mesh if mesh is not None else Mesh([resolve_device(device)])
    dev = mesh.devices[0]
    mapping: ParameterIndexMapping = model.parameter_index_mapping
    if y_hat is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        replicas = replicate(mesh, params)
        chunks = []
        drawn = 0
        with torch.no_grad():
            while drawn < m_samples:
                m = min(sample_batch_size, m_samples - drawn)
                chunks.append(sample_sharded(mesh, model, replicas, generator, m, *conditions))
                drawn += m
        y_hat = torch.cat(chunks, dim=0)  # (M, N, D)
    y_hat = torch.as_tensor(y_hat, dtype=torch.float32).to(dev)

    M, N = y_hat.shape[:2]
    fixed = {
        k: np.asarray(v)
        for k, v in data_dict.items()
        if k in _SIM_KEYS and k not in mapping.parameters
    }
    if verbose:
        print(f"Resimulating {N} trajectories {M} times on {mesh}")

    def run(y_hat: torch.Tensor, fixed: dict[str, np.ndarray]) -> torch.Tensor:
        p = _assemble(y_hat, mapping, fixed)

        def vec(name: str) -> torch.Tensor:
            return torch.stack([p[f"{name}_x"], p[f"{name}_y"], p[f"{name}_z"]], dim=-1)

        # n_substeps=4: posterior samples can land in the stiff-drag regime where
        # single-step RK4 at the frame dt is unstable (see the note in sampling.py)
        X = simulate_trajectory(
            vec("x0"), vec("v0"), vec("g"), vec("w"), p["b"], p["m"], p["rho"], p["r"], vec("a"),
            n_steps=n_steps_for(T, dt), dt=dt, break_on_impact=break_on_impact, n_substeps=4,
        )  # (M, N, T, 3)
        return X.transpose(0, 1)  # (N, M, T, 3)

    parts = [run(y_hat[:, s].contiguous().to(d), {k: v[s] if v.ndim else v for k, v in fixed.items()})
             for s, d in zip(batch_sharding(mesh, N), mesh.devices)]
    return gather(mesh, parts).cpu().numpy()


def impact_points(trajectories: np.ndarray) -> np.ndarray:
    """Impact points by the z sign change (the resimulation notebook's
    metric). Input `(..., T, 3)`; returns `(..., 3)` with NaN where no
    impact occurs."""
    z = trajectories[..., 2]
    below = z < 0
    first = np.argmax(below, axis=-1)  # 0 when never below
    hit = below.any(axis=-1) & (first > 0)
    i = np.maximum(first, 1)

    take = np.take_along_axis
    p_prev = take(trajectories, np.expand_dims(np.expand_dims(i - 1, -1), -1), axis=-2)[..., 0, :]
    p_next = take(trajectories, np.expand_dims(np.expand_dims(i, -1), -1), axis=-2)[..., 0, :]
    dz = p_next[..., 2] - p_prev[..., 2]
    frac = np.where(np.abs(dz) > 1e-12, -p_prev[..., 2] / np.where(np.abs(dz) > 1e-12, dz, 1.0), 0.0)
    poi = p_prev + frac[..., None] * (p_next - p_prev)
    # diverged (non-finite) trajectories can place inf in p_prev/p_next; a
    # non-finite crossing is "no impact", not an infinite impact point
    ok = hit[..., None] & np.isfinite(poi).all(axis=-1, keepdims=True)
    return np.where(ok, poi, np.nan)
