"""Simulation-based calibration metrics (port of `bcnf_tpu/eval/calibration.py`).

Posterior-sample rank statistics, empirical-CDF residuals scaled by
sqrt(N), and the Brownian-bridge confidence band. The NumPy functions are
copies of the JAX package's, quirks included; `compute_y_hat_ranks` draws
on the device and sums the ranks there.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from bcnf_tpu_torch.parallel.mesh import Mesh, replicate, sample_sharded
from bcnf_tpu_torch.utils.misc import resolve_device


def CDF(sorted_array_indices: np.ndarray, t: np.ndarray, M: int) -> np.ndarray:
    """Empirical CDF of ranks evaluated at fractions `t`."""
    N = sorted_array_indices.shape[0]
    t = t * M
    return np.sum(sorted_array_indices[:, :, None] <= t[None, None, :], axis=0) / N


def brownian_confidence_interval(t: np.ndarray) -> np.ndarray:
    """sqrt(t(1-t)) Brownian-bridge band."""
    return np.sqrt(t * (1 - t))


def kolmogorov_quantile(q: float) -> float:
    """Quantile of the Kolmogorov distribution — sup_t |B(t)| of a Brownian
    bridge, the asymptotic law of the scaled CDF residual's sup. Solved by
    bisection on the series CDF `1 - 2 sum_j (-1)^(j-1) exp(-2 j^2 x^2)`.
    `kolmogorov_quantile(0.99) ~= 1.628`, the per-dimension 99% band."""
    j = np.arange(1, 101, dtype=np.float64)

    def cdf(x: float) -> float:
        return float(1.0 - 2.0 * np.sum((-1.0) ** (j - 1) * np.exp(-2.0 * j**2 * x**2)))

    lo, hi = 1e-6, 5.0
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if cdf(mid) < q:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def sidak_joint_band(n_dims: int, family_confidence: float = 0.99) -> float:
    """Multiple-comparison-corrected sup-residual band: the per-dimension
    threshold such that, under perfect calibration and (Sidak-) independent
    dimensions, all `n_dims` sup-residuals stay below it at once with
    probability `family_confidence`."""
    per_dim_conf = family_confidence ** (1.0 / max(int(n_dims), 1))
    return kolmogorov_quantile(per_dim_conf)


def compute_y_hat_ranks(
    model: Any,
    params: Any,
    y: np.ndarray | torch.Tensor,
    *conditions: np.ndarray | torch.Tensor,
    M_samples: int = 10_000,
    generator: torch.Generator | None = None,
    sample_batch_size: int = 1000,
    batch_size: int = 100,
    device: str | torch.device | None = None,
    mesh: Any = None,
) -> np.ndarray:
    """Rank of each true theta among M posterior samples, shape `(N, D)`.

    Batched over condition rows (`batch_size`) and draws
    (`sample_batch_size`): each `model.sample` call encodes its condition
    rows once. The ranks of a condition batch are summed on `device`
    (default CUDA; the params must live there) in int64 and copied to the
    host once. Draws come from `generator` (default: seed 0 on `device`).

    With `mesh` (`bcnf_tpu/eval/calibration.py:72-109`; without one, a mesh
    of one shard on `device`) each condition batch's rows are sharded over
    the mesh (they must divide evenly) and the params replicated; each batch
    of draws is drawn once for all its rows and each shard samples its rows
    (`sample_sharded`). The draws are one device's, so the ranks are the
    single-device run's: exactly where the shards' products round as one
    device's (the CPU), and but for a sample within that rounding of its
    true value on a card.
    """
    mesh = mesh if mesh is not None else Mesh([resolve_device(device)])
    dev = mesh.devices[0]
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    y = torch.as_tensor(y).to(dev)
    conditions = tuple(torch.as_tensor(c).to(dev) for c in conditions)
    N = y.shape[0]
    ranks = np.zeros(tuple(y.shape), dtype=np.int64)
    replicas = replicate(mesh, params)
    with torch.no_grad():
        for b in range(0, N, batch_size):
            cond_b = [c[b: b + batch_size] for c in conditions]
            y_b = y[b: b + batch_size]
            acc = torch.zeros(y_b.shape, dtype=torch.int64, device=dev)
            drawn = 0
            while drawn < M_samples:
                m = min(sample_batch_size, M_samples - drawn)
                samples = sample_sharded(mesh, model, replicas, generator, m, *cond_b)
                acc += (samples < y_b[None]).sum(dim=0)
                drawn += m
            ranks[b: b + batch_size] = acc.cpu().numpy()
    return ranks


def compute_CDF_residuals(
    y_hat_all_sorted_ranks: np.ndarray,
    M_samples: int,
    t_divisions: int = 100,
    sigma: float = 1.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(t, scaled residuals, Brownian CI)."""
    N_samples = y_hat_all_sorted_ranks.shape[0]
    t_linspace = np.linspace(0, 1, t_divisions)
    cdf = CDF(np.asarray(y_hat_all_sorted_ranks), t_linspace, M_samples)
    residuals = cdf - t_linspace
    scaled_residuals = residuals * np.sqrt(N_samples) / sigma
    confidence_interval = brownian_confidence_interval(t_linspace)
    return t_linspace, scaled_residuals, confidence_interval


def rank_histogram(ranks: np.ndarray, M_samples: int, n_bins: int = 32) -> np.ndarray:
    """Per-dimension rank histograms (the calibration notebook's 32-bin protocol)."""
    ranks = np.asarray(ranks)
    edges = np.linspace(0, M_samples + 1, n_bins + 1)
    return np.stack([np.histogram(ranks[:, d], bins=edges)[0] for d in range(ranks.shape[1])])
