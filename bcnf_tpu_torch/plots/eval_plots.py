"""Evaluation figures: calibration and resimulation diagnostics (port of
`bcnf_tpu/plots/eval_plots.py`).

Rank histograms with a binomial band, CDF residuals against the
Brownian-bridge bands, trajectory overlays and impact-point heatmaps.
matplotlib is imported when a figure is drawn, with the Agg backend, so
importing this module never needs it.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from bcnf_tpu_torch.eval.calibration import brownian_confidence_interval
from bcnf_tpu_torch.plots.base import pyplot as _pyplot


def plot_rank_histograms(
    ranks: np.ndarray,
    M_samples: int,
    parameter_names: list[str] | None = None,
    n_bins: int = 32,
    confidence: float = 0.99,
) -> Any:
    """Per-parameter rank histograms with a binomial confidence band
    (the calibration protocol: 32 bins, 99% band)."""
    from scipy.stats import binom

    plt = _pyplot()
    ranks = np.asarray(ranks)
    N, D = ranks.shape
    names = parameter_names or [f"theta_{i}" for i in range(D)]
    rows = int(np.ceil(D / 5))
    fig, axes = plt.subplots(rows, 5, figsize=(15, 2.4 * rows), squeeze=False)
    expected = N / n_bins
    lo = binom.ppf((1 - confidence) / 2, N, 1 / n_bins)
    hi = binom.ppf(1 - (1 - confidence) / 2, N, 1 / n_bins)
    edges = np.linspace(0, M_samples + 1, n_bins + 1)
    for d in range(D):
        ax = axes[d // 5][d % 5]
        ax.hist(ranks[:, d], bins=edges, color="tab:blue", alpha=0.8)
        ax.axhline(expected, color="k", lw=0.8)
        ax.axhspan(lo, hi, color="gray", alpha=0.3)
        ax.set_title(names[d], fontsize=8)
    for d in range(D, rows * 5):
        axes[d // 5][d % 5].axis("off")
    fig.suptitle("Posterior rank histograms (uniform = calibrated)")
    fig.tight_layout()
    return fig


def plot_cdf_residuals(
    t: np.ndarray,
    scaled_residuals: np.ndarray,
    parameter_names: list[str] | None = None,
    sigmas: tuple[float, ...] = (1.0, 2.0, 3.0),
) -> Any:
    """CDF residuals against Brownian-bridge confidence bands
    (`compute_CDF_residuals`' output)."""
    plt = _pyplot()
    D = scaled_residuals.shape[0]
    names = parameter_names or [f"theta_{i}" for i in range(D)]
    fig, ax = plt.subplots(figsize=(8, 5))
    band = brownian_confidence_interval(t)
    for s in sigmas:
        ax.fill_between(t, -s * band, s * band, color="gray", alpha=0.15)
    for d in range(D):
        ax.plot(t, scaled_residuals[d], lw=1, label=names[d])
    ax.set_xlabel("t")
    ax.set_ylabel("scaled CDF residual")
    ax.legend(fontsize=6, ncol=3)
    fig.suptitle("Calibration: CDF residuals vs Brownian-bridge bands")
    return fig


def plot_resimulation(
    X_true: np.ndarray,
    X_resim: np.ndarray,
    index: int = 0,
    max_draws: int = 50,
) -> Any:
    """Overlay resimulated trajectories on the true one."""
    plt = _pyplot()
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")
    for j in range(min(max_draws, X_resim.shape[1])):
        t = X_resim[index, j]
        ax.plot(t[:, 0], t[:, 1], t[:, 2], color="tab:orange", alpha=0.15, lw=0.8)
    t = X_true[index]
    ax.plot(t[:, 0], t[:, 1], t[:, 2], color="tab:blue", lw=2, label="true")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    ax.legend()
    fig.suptitle("Posterior predictive resimulation")
    return fig


def plot_impact_heatmap(
    poi_resim: np.ndarray,
    poi_true: np.ndarray | None = None,
    index: int = 0,
    bins: int = 40,
) -> Any:
    """Impact-point heatmap over posterior draws."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 5))
    pts = poi_resim[index]
    pts = pts[np.isfinite(pts).all(axis=-1)]
    if len(pts):
        ax.hist2d(pts[:, 0], pts[:, 1], bins=bins, cmap="hot")
    if poi_true is not None and np.isfinite(poi_true[index]).all():
        ax.plot(poi_true[index, 0], poi_true[index, 1], "c*", ms=15, label="true impact")
        ax.legend()
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    fig.suptitle("Impact-point posterior heatmap")
    return fig
