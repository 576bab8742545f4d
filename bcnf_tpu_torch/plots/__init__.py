"""Figures (port of `bcnf_tpu/plots/`: the evaluation figures, and the debug
plots in `plots/debug_plotting.py`; the data plots wait for a later slice).
matplotlib is imported only when a figure is drawn."""

from bcnf_tpu_torch.plots.eval_plots import (
    plot_cdf_residuals,
    plot_impact_heatmap,
    plot_rank_histograms,
    plot_resimulation,
)

__all__ = [
    "plot_rank_histograms",
    "plot_cdf_residuals",
    "plot_resimulation",
    "plot_impact_heatmap",
]
