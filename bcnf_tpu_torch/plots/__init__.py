"""Figures (port of `bcnf_tpu/plots/`: the dataset figures, the evaluation
figures, and the debug plots in `plots/debug_plotting.py`). matplotlib and
pandas are imported only when a figure is drawn."""

from bcnf_tpu_torch.plots.base import BasePlot
from bcnf_tpu_torch.plots.data_plots import (
    DataConvariancePlot,
    DataCovariancePlot,
    DataDistributionPlot,
    corr_coeff,
    data_to_df,
)
from bcnf_tpu_torch.plots.eval_plots import (
    plot_cdf_residuals,
    plot_impact_heatmap,
    plot_rank_histograms,
    plot_resimulation,
)

__all__ = [
    "BasePlot",
    "DataCovariancePlot",
    "DataConvariancePlot",
    "DataDistributionPlot",
    "corr_coeff",
    "data_to_df",
    "plot_rank_histograms",
    "plot_cdf_residuals",
    "plot_resimulation",
    "plot_impact_heatmap",
]
