"""Dataset diagnostic figures (port of `bcnf_tpu/plots/data_plots.py`): the
correlation matrix and pairwise 2-D histograms with the reference's
all-zero-column convention, the per-parameter marginals, and `data_to_df`,
which explodes per-camera array columns into scalar columns. A copy of the
JAX package's NumPy code, with pandas and matplotlib imported when called.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from bcnf_tpu_torch.plots.base import BasePlot, pyplot


def corr_coeff(a: np.ndarray, b: np.ndarray) -> float:
    """Correlation with the reference's all-zero-column convention
    (reference `covariances.py:9-17`): both zero -> 1, one zero -> 0."""
    if np.all(a == 0) and np.all(b == 0):
        return 1.0
    if np.all(a == 0) or np.all(b == 0):
        return 0.0
    return float(np.corrcoef(a, b)[0, 1])


def data_to_df(data: dict[str, Any], pop_entries: Sequence[str] = ("trajectories", "videos")) -> Any:
    """Flatten a dataset dict into a scalar-column pandas DataFrame,
    exploding per-camera array columns (reference `data_to_df.py:9-40`)."""
    import pandas as pd

    data = {k: v for k, v in data.items() if k not in pop_entries}
    out: dict[str, list] = {}
    for key, values in data.items():
        first = np.asarray(values[0])
        if first.ndim == 0:
            out[key] = [float(v) for v in values]
        else:
            for i in range(first.shape[0]):
                out[f"{key}_{i}"] = [float(np.asarray(v)[i]) for v in values]
    return pd.DataFrame(out)


class DataCovariancePlot(BasePlot):
    """Correlation matrix + all-pairs 2-D histograms
    (reference `DataConvariancePlot`, `covariances.py:20-127`; the reference
    class name's typo is kept as an alias below)."""

    def create_plots(self, bins: int = 50) -> None:
        self._create_covariance_plot()
        self._create_all_pairs_plot(bins)

    def _create_covariance_plot(self) -> None:
        plt = pyplot()
        n = self.columns_count
        corr = np.ones((n, n))
        cols = [self.data.iloc[:, i].to_numpy() for i in range(n)]
        for i in range(n):
            for j in range(n):
                corr[i, j] = corr_coeff(cols[i], cols[j])
        fig, ax = plt.subplots(figsize=(0.5 * n + 2, 0.5 * n + 2))
        im = ax.matshow(corr, cmap="coolwarm", vmin=-1, vmax=1)
        ax.set_xticks(range(n))
        ax.set_xticklabels(self.column_names, rotation=90)
        ax.set_yticks(range(n))
        ax.set_yticklabels(self.column_names)
        fig.colorbar(im)
        fig.suptitle("Correlation of parameters for generated data")
        self.figs.append(fig)
        plt.close(fig)

    def _create_all_pairs_plot(self, bins: int = 50) -> None:
        plt = pyplot()
        n = self.columns_count
        rows = max(n // 5, 1)
        cols = n // rows + (n % rows > 0)
        for i, column_i in enumerate(self.column_names):
            fig, axes = plt.subplots(nrows=rows, ncols=cols, figsize=(10, 2 * rows), squeeze=False)
            for j, column_j in enumerate(self.column_names):
                ax = axes[j // cols][j % cols]
                ax.hist2d(self.data.iloc[:, i], self.data.iloc[:, j], bins=bins)
                ax.set_xlabel(column_i)
                ax.set_ylabel(column_j)
            fig.suptitle("Covariance of parameter pairs for generated data")
            fig.subplots_adjust(wspace=0.7, hspace=0.5)
            self.figs.append(fig)
            plt.close(fig)


# alias with the reference's (typo'd) class name for drop-in compatibility
DataConvariancePlot = DataCovariancePlot


class DataDistributionPlot(BasePlot):
    """Per-parameter marginal histograms (reference `data_distributions.py:7`)."""

    def create_plots(self, bins: int = 50) -> None:
        plt = pyplot()
        n = self.columns_count
        rows = max(n // 5, 1)
        cols = n // rows + (n % rows > 0)
        fig, axes = plt.subplots(nrows=rows, ncols=cols, figsize=(2.2 * cols, 2 * rows), squeeze=False)
        for j, column in enumerate(self.column_names):
            ax = axes[j // cols][j % cols]
            ax.hist(self.data[column], bins=bins)
            ax.set_title(column, fontsize=8)
        for j in range(n, rows * cols):
            axes[j // cols][j % cols].axis("off")
        fig.suptitle("Parameter distributions for generated data")
        fig.tight_layout()
        self.figs.append(fig)
        plt.close(fig)
