"""Plot base class (port of `bcnf_tpu/plots/base.py`, reference
`src/bcnf/plots/core/base_plot.py:10-104`). matplotlib and pandas are imported
when a figure is drawn, not with the module."""

from __future__ import annotations

import os
from abc import ABC, abstractmethod
from typing import Any


def pyplot() -> Any:
    """matplotlib's pyplot on the Agg backend, imported at first use."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class BasePlot(ABC):
    """create/save/show contract over a DataFrame of samples."""

    def __init__(self, data: Any) -> None:
        self.data = data  # a pandas DataFrame
        self.column_names = list(data.columns)
        self.columns_count = len(self.column_names)
        self.figs: list[Any] = []

    @abstractmethod
    def create_plots(self) -> None: ...

    def save_plots(self, filepath: str, base_filename: str) -> None:
        os.makedirs(filepath, exist_ok=True)
        for i, fig in enumerate(self.figs):
            fig.savefig(os.path.join(filepath, f"{base_filename}_{i}.png"), dpi=300)

    def show_plots(self) -> None:
        for fig in self.figs:
            fig.show()
