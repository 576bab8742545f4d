"""Evaluation: calibration and k-fold cross-validation (port of `bcnf_tpu/eval/`)."""

from bcnf_tpu_torch.eval.calibration import (
    CDF,
    brownian_confidence_interval,
    compute_CDF_residuals,
    compute_y_hat_ranks,
    rank_histogram,
)
from bcnf_tpu_torch.eval.crossvalidate import cross_validate, kfold_indices

__all__ = [
    "CDF",
    "brownian_confidence_interval",
    "compute_y_hat_ranks",
    "compute_CDF_residuals",
    "rank_histogram",
    "cross_validate",
    "kfold_indices",
]
