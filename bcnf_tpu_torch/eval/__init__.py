"""Evaluation: calibration (port of `bcnf_tpu/eval/`; cross-validation waits
for a later slice)."""

from bcnf_tpu_torch.eval.calibration import (
    CDF,
    brownian_confidence_interval,
    compute_CDF_residuals,
    compute_y_hat_ranks,
    rank_histogram,
)

__all__ = [
    "CDF",
    "brownian_confidence_interval",
    "compute_y_hat_ranks",
    "compute_CDF_residuals",
    "rank_histogram",
]
