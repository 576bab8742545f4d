"""Hyperparameter search (port of `bcnf_tpu/hpo/`): the checkpointable GP
minimizer and the `hpo` driver."""

from bcnf_tpu_torch.hpo.gp_minimize import (
    Categorical,
    GaussianProcess,
    Integer,
    OptimizeResult,
    Real,
    gp_minimize_fixed,
    load_checkpoint,
    save_checkpoint,
)

__all__ = [
    "Real",
    "Integer",
    "Categorical",
    "GaussianProcess",
    "OptimizeResult",
    "gp_minimize_fixed",
    "save_checkpoint",
    "load_checkpoint",
]
