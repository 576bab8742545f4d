"""Error types for the bcnf_tpu_torch port (a copy of `bcnf_tpu/errors.py`).

Parity: reference `src/bcnf/errors.py:1` defines `TrainingDivergedError` used by
the trainer (`src/bcnf/train/trainer.py:168-169`) and cross-validation
(`src/bcnf/eval/crossvalidate.py:78-84`).
"""


class TrainingDivergedError(Exception):
    """Raised when the training loss explodes or becomes NaN."""


class ConfigError(Exception):
    """Raised for malformed or inconsistent run/data configurations."""
