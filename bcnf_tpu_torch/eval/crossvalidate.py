"""K-fold cross-validation, the objective of the `hpo` search (port of
`bcnf_tpu/eval/crossvalidate.py`; reference `src/bcnf/eval/crossvalidate.py:12-94`).

Each fold builds a fresh model, initialises it from a CPU `torch.Generator`
seeded with the fold's index (where JAX uses `jax.random.key(i)`), trains it
with `train_CondRealNVP` (seed = the fold's index) on the `device` given,
and records its loss history. Folds are split with NumPy, as sklearn's
`KFold` splits them.
"""

from __future__ import annotations

from collections.abc import Callable, Iterator, Sequence
from typing import Any

import numpy as np
import torch

from bcnf_tpu_torch.errors import TrainingDivergedError
from bcnf_tpu_torch.train.trainer import train_CondRealNVP


def kfold_indices(n: int, n_splits: int, shuffle: bool = False,
                  random_state: int | None = None) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield (train_idx, val_idx) pairs, matching sklearn.KFold semantics."""
    indices = np.arange(n)
    if shuffle:
        rng = np.random.default_rng(random_state)
        rng.shuffle(indices)
    fold_sizes = np.full(n_splits, n // n_splits, dtype=int)
    fold_sizes[: n % n_splits] += 1
    current = 0
    for size in fold_sizes:
        val = indices[current: current + size]
        train = np.concatenate([indices[:current], indices[current + size:]])
        yield train, val
        current += size


def cross_validate(
    model_factory: Callable[[], Any],
    y: np.ndarray,
    conditions: Sequence[np.ndarray],
    n_splits: int = 5,
    n_epochs: int = 1,
    batch_size: int = 64,
    lr: float = 1e-3,
    val_loss_patience: int | None = None,
    val_loss_tolerance: float = 1e-3,
    val_loss_tolerance_mode: str = "rel",
    timeout: float | None = None,
    verbose: bool = False,
    shuffle: bool = False,
    random_state: int | None = None,
    errors: str = "raise",
    device: str | torch.device | None = None,
) -> list[dict[str, Any]]:
    """Train a fresh model per fold on `device` (default CUDA); returns the
    per-fold loss summaries (`loss_history`, `train_loss`, `val_loss`). A
    fold whose training diverges raises with `errors="raise"`, and is left
    out of the records otherwise."""
    fold_metrics: list[dict[str, Any]] = []
    for i, (train_index, val_index) in enumerate(kfold_indices(len(y), n_splits, shuffle, random_state)):
        model = model_factory()
        params = model.init(torch.Generator().manual_seed(i), device=device)
        try:
            params, history = train_CondRealNVP(
                model,
                params,
                y[train_index],
                [c[train_index] for c in conditions],
                y[val_index],
                [c[val_index] for c in conditions],
                n_epochs=n_epochs,
                batch_size=batch_size,
                lr=lr,
                val_loss_patience=val_loss_patience,
                val_loss_tolerance=val_loss_tolerance,
                val_loss_tolerance_mode=val_loss_tolerance_mode,
                timeout=timeout,
                verbose=verbose,
                seed=i,
                device=device,
            )
        except TrainingDivergedError as e:
            print(f"Error in fold {i}: {e}")
            if errors == "raise":
                raise
            continue

        fold_metrics.append(
            {
                "loss_history": history,
                "train_loss": history["train"][-1] if history["train"] else float("nan"),
                "val_loss": history["val"][-1] if history["val"] else float("nan"),
            }
        )
    return fold_metrics
