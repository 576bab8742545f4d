"""HPO driver: GP-minimize over flow/conditioner hyperparameters with k-fold
cross-validation as the objective, checkpointed per iteration (port of
`bcnf_tpu/hpo/driver.py`, the reference's
`notebooks/optimize_hyperparameters.ipynb` workflow).

The search space, its `space_bounds` overrides, the model each point builds
(`ConcatenateCondition` -> a one-layer bidirectional `LSTM` of hidden size 48,
mean-pooled -> `CondRealNVP`), the score (the mean validation loss of the
folds that did not diverge, 1e6 if none) and the files (`hpo_checkpoint.pkl`,
`best.json`) are the JAX package's, so a search the JAX package
checkpointed resumes here. The folds train on `device` (default CUDA).
Re-running with the same output directory resumes.
"""

from __future__ import annotations

import json
import os
from typing import Any, Sequence

import numpy as np
import torch

from bcnf_tpu_torch.config import ParameterIndexMapping

DEFAULT_PARAMS = [
    "x0_x", "x0_y", "x0_z", "v0_x", "v0_y", "v0_z", "g",
    "w_x", "w_y", "w_z", "b", "m", "a_x", "a_y", "a_z", "r", "A", "Cd", "rho",
]


def run_hpo(
    data_path: str,
    output_dir: str,
    n_calls: int = 25,
    n_initial_points: int = 8,
    n_splits: int = 3,
    n_epochs: int = 60,
    n_samples: int = 1000,
    batch_size: int = 128,
    seed: int = 0,
    parameter_names: Sequence[str] | None = None,
    space_bounds: dict[str, Sequence[float]] | None = None,
    verbose: bool = True,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """GP-optimize the flow architecture on `data_path`; returns the best
    point. State checkpoints to `<output_dir>/hpo_checkpoint.pkl` every
    iteration (resume by re-calling with the same arguments)."""
    from bcnf_tpu_torch.eval.crossvalidate import cross_validate
    from bcnf_tpu_torch.hpo.gp_minimize import Integer, Real, gp_minimize_fixed
    from bcnf_tpu_torch.models import ConcatenateCondition, CondRealNVP, FeatureNetworkStack, LSTMFeatureNetwork
    from bcnf_tpu_torch.utils.io import load_data
    from bcnf_tpu_torch.utils.misc import resolve_device

    dev = resolve_device(device)
    params_names = list(parameter_names or DEFAULT_PARAMS)
    data = load_data(data_path)
    pim = ParameterIndexMapping(params_names)
    y = np.asarray(pim.vectorize(data), dtype=np.float32)[:n_samples]
    trajectories = np.asarray(data["trajectories"], dtype=np.float32)[:n_samples]

    # the reference's stage-1 search space (its results/hyperparameters/
    # stage_1.csv columns); `space_bounds` overrides {name: (low, high)}, the
    # stage-2 refinement around stage 1's best points
    defaults = {
        "n_blocks": (6, 32), "nested_width": (16, 256),
        "n_nested_layers": (2, 6), "n_conditions": (32, 256),
        "lr": (1e-4, 3e-3), "dropout": (0.0, 0.5),
    }
    b = {**defaults, **(space_bounds or {})}
    unknown = set(b) - set(defaults)
    if unknown:
        raise ValueError(f"unknown space dimensions: {sorted(unknown)}")
    space = [
        Integer(int(b["n_blocks"][0]), int(b["n_blocks"][1]), name="n_blocks"),
        Integer(int(b["nested_width"][0]), int(b["nested_width"][1]), name="nested_width"),
        Integer(int(b["n_nested_layers"][0]), int(b["n_nested_layers"][1]), name="n_nested_layers"),
        Integer(int(b["n_conditions"][0]), int(b["n_conditions"][1]), name="n_conditions"),
        Real(float(b["lr"][0]), float(b["lr"][1]), prior="log-uniform", name="lr"),
        Real(float(b["dropout"][0]), float(b["dropout"][1]), name="dropout"),
    ]

    def objective(x: list) -> float:
        n_blocks, width, depth, n_cond, lr, dropout = x

        def factory() -> CondRealNVP:
            stack = FeatureNetworkStack([
                ConcatenateCondition(input_size=None, output_size=3),
                LSTMFeatureNetwork(input_size=3, hidden_size=48, output_size=int(n_cond),
                                   num_layers=1, bidirectional=True, pooling="mean"),
            ])
            return CondRealNVP(
                size=len(params_names),
                nested_sizes=[int(width)] * int(depth),
                n_blocks=int(n_blocks),
                n_conditions=int(n_cond),
                feature_network_stack=stack,
                act_norm=True,
                dropout=float(dropout),
                random_state=seed,
            )

        folds = cross_validate(
            factory, y, [trajectories],
            n_splits=n_splits, n_epochs=n_epochs,
            batch_size=batch_size, lr=float(lr),
            random_state=seed, errors="return", device=dev,
        )
        losses = [f["val_loss"] for f in folds if np.isfinite(f.get("val_loss", np.inf))]
        score = float(np.mean(losses)) if losses else 1e6  # diverged -> bad point
        if verbose:
            print(f"x={x} -> CV val loss {score:.3f} ({len(losses)}/{n_splits} folds ok)")
        return score

    os.makedirs(output_dir, exist_ok=True)
    result = gp_minimize_fixed(
        objective, space,
        n_calls=n_calls, n_initial_points=n_initial_points,
        checkpoint_file=os.path.join(output_dir, "hpo_checkpoint.pkl"),
        random_state=seed, verbose=verbose,
    )
    best = dict(zip([d.name for d in space], result.x))
    summary = {
        "best_params": best,
        "best_val_loss": float(result.fun),
        "n_evaluations": int(len(result.func_vals)),
    }
    with open(os.path.join(output_dir, "best.json"), "w") as f:
        json.dump(summary, f, indent=2, default=float)
    if verbose:
        print("best:", best, "val loss:", result.fun)
    return summary
