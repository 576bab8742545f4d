"""Training-data assembly: load, split, device batches (port of `bcnf_tpu/train/data.py`).

`TrainerDataHandler.get_data_for_training` generates the dataset with the
port's simulator when `data.path` holds none (and saves it there), else
loads a dataset pickle (or a directory of shards); then it assembles the
condition tensors and the theta matrix. `split_dataset` is the JAX package's seeded
shuffled split, index for index. `DeviceDataset` holds the dataset in device
memory and gathers batches there, as the JAX package's does; training never
copies a batch from the host.
"""

from __future__ import annotations

import os
from typing import Any, Iterator, Sequence

import numpy as np
import torch

from bcnf_tpu_torch.config import ParameterIndexMapping
from bcnf_tpu_torch.simulation.sampling import generate_data
from bcnf_tpu_torch.utils.io import load_data, save_data

_NUMPY_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _as_dtype(value: Any, dtype: torch.dtype) -> np.ndarray:
    """`value` as a NumPy array of `dtype`, as the JAX package's
    `np.asarray(value, dtype)` gives it. NumPy has no bfloat16: a bfloat16
    dataset's values are rounded to it (to nearest even, the cast JAX's
    takes) and held in float32, which float32 parameters promote them to
    in every product, as they do in JAX."""
    if dtype == torch.bfloat16:
        return torch.from_numpy(np.array(value)).to(torch.bfloat16).to(torch.float32).numpy()
    return np.asarray(value, dtype=_NUMPY_DTYPES[dtype])


class TrainerDataHandler:
    def get_data_for_training(
        self,
        config: dict,
        parameter_index_mapping: ParameterIndexMapping,
        dtype: torch.dtype = torch.float32,
        errors: str = "raise",
        verbose: bool = False,
        seed: int | None = None,
        device: str | torch.device | None = None,
    ) -> tuple[np.ndarray, list[np.ndarray]]:
        """Returns `(y, conditions)` as NumPy arrays.

        Generate-if-missing (`bcnf_tpu/train/data.py:49-68`): with no data
        at `data.path`, the `data` section's prior, size and grid are
        simulated on `device` (default CUDA) from `seed` and saved there
        (a path without an extension is a directory and gets
        `data.data_name`, default `data.pkl`); else the pickle or its
        shards are loaded. Conditions come from the `config.global.conditions` key groups
        (reference `trainer_data_handler.py:75-85`; 1-D values get a trailing
        feature axis) and theta from `ParameterIndexMapping.vectorize` (`:86`).
        """
        if dtype not in (*_NUMPY_DTYPES, torch.bfloat16):
            raise ValueError(f"dataset dtype {dtype} is not one of float32, float64, bfloat16")
        data_cfg = config["data"]
        path = data_cfg["path"]
        if not os.path.exists(path) or (os.path.isdir(path) and len(os.listdir(path)) == 0):
            if verbose:
                print(f"No data found at {path}. Generating data...")
            data = generate_data(
                config_file=data_cfg["config_file"],
                n=data_cfg["n_samples"],
                output_type=data_cfg["output_type"],
                dt=data_cfg["dt"],
                T=data_cfg["T"],
                num_cams=data_cfg.get("num_cams", 2),
                break_on_impact=data_cfg.get("break_on_impact", True),
                do_filter=data_cfg.get("do_filter", True),
                verbose=data_cfg.get("verbose", verbose),
                observation_noise=float(data_cfg.get("observation_noise", 0.0)),
                seed=seed,
                device=device,
            )
            target = path if os.path.splitext(path)[1] != "" else os.path.join(
                path, data_cfg.get("data_name", "data.pkl")
            )
            save_data(data, target)
        else:
            if verbose:
                print(f"Loading data from {path}...")
            data = load_data(
                path=path,
                keep_output_type=data_cfg["output_type"],
                n_files=data_cfg.get("n_files"),
                verbose=verbose,
                errors=errors,
            )

        # condition-key aliases: run configs say `cam_radian`
        # (reference `configs/runs/dev/videos_CNN_LSTM_large.yaml:6`) while the
        # generator emits `cam_radian_array` (reference `sampling.py:276`)
        key_aliases = {"cam_radian": "cam_radian_array", "cam_radian_array": "cam_radian"}
        conditions = []
        for condition_keys in config["global"]["conditions"]:
            condition_values = []
            for c in condition_keys:
                if c not in data and c in key_aliases and key_aliases[c] in data:
                    c = key_aliases[c]
                value = _as_dtype(data[c], dtype)
                if value.ndim == 1:
                    value = value[:, None]
                condition_values.append(value)
            conditions.append(np.concatenate(condition_values, axis=1))
        y = _as_dtype(parameter_index_mapping.vectorize(data), dtype)

        if verbose:
            print(f"Conditions: {[c.shape for c in conditions]}; Parameters: {y.shape}")
        return y, conditions

    @staticmethod
    def split_dataset(
        y: np.ndarray,
        conditions: Sequence[np.ndarray],
        split_ratio: float,
        seed: int = 0,
    ) -> tuple[tuple, tuple]:
        """Seeded shuffled train/val split (`bcnf_tpu/train/data.py:101-116`,
        the SURVEY.md Q2 fix): numpy's generator, so the same indices."""
        n = len(y)
        perm = np.random.default_rng(seed).permutation(n)
        n_val = int(round(split_ratio * n))
        val_idx, train_idx = perm[:n_val], perm[n_val:]
        train = (y[train_idx], [c[train_idx] for c in conditions])
        val = (y[val_idx], [c[val_idx] for c in conditions])
        return train, val


class DeviceDataset:
    """A dataset held in device memory with batches gathered on the device
    (`bcnf_tpu/train/data.py:119-173`)."""

    def __init__(self, y: np.ndarray, conditions: Sequence[np.ndarray], device: torch.device) -> None:
        self.y = torch.from_numpy(np.ascontiguousarray(y)).to(device)
        self.conditions = [torch.from_numpy(np.ascontiguousarray(c)).to(device) for c in conditions]
        self.n = len(y)

    def _take(self, idx: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        return self.y.index_select(0, idx), [c.index_select(0, idx) for c in self.conditions]

    def batches(
        self,
        batch_size: int,
        generator: torch.Generator | None = None,
        drop_remainder: bool = False,
    ) -> Iterator[tuple[torch.Tensor, list[torch.Tensor]]]:
        """Yield `(y, conditions)` batches, shuffled by `torch.randperm` from
        `generator` when one is given (drawn on the generator's device)."""
        if generator is not None:
            perm = torch.randperm(self.n, generator=generator, device=generator.device).to(self.y.device)
        else:
            perm = torch.arange(self.n, device=self.y.device)
        n_full = self.n // batch_size
        for i in range(n_full):
            yield self._take(perm[i * batch_size:(i + 1) * batch_size])
        if self.n > n_full * batch_size and not drop_remainder:
            yield self._take(perm[n_full * batch_size:])

    def batches_padded(self, batch_size: int) -> Iterator[tuple[torch.Tensor, list[torch.Tensor], torch.Tensor]]:
        """Yield `(y, conditions, weights)`, every batch `batch_size` rows:
        pad rows wrap around to the start of the dataset and weigh 0, so
        weighted means give exact metrics."""
        n_total = ((self.n + batch_size - 1) // batch_size) * batch_size
        pos = torch.arange(n_total, device=self.y.device)
        idx_all, w_all = pos % self.n, (pos < self.n).to(torch.float32)
        for i in range(n_total // batch_size):
            sl = slice(i * batch_size, (i + 1) * batch_size)
            y, conditions = self._take(idx_all[sl])
            yield y, conditions, w_all[sl]

    def n_batches(self, batch_size: int, drop_remainder: bool = False) -> int:
        if drop_remainder:
            return self.n // batch_size
        return (self.n + batch_size - 1) // batch_size
