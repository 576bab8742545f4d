"""Training-data assembly: load, split, device batches (port of `bcnf_tpu/train/data.py`).

`TrainerDataHandler.get_data_for_training` loads a dataset pickle (or a
directory of shards) and assembles the condition tensors and the theta
matrix. Generating missing data needs the simulator, which is not ported
yet: a missing dataset raises. `split_dataset` is the JAX package's seeded
shuffled split, index for index. `DeviceDataset` holds the dataset in device
memory and gathers batches there, as the JAX package's does; training never
copies a batch from the host.
"""

from __future__ import annotations

import os
from typing import Iterator, Sequence

import numpy as np
import torch

from bcnf_tpu_torch.config import ParameterIndexMapping
from bcnf_tpu_torch.utils.io import load_data

_NUMPY_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


class TrainerDataHandler:
    def get_data_for_training(
        self,
        config: dict,
        parameter_index_mapping: ParameterIndexMapping,
        dtype: torch.dtype = torch.float32,
        errors: str = "raise",
        verbose: bool = False,
    ) -> tuple[np.ndarray, list[np.ndarray]]:
        """Returns `(y, conditions)` as NumPy arrays.

        Conditions come from the `config.global.conditions` key groups
        (reference `trainer_data_handler.py:75-85`; 1-D values get a trailing
        feature axis) and theta from `ParameterIndexMapping.vectorize` (`:86`).
        """
        if dtype not in _NUMPY_DTYPES:
            raise NotImplementedError(f"dataset dtype {dtype} is not supported by the port yet")
        np_dtype = _NUMPY_DTYPES[dtype]
        data_cfg = config["data"]
        path = data_cfg["path"]
        if not os.path.exists(path) or (os.path.isdir(path) and len(os.listdir(path)) == 0):
            raise FileNotFoundError(
                f"No data found at {path}; data generation waits for the simulator slice"
            )
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
                value = np.asarray(data[c], dtype=np_dtype)
                if value.ndim == 1:
                    value = value[:, None]
                condition_values.append(value)
            conditions.append(np.concatenate(condition_values, axis=1))
        y = np.asarray(parameter_index_mapping.vectorize(data), dtype=np_dtype)

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
