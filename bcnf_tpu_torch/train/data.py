"""Training-data assembly, load path only (port of `bcnf_tpu/train/data.py:29-99`).

`TrainerDataHandler.get_data_for_training` loads a dataset pickle (or a
directory of shards) and assembles the condition tensors and the theta
matrix. Generating missing data needs the simulator, which is not ported
yet; the seeded split and device batching belong to the training slice.
"""

from __future__ import annotations

import os

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
