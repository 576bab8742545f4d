"""Dataset IO: pickle shard loading/saving with key aliasing (a copy of
`bcnf_tpu/utils/io.py`).

Parity: reference `src/bcnf/utils.py:199-290` (`load_data`): loads a pickle
file or a directory of pickle shards into a dict-of-lists, renaming legacy
keys (`traj`/`trajectory` -> `trajectories`, `render`/`cams` -> `videos`,
reference `src/bcnf/utils.py:219-222`) and validating equal lengths
(reference `src/bcnf/utils.py:281-288`).
"""

from __future__ import annotations

import os
import pickle
from typing import Any

EQUIVALENT_KEYS: dict[str, list[str]] = {
    "trajectories": ["traj", "trajectory"],
    "videos": ["render", "cams"],
}


def _canonicalize(data: dict[str, Any], verbose: bool = False) -> dict[str, Any]:
    for key, equivalents in EQUIVALENT_KEYS.items():
        for e in equivalents:
            if e in data:
                if verbose:
                    print(f'Renaming key "{e}" to "{key}".')
                data[key] = data.pop(e)
    return data


def load_data(
    path: str,
    keep_output_type: str | None = None,
    n_files: int | None = None,
    verbose: bool = False,
    errors: str = "raise",
) -> dict[str, list]:
    """Load a dataset from a pickle file or directory of pickle shards."""
    if os.path.isfile(path):
        with open(path, "rb") as f:
            data = _canonicalize(pickle.load(f), verbose)
    else:
        data = {}
        files = sorted(os.listdir(path))
        if n_files is not None:
            files = files[:n_files]
        for fname in files:
            with open(os.path.join(path, fname), "rb") as f:
                file_data = _canonicalize(pickle.load(f), verbose)
            for key, value in file_data.items():
                data.setdefault(key, []).extend(value)

    if keep_output_type is not None and keep_output_type in EQUIVALENT_KEYS:
        for key in EQUIVALENT_KEYS:
            if key != keep_output_type and key in data:
                data.pop(key)

    lengths = {k: len(v) for k, v in data.items()}
    if len(set(lengths.values())) > 1:
        msg = f"All values must have the same length; got {lengths}"
        if errors == "raise":
            raise ValueError(msg)
        if errors in ("print", "warn"):
            print(f"Warning: {msg}")

    return data


def save_data(data: dict[str, Any], path: str) -> None:
    """Pickle a dataset dict, creating parent directories."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(data, f, pickle.HIGHEST_PROTOCOL)
