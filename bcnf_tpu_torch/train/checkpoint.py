"""Epoch-level checkpoint/resume (port of `bcnf_tpu/train/checkpoint.py`).

A checkpoint is one pickle, written atomically (temporary file, then
`os.replace`): the params as a NumPy tree (the format `params.pkl` has), the
optimizer's `state_dict`, the scheduler, the epoch and the random generator's
state. Tensors are moved to the host before pickling, so a checkpoint written
on the card loads on a host without one.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any

import torch


def _to_host(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def save_checkpoint(path: str, state: dict[str, Any], metadata: dict | None = None) -> None:
    """Atomically pickle a training state, with an optional JSON sidecar."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(_to_host(state), f, pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    if metadata is not None:
        meta_tmp = path + ".meta.tmp"
        with open(meta_tmp, "w") as f:
            json.dump(metadata, f, indent=2, default=str)
        os.replace(meta_tmp, path + ".meta.json")


def load_checkpoint(path: str) -> dict[str, Any]:
    """Read a checkpoint this module wrote (it unpickles: trusted files only)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def latest_checkpoint(directory: str, prefix: str = "ckpt_") -> str | None:
    """Find the newest `<prefix><step>.pkl` in a directory (`bcnf_tpu/train/checkpoint.py:47-60`)."""
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        if name.startswith(prefix) and name.endswith(".pkl"):
            try:
                step = int(name[len(prefix):-4])
            except ValueError:
                continue
            if step > best_step:
                best, best_step = name, step
    return os.path.join(directory, best) if best else None
