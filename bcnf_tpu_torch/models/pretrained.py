"""Pretrained-conditioner workflow (port of `bcnf_tpu/models/pretrained.py`).

`load_pretrained_features(params, path)` grafts a saved feature-network
subtree (from a `params.pkl` as either package's `train` writes it, or a
bare features subtree) into a fresh parameter tree. The structure and every
leaf's shape must match, else it raises as the JAX package does. The
Trainer honours ``training.pretrained_features: <path>`` (with
``{{BCNF_ROOT}}`` templating) and ``training.freeze_features: true``
(conditioner gradients zeroed: flow-only training).
"""

from __future__ import annotations

import pickle
from typing import Any

import numpy as np
import torch

from bcnf_tpu_torch.bridge import map_tree
from bcnf_tpu_torch.config import sub_root_path


def extract_features_subtree(tree: Any) -> Any:
    """Accept either a full CondRealNVP params tree (with a "features" key)
    or a bare feature-network subtree."""
    if isinstance(tree, dict) and "features" in tree:
        return tree["features"]
    return tree


def tree_structure(tree: Any) -> Any:
    """The tree's containers without its leaves: dict keys sorted, as
    `jax.tree.structure` orders them; a list and a tuple stay apart."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, tree_structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(tree_structure(v) for v in tree))
    return "*"


def load_pretrained_features(params: Any, path: str) -> Any:
    """Return `params` with `params["features"]` replaced by the pretrained
    subtree loaded from `path` (a pickle of a full params tree or a bare
    features subtree), on the device of the leaves it replaces. Structure
    and leaf shapes must match exactly."""
    if "features" not in params:
        raise ValueError("Model has no feature networks; cannot load pretrained features")
    with open(sub_root_path(path), "rb") as f:
        loaded = pickle.load(f)
    feats = extract_features_subtree(loaded)

    cur_struct, new_struct = tree_structure(params["features"]), tree_structure(feats)
    if cur_struct != new_struct:
        raise ValueError(
            f"Pretrained feature tree structure mismatch:\n  model:      {cur_struct}\n  pretrained: {new_struct}"
        )

    def graft(cur: torch.Tensor, new: Any) -> torch.Tensor:
        if tuple(cur.shape) != tuple(np.shape(new)):
            raise ValueError(
                f"Pretrained feature leaf shape mismatch: model {tuple(cur.shape)} vs pretrained {tuple(np.shape(new))}"
            )
        return torch.as_tensor(np.asarray(new)).to(cur.device)

    out = dict(params)
    out["features"] = map_tree(graft, params["features"], feats)  # leaf by leaf, by key
    return out
