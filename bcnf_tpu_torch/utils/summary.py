"""Model summaries (port of `bcnf_tpu/utils/summary.py`): a parameter-count
table by subtree of the port's parameter trees (dicts, lists and tensors;
anything with a `shape` counts, so NumPy trees and `torch.empty` trees on
the meta device do too)."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def param_tree_summary(params: Any, max_depth: int = 3) -> str:
    """Hierarchical parameter-count table of a parameter tree: the count
    under each path of at most `max_depth` keys, then the total."""
    rows: dict[str, int] = {}

    def walk(tree: Any, path: tuple[str, ...]) -> None:
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (str(k),))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, path + (str(i),))
        else:
            size = int(np.prod(tuple(tree.shape))) if hasattr(tree, "shape") else 1
            key = "/".join(path[:max_depth]) or "<root>"
            rows[key] = rows.get(key, 0) + size

    walk(params, ())
    total = sum(rows.values())
    width = max(len(k) for k in rows) if rows else 10
    lines = [f"{'module':<{width}}  params"]
    lines += [f"{k:<{width}}  {v:,}" for k, v in sorted(rows.items())]
    lines.append(f"{'TOTAL':<{width}}  {total:,}")
    return "\n".join(lines)


def model_summary(model: Any, seed: int = 0) -> str:
    """Summarize a model's parameter tree, drawn on the CPU from `seed` (the
    JAX package traces its init for shapes alone; torch draws it)."""
    return param_tree_summary(model.init(torch.Generator().manual_seed(seed), device="cpu"))
