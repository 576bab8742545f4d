"""The plain encoders, one file a feature network's `type` (as the run
configuration names it): ``encode(kwargs, params, x, generator)`` over the
network's input, dropout drawn from `generator` where one is given, and
``flops(kwargs, frames, rows)``, its forward products over `rows` condition
rows of `frames` steps."""

from __future__ import annotations

import importlib
from typing import Any


def find(kind: str) -> Any:
    """The module of the feature network `kind`."""
    try:
        return importlib.import_module(f"{__name__}.{kind}")
    except ModuleNotFoundError as e:
        raise ValueError(f"the reference has no encoder {kind!r} (benchmark/reference/encoders/{kind}.py)") from e
