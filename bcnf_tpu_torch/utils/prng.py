"""Seeds and generators (port of `bcnf_tpu/utils/prng.py`).

JAX's keys have no torch counterpart: a JAX key is a value that splits and
folds without state, a `torch.Generator` is a stream with state. The port
draws from `torch.Generator`s seeded with integers, and derives seeds where
the JAX package derives keys: `fold_in(seed, data)` is a new seed from a
seed and an integer, as `jax.random.fold_in` is a new key, by NumPy's
`SeedSequence`. The data-parallel paths use it to give each shard its own
stream (`train/trainer.py`, `train/online.py`). Only the helpers callers
need are here: `key_from_seed`, `split_like`, `key_stream` and
`fold_in_step`, each giving generators or seeds in place of keys.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch


def fold_in(seed: int, data: int) -> int:
    """A seed derived from `seed` and the integer `data` (both >= 0): the
    counterpart of `jax.random.fold_in`. Different `data` give independent
    streams; the same pair always gives the same seed."""
    return int(np.random.SeedSequence([seed, data]).generate_state(1, np.uint64)[0])


def fold_in_step(seed: int, step: int) -> int:
    """The seed of step `step`: reproducible at any shard count when each
    shard folds its index in next (`fold_in(fold_in_step(seed, step), shard)`)."""
    return fold_in(seed, step)


def key_from_seed(seed: int | None, device: str | torch.device = "cpu") -> torch.Generator:
    """A generator on `device` seeded with `seed`; `seed=None` draws entropy
    from the OS."""
    generator = torch.Generator(device=device)
    if seed is None:
        generator.seed()
    else:
        generator.manual_seed(seed)
    return generator


def split_like(seed: int, names: tuple[str, ...], device: str | torch.device = "cpu") -> dict[str, torch.Generator]:
    """One seed split into a dict of named generators, each on its own stream."""
    return {name: key_from_seed(fold_in(seed, i), device) for i, name in enumerate(names)}


def key_stream(seed: int, device: str | torch.device = "cpu") -> Iterator[torch.Generator]:
    """An endless stream of fresh generators (host-side loop use only)."""
    i = 0
    while True:
        yield key_from_seed(fold_in(seed, i), device)
        i += 1
