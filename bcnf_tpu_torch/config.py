"""Configuration system for bcnf_tpu_torch (a copy of `bcnf_tpu/config.py`:
the port imports nothing of the JAX package).

Reads the *reference-compatible* YAML run-config schema
(`global / data / model / feature_networks / optimizer / lr_scheduler / training`,
see reference `configs/runs/dev/trajectory_LSTM_2_large.yaml:1-84`) without the
Dynaconf dependency (reference `src/bcnf/utils.py:13-46` uses Dynaconf; we use a
plain PyYAML loader with the same ``{{BCNF_ROOT}}`` path templating semantics,
reference `src/bcnf/utils.py:146-163`).

Also hosts :class:`ParameterIndexMapping` (reference `src/bcnf/utils.py:166-196`)
which defines the ordering of the theta-vector from
``config.global.parameter_selection``.
"""

from __future__ import annotations

import os
import re
import warnings
from typing import Any, Iterator

import numpy as np
import yaml

from bcnf_tpu_torch.errors import ConfigError

_ROOT_PATTERN = re.compile(r"\{\{BCNF_ROOT\}\}")


def get_dir(*args: str, filename: str | None = None, create: bool = False) -> str:
    """Resolve a path relative to the project root.

    The root is ``$BCNF_ROOT`` if set, else the repository root (the parent of
    the ``bcnf_tpu_torch`` package, the same directory the JAX package
    resolves). Mirrors reference `src/bcnf/utils.py:114-143`.
    """
    if any(not isinstance(arg, str) for arg in args):
        raise TypeError("All arguments must be strings.")

    root = os.environ.get("BCNF_ROOT") or os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..")
    )
    path = os.path.join(root, *args, filename or "")

    if create:
        target = os.path.dirname(path) if filename is not None else path
        os.makedirs(target, exist_ok=True)

    return os.path.abspath(path)


def sub_root_path(path: str) -> str:
    """Replace ``{{BCNF_ROOT}}`` with the project root (reference `src/bcnf/utils.py:146-163`)."""
    return _ROOT_PATTERN.sub(get_dir().replace("\\", "/"), path)


class Config(dict):
    """A nested dict with attribute access; keys are looked up case-insensitively
    at the top level to mirror the reference's lowercase round-trip through
    wandb.config (reference `src/bcnf/train/trainer.py:76-80`)."""

    def __getattr__(self, item: str) -> Any:
        try:
            return self[item]
        except KeyError as e:
            raise AttributeError(item) from e

    def __getitem__(self, item: Any) -> Any:
        if item in self.keys():
            return dict.__getitem__(self, item)
        if isinstance(item, str):
            for k in self.keys():
                if isinstance(k, str) and k.lower() == item.lower():
                    return dict.__getitem__(self, k)
        raise KeyError(item)

    def get(self, item: Any, default: Any = None) -> Any:
        try:
            return self[item]
        except KeyError:
            return default

    def __contains__(self, item: Any) -> bool:
        try:
            self[item]
            return True
        except KeyError:
            return False

    def to_dict(self) -> dict:
        def _plain(v: Any) -> Any:
            if isinstance(v, Config):
                return {k: _plain(x) for k, x in v.items()}
            if isinstance(v, list):
                return [_plain(x) for x in v]
            return v

        return {k: _plain(v) for k, v in self.items()}


# YAML 1.1 (PyYAML) parses dot-less scientific notation like `2e-4` as a
# string; the reference configs use that form everywhere (e.g.
# `configs/runs/old/trajectory_LSTM_large.yaml:55`). Dynaconf coerces — so
# do we.
_SCI_FLOAT = re.compile(r"^[+-]?(\d+(\.\d*)?|\.\d+)[eE][+-]?\d+$")


def _wrap(obj: Any) -> Any:
    if isinstance(obj, dict):
        return Config({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    if isinstance(obj, str):
        if _SCI_FLOAT.match(obj):
            return float(obj)
        return sub_root_path(obj)
    return obj


def load_yaml(path: str) -> Config:
    """Load a raw YAML file into a :class:`Config` with path templating applied."""
    path = sub_root_path(path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"File '{path}' does not exist.")
    with open(path) as f:
        raw = yaml.safe_load(f)
    if not isinstance(raw, dict):
        raise ConfigError(f"Config file '{path}' must contain a mapping at the top level.")
    return _wrap(raw)


def load_config(config_file: str, verify: bool = True) -> Config:
    """Load a run configuration (reference `src/bcnf/utils.py:13-46`).

    Unlike the reference (which warns only about the config *path*), the loaded
    config's ``data.path`` / ``data.config_file`` strings are templated too.
    """
    if verify and "{{BCNF_ROOT}}" not in config_file and os.path.isabs(config_file):
        warnings.warn(
            "The configuration file path does not contain '{{BCNF_ROOT}}'. "
            "This may cause issues when loading the model on a different machine."
        )
    return load_yaml(config_file)


# Canonical-key alias table for the theta vector. The reference's dataset
# generator emits `g_z` (reference `src/bcnf/simulation/sampling.py:267`) while
# the old/nll run configs select `g`
# (reference `configs/runs/old/trajectory_LSTM_large.yaml:3`); published pickles
# use `g` for the same values (notebook shim `data['g_z'] = data.pop('g')` in
# `notebooks/resimulation.ipynb`). We resolve either name to whichever is
# present (SURVEY.md Q8: one canonical schema + alias table at the IO boundary).
PARAMETER_ALIASES: dict[str, tuple[str, ...]] = {
    "g": ("g_z",),
    "g_z": ("g",),
}


class ParameterIndexMapping:
    """Maps between named physical parameters and the flat theta vector.

    Parity: reference `src/bcnf/utils.py:166-196`.
    """

    def __init__(self, parameters: list[str]) -> None:
        self.parameters = list(parameters)
        self.map = {p: i for i, p in enumerate(self.parameters)}

    def __len__(self) -> int:
        return len(self.parameters)

    def _resolve(self, parameter_dict: dict, p: str) -> Any:
        if p in parameter_dict:
            return parameter_dict[p]
        for alias in PARAMETER_ALIASES.get(p, ()):
            if alias in parameter_dict:
                return parameter_dict[alias]
        raise KeyError(
            f'Parameter "{p}" not found in the parameter dictionary. '
            f"Have available keys: {list(parameter_dict.keys())}"
        )

    def vectorize(self, parameter_dict: dict) -> np.ndarray:
        """Stack named parameters into shape ``(..., len(self))`` (reference `src/bcnf/utils.py:174-178`)."""
        return np.array([self._resolve(parameter_dict, p) for p in self.parameters]).T

    def dictify(self, parameter_vector: Any) -> dict:
        """Inverse of :meth:`vectorize` for a single vector (reference `src/bcnf/utils.py:180-181`)."""
        return {p: parameter_vector[i] for i, p in enumerate(self.parameters)}

    def __getitem__(self, key: str) -> int:
        return self.map[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self.parameters)

    def __contains__(self, key: str) -> bool:
        return key in self.parameters

    def __repr__(self) -> str:
        return str(self.parameters)
