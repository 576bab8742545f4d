"""Optimizers and LR scheduling (port of `bcnf_tpu/train/optim.py`).

The JAX package builds an optax chain `clip_by_global_norm(max_grad_norm) ->
adam | adamw | sgd` with an injected learning rate. This module keeps optax's
semantics and lets `torch.optim` carry the update itself:

- clipping happens before the update (SURVEY.md Q3), over the grads of all
  leaves of the param tree at once, as optax does: `g / ||g|| * max_norm`
  where `||g|| >= max_norm`, `g` untouched below it, and no `1e-6` in the
  divisor (torch's `clip_grad_norm_` adds one);
- every leaf is updated, a leaf without a grad as if its grad were zero
  (optax sees the zero grads `stop_gradient` gives, so AdamW's weight decay
  still reaches the fixed mixes);
- Adam at optax's `eps=1e-8`; AdamW at optax's default `weight_decay=1e-4`,
  not torch's 1e-2; optax's keyword names (`b1`, `b2`, `eps`, `momentum`,
  `nesterov`, `weight_decay`).

The learning rate lives in the torch optimizer's `param_groups`, so the
host-side plateau scheduler lowers it between epochs.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

from bcnf_tpu_torch.bridge import tree_leaves

_OPTAX_DEFAULTS = {
    "adam": {"b1": 0.9, "b2": 0.999, "eps": 1e-8},
    "adamw": {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "weight_decay": 1e-4},
    "sgd": {"momentum": None, "nesterov": False},
}


class ClippedOptimizer:
    """The optimizer state of one param tree: global-norm clipping, then a
    `torch.optim` update of every leaf in place."""

    def __init__(self, params: Any, name: str, lr: float, max_grad_norm: float | None, **kwargs: Any) -> None:
        self.params = [p for p in tree_leaves(params) if isinstance(p, torch.Tensor)]
        if not all(p.requires_grad for p in self.params):
            raise ValueError("every leaf of the param tree must require grad")
        self.max_grad_norm = max_grad_norm
        kw = {**_OPTAX_DEFAULTS[name], **kwargs}
        if name == "sgd":
            self.torch_optimizer: torch.optim.Optimizer = torch.optim.SGD(
                self.params, lr=lr, momentum=kw.pop("momentum") or 0.0, nesterov=kw.pop("nesterov"))
        else:
            cls = torch.optim.Adam if name == "adam" else torch.optim.AdamW
            extra = {"weight_decay": kw.pop("weight_decay")} if name == "adamw" else {}
            self.torch_optimizer = cls(self.params, lr=lr, betas=(kw.pop("b1"), kw.pop("b2")),
                                       eps=kw.pop("eps"), **extra)
        if kw:
            raise TypeError(f"unsupported {name} options: {sorted(kw)}")

    def zero_grad(self) -> None:
        self.torch_optimizer.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        """Clip the grads accumulated by `backward()`, then update."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.max_grad_norm is not None:
            grads = [p.grad for p in self.params]
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = norm < self.max_grad_norm
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.max_grad_norm))
        self.torch_optimizer.step()

    def state_dict(self) -> dict:
        return self.torch_optimizer.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.torch_optimizer.load_state_dict(state)


class OptimizerFactory:
    """What `make_optimizer` returns: `init(params)` gives the state, as
    optax's `GradientTransformation.init` does."""

    def __init__(self, name: str, lr: float, max_grad_norm: float | None, kwargs: dict) -> None:
        self.name, self.lr, self.max_grad_norm, self.kwargs = name, lr, max_grad_norm, kwargs

    def init(self, params: Any) -> ClippedOptimizer:
        return ClippedOptimizer(params, self.name, self.lr, self.max_grad_norm, **self.kwargs)


def make_optimizer(
    optimizer: str = "Adam",
    lr: float = 1e-3,
    max_grad_norm: float | None = 1.0,
    **kwargs: Any,
) -> OptimizerFactory:
    """The (clip -> update) chain of `bcnf_tpu/train/optim.py:24-46`."""
    name = optimizer.lower()
    if name not in _OPTAX_DEFAULTS:
        raise NotImplementedError(f"Optimizer {optimizer} not implemented")
    return OptimizerFactory(name, float(lr), max_grad_norm, dict(kwargs))


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Callable[[int], float]:
    """optax's `cosine_decay_schedule`: the learning rate of the update after
    `count` updates, ``init * ((1 - alpha) * 0.5 * (1 + cos(pi * min(count,
    decay_steps) / decay_steps)) + alpha)``."""
    if decay_steps <= 0:
        raise ValueError("decay_steps must be positive")

    def schedule(count: int) -> float:
        cosine = 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def set_learning_rate(opt_state: ClippedOptimizer, lr: float) -> ClippedOptimizer:
    for group in opt_state.torch_optimizer.param_groups:
        group["lr"] = float(lr)
    return opt_state


def get_learning_rate(opt_state: ClippedOptimizer) -> float:
    return float(opt_state.torch_optimizer.param_groups[0]["lr"])


class ReduceLROnPlateau:
    """Host-side plateau LR scheduler with torch-compatible semantics (a copy
    of `bcnf_tpu/train/optim.py:59-132`)."""

    def __init__(
        self,
        mode: str = "min",
        factor: float = 0.1,
        patience: int = 10,
        threshold: float = 1e-4,
        threshold_mode: str = "rel",
        cooldown: int = 0,
        min_lr: float = 0.0,
        eps: float = 1e-8,
    ) -> None:
        if factor >= 1.0:
            raise ValueError("Factor should be < 1.0.")
        if mode not in ("min", "max"):
            raise ValueError(f"mode {mode} is unknown")
        if threshold_mode not in ("rel", "abs"):
            raise ValueError(f"threshold mode {threshold_mode} is unknown")
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.eps = eps
        self.best = float("inf") if mode == "min" else -float("inf")
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def _is_better(self, current: float) -> bool:
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return current < self.best * (1.0 - self.threshold)
            return current < self.best - self.threshold
        if self.threshold_mode == "rel":
            return current > self.best * (1.0 + self.threshold)
        return current > self.best + self.threshold

    def step(self, metric: float, lr: float) -> float:
        """Record a metric; returns the (possibly reduced) learning rate."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1

        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0

        if self.num_bad_epochs > self.patience:
            new_lr = max(lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
            if lr - new_lr > self.eps:
                return new_lr
        return lr

    def state_dict(self) -> dict:
        return {
            "best": self.best,
            "num_bad_epochs": self.num_bad_epochs,
            "cooldown_counter": self.cooldown_counter,
        }

    def load_state_dict(self, state: dict) -> None:
        self.best = state["best"]
        self.num_bad_epochs = state["num_bad_epochs"]
        self.cooldown_counter = state["cooldown_counter"]
