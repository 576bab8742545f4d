"""Metric history, plateau early-stop, and pluggable metric sinks (a copy of
`bcnf_tpu/train/history.py`: pure Python, so the port keeps its own).

Replaces the reference's wandb-hard-wired `TrainerParameterHistoryHandler`
(`src/bcnf/train/trainer_loss_handler.py:7-63`) with a sink abstraction
(stdout / JSONL / optional wandb), per SURVEY.md section 5.5: host-0-only
logging is the trainer's responsibility.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Deque


class MetricSink:
    def log(self, metrics: dict[str, Any], step: int) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class StdoutSink(MetricSink):
    def __init__(self, every: int = 1) -> None:
        self.every = every

    def log(self, metrics: dict[str, Any], step: int) -> None:
        if step % self.every == 0:
            parts = " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in metrics.items()
            )
            print(f"[epoch {step}] {parts}", flush=True)


class JSONLSink(MetricSink):
    def __init__(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a")

    def log(self, metrics: dict[str, Any], step: int) -> None:
        self._f.write(json.dumps({"step": step, "time": time.time(), **metrics}) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class WandbSink(MetricSink):
    """Optional Weights & Biases sink (the reference hard-wires wandb,
    `src/bcnf/train/trainer.py:74-80`; here it is opt-in and import-gated)."""

    def __init__(self, project: str, run_name: str, config: dict | None = None, entity: str | None = None) -> None:
        import wandb  # noqa: F401 — gated import

        self._wandb = wandb
        self._run = wandb.init(project=project, name=run_name, config=config, entity=entity)

    def log(self, metrics: dict[str, Any], step: int) -> None:
        self._wandb.log(metrics, step=step)

    def close(self) -> None:
        self._run.finish()


def wandb_login(filename: str = "wandbAPIKey.txt") -> None:
    """Log into wandb with a key file (reference `src/bcnf/train/utils.py:37-58`).

    Import-gated: only needed when using :class:`WandbSink`.
    """
    import wandb

    from bcnf_tpu_torch.config import get_dir

    key_file = get_dir(filename=filename)
    if not os.path.exists(key_file):
        raise FileNotFoundError(f"File '{key_file}' does not exist.")
    with open(key_file) as f:
        wandb.login(key=f.read().strip())


class MultiSink(MetricSink):
    def __init__(self, *sinks: MetricSink) -> None:
        self.sinks = [s for s in sinks if s is not None]

    def log(self, metrics: dict[str, Any], step: int) -> None:
        for s in self.sinks:
            s.log(metrics, step)

    def close(self) -> None:
        for s in self.sinks:
            s.close()


class TrainerParameterHistoryHandler:
    """Rolling validation-loss window + best-loss tracking ("meta scheduler").

    Parity: reference `src/bcnf/train/trainer_loss_handler.py:7-63` (same
    rolling-window, patience, and abs/rel tolerance semantics; `log` appends
    `(epoch+1, value)` tuples and forwards to the sink with a `_fold_{k}`
    suffix exactly like the reference when `fold >= 0`).
    """

    def __init__(
        self,
        val_loss_window_size: int,
        val_loss_patience: int | None = None,
        val_loss_tolerance_mode: str = "abs",
        val_loss_tolerance: float = 1e-1,
        fold: int = -1,
        sink: MetricSink | None = None,
    ) -> None:
        if val_loss_tolerance_mode not in ("rel", "abs"):
            raise ValueError("val_loss_tolerance_mode must be either 'rel' or 'abs'")
        self.val_loss_tolerance_mode = val_loss_tolerance_mode
        self.best_val_loss = float("inf")
        self.best_val_epoch = 0
        self.val_losses: Deque[float] = deque(maxlen=val_loss_window_size)
        self.val_loss_rolling_avg: float = float("inf")
        self.val_loss_window_size = val_loss_window_size
        self.val_loss_patience = val_loss_patience
        self.val_loss_tolerance = val_loss_tolerance
        self.parameter_history: dict[str, Any] = {}
        self.epoch = 0
        self.fold = fold
        self.sink = sink

    def update_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def log(self, parameter: str, value: Any) -> None:
        self.parameter_history.setdefault(parameter, []).append((self.epoch + 1, value))
        if self.sink is not None:
            name = parameter if self.fold < 0 else f"{parameter}_fold_{self.fold}"
            self.sink.log({name: value}, step=self.epoch)

    def update_rolling_validation_loss(self, val_loss: float) -> None:
        self.val_losses.append(val_loss)
        self.val_loss_rolling_avg = sum(self.val_losses) / len(self.val_losses)

    def update_best_loss(self) -> None:
        if self.val_loss_patience is None:
            return
        if self.val_loss_tolerance_mode == "rel":
            improved = self.val_loss_rolling_avg < self.best_val_loss * (1 - self.val_loss_tolerance)
        else:
            improved = self.val_loss_rolling_avg < self.best_val_loss - self.val_loss_tolerance
        if improved:
            self.best_val_loss = self.val_loss_rolling_avg
            self.best_val_epoch = self.epoch

    @property
    def patience_exceeded(self) -> bool:
        return (
            self.val_loss_patience is not None
            and (self.epoch - self.best_val_epoch) >= self.val_loss_patience
        )
