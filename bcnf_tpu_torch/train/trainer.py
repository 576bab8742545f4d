"""The training runtime: train and validation steps inside a host epoch loop
(port of `bcnf_tpu/train/trainer.py:52-520`).

The same control surface as the JAX package's `Trainer`: seeded validation
split, the dataset held on the device, clip-then-Adam updates, the hybrid
`(nll + w*mse)/(1+w)` objective, padded validation batches with exact
weighted metrics, rolling-window plateau stop, `ReduceLROnPlateau`,
divergence `raise`/`stop`/`rescue`, `keep_best`, a wall-clock timeout that
starts after the first epoch, and epoch-level checkpoint/resume.

On the card, a training step of the flagship runs the flow through the
training kernels K2a and K2b (`CondRealNVP.forward`, gate `_use_fused_train`)
and validation through K1. A step's metrics stay on the device; the host
reads them once per epoch. Matmuls and convolutions run in float32 (TF32 is
switched off), the contract of the JAX package's "highest" precision.

`training.pretrained_features: <path>` grafts a saved feature-network tree
into the fresh parameters (`models/pretrained.py`), and
`training.freeze_features` trains the flow alone. Not ported yet, and
refused: data parallelism (`mesh=`, ROADMAP.md slice 11) and
`training.remat: true` (the kernels already recompute each step's
activations in the backward).
"""

from __future__ import annotations

import time
from typing import Any, Sequence

import numpy as np
import torch

from bcnf_tpu_torch.bridge import map_tree, params_from_numpy, params_to_numpy, tree_leaves
from bcnf_tpu_torch.config import ParameterIndexMapping
from bcnf_tpu_torch.errors import TrainingDivergedError
from bcnf_tpu_torch.models.pretrained import load_pretrained_features
from bcnf_tpu_torch.train.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from bcnf_tpu_torch.train.data import DeviceDataset, TrainerDataHandler
from bcnf_tpu_torch.train.history import MetricSink, StdoutSink, TrainerParameterHistoryHandler
from bcnf_tpu_torch.train.optim import (
    ClippedOptimizer,
    ReduceLROnPlateau,
    get_learning_rate,
    make_optimizer,
    set_learning_rate,
)
from bcnf_tpu_torch.utils.misc import get_data_type, inn_nll_loss, resolve_device


def _trainable(params: Any) -> Any:
    """Fresh leaf tensors that require grad: the caller's tree is left as it is."""
    return map_tree(lambda t: t.detach().clone().requires_grad_(True), params)


class Trainer:
    """Reference `Trainer` (`src/bcnf/train/trainer.py:20`) on PyTorch; runs on
    `device` (default CUDA; raises without a card unless `device="cpu"`)."""

    def __init__(
        self,
        config: dict,
        project_name: str = "bcnf",
        run_name: str = "run",
        parameter_index_mapping: ParameterIndexMapping | None = None,
        hybrid_weight: float = 0.0,
        verbose: bool = False,
        sink: MetricSink | None = None,
        mesh: Any = None,
        seed: int | None = None,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 0,
        data: tuple[np.ndarray, list[np.ndarray]] | None = None,
        device: str | torch.device | None = None,
    ) -> None:
        if mesh is not None:
            raise NotImplementedError("data-parallel training is not ported yet (ROADMAP.md, slice 11)")
        self.device = resolve_device(device)
        self.config = config
        self.verbose = verbose
        self.project_name = project_name
        self.run_name = run_name
        self.parameter_index_mapping = parameter_index_mapping
        self.hybrid_weight = float(hybrid_weight or 0.0)
        self.sink = sink if sink is not None else (StdoutSink() if verbose else None)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every

        training = config["training"]
        self.seed = seed if seed is not None else int(training.get("random_state", 0) or 0)
        self.meta_scheduler = TrainerParameterHistoryHandler(
            val_loss_window_size=training["val_loss_window_size"],
            val_loss_patience=training["val_loss_patience"],
            val_loss_tolerance_mode=training["val_loss_tolerance_mode"],
            val_loss_tolerance=training["val_loss_tolerance"],
            sink=self.sink,
        )
        self.dtype = get_data_type(config["global"]["dtype"])
        self.data_handler = TrainerDataHandler()
        if data is not None:
            self.data = data
        else:
            self.data = self.data_handler.get_data_for_training(
                config=config, parameter_index_mapping=parameter_index_mapping, dtype=self.dtype,
                verbose=verbose, seed=self.seed, device=self.device,
            )
        self.loss_function = inn_nll_loss

    # ------------------------------------------------------------------

    def loss_fn(self, model: Any, params: Any, y: torch.Tensor, conditions: Sequence[torch.Tensor],
                generator: torch.Generator | None) -> tuple[torch.Tensor, ...]:
        """`(loss, nll, mse, mean logdet)` of one training batch
        (`bcnf_tpu/train/trainer.py:113-128`)."""
        if model.n_conditions > 0:
            z, log_det, h = model.forward(params, y, *conditions, generator=generator, train=True,
                                          return_features=True)
        else:
            z, log_det = model.forward(params, y, generator=generator, train=True)
            h = None
        nll = self.loss_function(z, log_det)
        if self.hybrid_weight > 0 and h is not None:
            mse = torch.mean((model.predict_head(params, h) - y) ** 2)
        else:
            mse = torch.zeros((), device=y.device)
        loss = (nll + mse * self.hybrid_weight) / (1 + self.hybrid_weight)
        return loss, nll, mse, torch.mean(log_det)

    def train_step(self, model: Any, params: Any, opt_state: ClippedOptimizer, y: torch.Tensor,
                   conditions: Sequence[torch.Tensor], generator: torch.Generator) -> torch.Tensor:
        """One clipped update in place; returns the batch's metrics on the
        device, `[loss, nll, mse, mean logdet]`."""
        opt_state.zero_grad()
        metrics = self.loss_fn(model, params, y, conditions, generator)
        metrics[0].backward()
        if self.config["training"].get("freeze_features", False) and "features" in params:
            for p in tree_leaves(params["features"]):  # flow-only training: zero conditioner grads
                p.grad = None
        opt_state.step()
        return torch.stack(metrics).detach()

    @torch.no_grad()
    def val_step(self, model: Any, params: Any, y: torch.Tensor, conditions: Sequence[torch.Tensor],
                 w: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """Weighted metrics of one padded validation batch (`w` is 1 for real
        rows, 0 for wrap-around pad rows; `bcnf_tpu/train/trainer.py:185-206`)."""
        if model.n_conditions > 0:
            z, log_det, h = model.forward(params, y, *conditions, return_features=True)
        else:
            z, log_det = model.forward(params, y)
            h = None
        wsum = torch.sum(w)
        nll = torch.sum(w * self.loss_function(z, log_det, reduction="none")) / wsum
        if self.hybrid_weight > 0 and h is not None:
            mse = torch.sum(w[:, None] * (model.predict_head(params, h) - y) ** 2) / (wsum * y.shape[1])
        else:
            mse = torch.zeros((), device=y.device)
        loss = (nll + mse * self.hybrid_weight) / (1 + self.hybrid_weight)
        metrics = torch.stack([loss, nll, mse, torch.sum(w * log_det) / wsum])
        z_mean = torch.sum(w[:, None] * z, dim=0) / wsum
        z_var = torch.sum(w[:, None] * (z - z_mean) ** 2, dim=0) / wsum
        return metrics, wsum, z_mean, torch.sqrt(z_var)

    # ------------------------------------------------------------------

    def train(self, model: Any, params: Any = None, fold: int = -1) -> Any:
        """Train `model`, returning the trained parameter tree on the
        trainer's device (reference `Trainer.train`, `src/bcnf/train/trainer.py:50-111`)."""
        cfg_t = self.config["training"]
        if cfg_t.get("precision"):
            model.precision = str(cfg_t["precision"])
        if cfg_t.get("remat"):
            raise NotImplementedError("training.remat is not ported: the training kernels recompute "
                                      "each step's activations in the backward already")
        # float32 is the contract: no TF32 in any matmul or convolution
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        opt_cfg = self.config["optimizer"]
        optimizer = make_optimizer(opt_cfg.get("type", "Adam"), **dict(opt_cfg.get("kwargs", {})))
        sk = dict(self.config["lr_scheduler"].get("kwargs", {}))
        scheduler = ReduceLROnPlateau(
            mode=sk.get("mode", "min"),
            factor=sk.get("factor", 0.1),
            patience=sk.get("patience", 10),
            threshold=sk.get("threshold", 1e-4),
            threshold_mode=sk.get("threshold_mode", "rel"),
        )

        y, conditions = self.data
        (y_tr, c_tr), (y_val, c_val) = self.data_handler.split_dataset(
            y, conditions, cfg_t["validation_split"], seed=self.seed
        )
        train_set = DeviceDataset(y_tr, c_tr, self.device)
        val_set = DeviceDataset(y_val, c_val, self.device)

        # one generator for the shuffles and the dropout masks, on the device
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        if params is None:
            params = model.init(torch.Generator().manual_seed(self.seed), device=self.device)
        params = map_tree(lambda t: t.detach().to(self.device), params)
        # the pretrained-conditioner workflow: saved feature-network weights
        # replace the fresh ones (`bcnf_tpu/train/trainer.py:259-267`)
        if cfg_t.get("pretrained_features"):
            params = load_pretrained_features(params, cfg_t["pretrained_features"])
            if self.verbose:
                print(f"Loaded pretrained features from {cfg_t['pretrained_features']}")
        # Glow-style data-dependent ActNorm init, only while the scales are
        # still at their 1.0 default: resumed or pre-trained trees are kept
        if (
            bool(cfg_t.get("actnorm_data_init", True))
            and model.actnorm is not None
            and "actnorm" in params.get("blocks", {})
            and bool(torch.all(params["blocks"]["actnorm"]["scale"] == 1.0))
        ):
            nb = min(1024, train_set.n, int(cfg_t.get("batch_size", 1024)))
            params = model.init_actnorm(params, train_set.y[:nb], *[c[:nb] for c in train_set.conditions])
        params = _trainable(params)
        opt_state = optimizer.init(params)

        start_epoch = 0
        if self.checkpoint_dir:
            ckpt_path = latest_checkpoint(self.checkpoint_dir)
            if ckpt_path:
                state = load_checkpoint(ckpt_path)
                params = params_from_numpy(state["params"], self.device, requires_grad=True)
                opt_state = optimizer.init(params)
                opt_state.load_state_dict(state["opt_state"])
                scheduler.load_state_dict(state["scheduler"])
                start_epoch = state["epoch"] + 1
                generator.set_state(state["generator"])
                if self.verbose:
                    print(f"Resumed from {ckpt_path} at epoch {start_epoch}")

        self.meta_scheduler = TrainerParameterHistoryHandler(
            val_loss_window_size=cfg_t["val_loss_window_size"],
            val_loss_patience=cfg_t["val_loss_patience"],
            val_loss_tolerance_mode=cfg_t["val_loss_tolerance_mode"],
            val_loss_tolerance=cfg_t["val_loss_tolerance"],
            fold=fold,
            sink=self.sink,
        )
        ms = self.meta_scheduler

        timeout = cfg_t.get("timeout")
        n_epochs = cfg_t["n_epochs"]
        # Divergence policy (`bcnf_tpu/train/trainer.py:322-333`): "raise" as
        # the reference; "stop" ends and returns the best params seen;
        # "rescue" restores the best params, halves the lr and goes on.
        on_divergence = cfg_t.get("on_divergence", "raise")
        track_best = bool(cfg_t.get("keep_best", False)) or on_divergence == "rescue"
        best_params = None
        best_val = float("inf")
        n_rescues = 0
        start_time = time.time()

        def finish(p: Any) -> Any:
            p = best_params if (track_best and best_params is not None) else p
            return map_tree(lambda t: t.detach(), p)

        # a dataset smaller than the batch would otherwise give no batch
        batch_size = min(cfg_t["batch_size"], train_set.n)

        for epoch in range(start_epoch, n_epochs):
            ms.update_epoch(epoch)

            # ---- training pass: metrics stay on the device until the epoch ends
            train_metrics = [
                self.train_step(model, params, opt_state, by, bc, generator)
                for by, bc in train_set.batches(batch_size, generator, drop_remainder=True)
            ]
            tm = np.mean(torch.stack(train_metrics).cpu().numpy(), axis=0)
            train_loss, train_nll, train_mse = float(tm[0]), float(tm[1]), float(tm[2])

            diverged = train_loss > 1e5 or not np.isfinite(train_loss)
            if diverged and on_divergence == "rescue" and best_params is not None:
                new_lr = get_learning_rate(opt_state) * 0.5
                with torch.no_grad():
                    for p, b in zip(tree_leaves(params), tree_leaves(best_params)):
                        p.copy_(b)
                opt_state = set_learning_rate(optimizer.init(params), new_lr)
                n_rescues += 1
                ms.parameter_history.setdefault("rescues", []).append({"epoch": epoch, "lr": float(new_lr)})
                if self.verbose:
                    print(f"[rescue {n_rescues}] diverged at epoch {epoch}; "
                          f"restored best params, lr -> {new_lr:.2e}")
                if new_lr < 1e-8:
                    ms.parameter_history["stop_reason"] = "rescue_lr_floor"
                    return finish(params)
                continue
            if diverged and epoch > 10:
                if on_divergence in ("stop", "rescue"):
                    ms.parameter_history["stop_reason"] = "diverged"
                    return finish(params)
                raise TrainingDivergedError(f"Loss exploded to {train_loss} at epoch {epoch}")

            # ---- validation pass over fixed-size padded batches
            val = [self.val_step(model, params, by, bc, bw) for by, bc, bw in val_set.batches_padded(batch_size)]
            ws = torch.stack([v[1] for v in val]).cpu().numpy().astype(np.float64)
            ws /= ws.sum()
            vm = np.average(torch.stack([v[0] for v in val]).cpu().numpy(), axis=0, weights=ws)
            val_loss, val_nll, val_mse, val_ld = (float(v) for v in vm)
            z_mean = np.average(torch.stack([v[2] for v in val]).cpu().numpy(), axis=0, weights=ws)
            z_std = np.average(torch.stack([v[3] for v in val]).cpu().numpy(), axis=0, weights=ws)

            ms.update_rolling_validation_loss(val_loss)
            if track_best and np.isfinite(val_loss) and val_loss < best_val:
                best_val = val_loss
                best_params = map_tree(lambda t: t.detach().clone(), params)

            lr = get_learning_rate(opt_state)
            ms.log("train_loss", train_loss)
            ms.log("train_loss_mse", train_mse)
            ms.log("train_loss_nll", train_nll)
            ms.log("val_loss", val_loss)
            ms.log("val_loss_mse", val_mse)
            ms.log("val_loss_nll", val_nll)
            ms.log("lr", lr)
            ms.log("distance_to_last_best_val_loss", epoch - ms.best_val_epoch)
            ms.log("time", time.time())
            ms.log("z_mean_mean", float(z_mean.mean()))
            ms.log("z_mean_std", float(z_mean.std()))
            ms.log("z_std_mean", float(z_std.mean()))
            ms.log("z_std_std", float(z_std.std()))
            ms.log("log_det_J", val_ld)

            new_lr = scheduler.step(ms.val_loss_rolling_avg, lr)
            if new_lr != lr:
                set_learning_rate(opt_state, new_lr)

            ms.update_best_loss()

            if self.checkpoint_every and self.checkpoint_dir and (epoch + 1) % self.checkpoint_every == 0:
                save_checkpoint(
                    f"{self.checkpoint_dir}/ckpt_{epoch}.pkl",
                    {
                        "params": params_to_numpy(params),
                        "opt_state": opt_state.state_dict(),
                        "scheduler": scheduler.state_dict(),
                        "epoch": epoch,
                        "generator": generator.get_state(),
                    },
                    metadata={"run_name": self.run_name, "epoch": epoch, "val_loss": val_loss},
                )

            if epoch == start_epoch:
                # the wall-clock budget starts after the first epoch, as in
                # the JAX package (which excludes its compile from it)
                start_time = time.time()

            if ms.patience_exceeded:
                ms.parameter_history["stop_reason"] = "val_loss_plateau"
                return finish(params)
            if timeout is not None and time.time() - start_time > timeout:
                ms.parameter_history["stop_reason"] = "timeout"
                return finish(params)

        ms.parameter_history["stop_reason"] = "max_epochs"
        return finish(params)


def train_CondRealNVP(
    model: Any,
    params: Any,
    y_train: np.ndarray,
    conditions_train: Sequence[np.ndarray],
    y_val: np.ndarray,
    conditions_val: Sequence[np.ndarray],
    n_epochs: int = 1,
    batch_size: int = 64,
    lr: float = 1e-3,
    val_loss_patience: int | None = None,
    val_loss_tolerance: float = 1e-3,
    val_loss_tolerance_mode: str = "rel",
    timeout: float | None = None,
    verbose: bool = False,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> tuple[Any, dict]:
    """Functional training API (reference `train_CondRealNVP`,
    `src/bcnf/train/train.py:19-219`; `bcnf_tpu/train/trainer.py:467-520`);
    returns `(params, loss_history)`."""
    config = {
        "global": {"dtype": "float32"},
        "training": {
            "validation_split": 0.0,
            "val_loss_window_size": 1,
            "val_loss_patience": val_loss_patience,
            "val_loss_tolerance": val_loss_tolerance,
            "val_loss_tolerance_mode": val_loss_tolerance_mode,
            "batch_size": batch_size,
            "n_epochs": n_epochs,
            "timeout": timeout,
            "random_state": seed,
        },
        "optimizer": {"type": "Adam", "kwargs": {"lr": lr}},
        "lr_scheduler": {"type": "ReduceLROnPlateau", "kwargs": {"patience": max(n_epochs, 1)}},
    }
    trainer = Trainer(config, verbose=verbose, data=(y_train, list(conditions_train)), seed=seed, device=device)
    # use the given train/val sets as they are
    trainer.data_handler.split_dataset = (  # type: ignore[method-assign]
        lambda y, c, ratio, seed=0: ((y_train, list(conditions_train)), (y_val, list(conditions_val)))
    )
    params = trainer.train(model, params)
    history = {
        "train": [v for _, v in trainer.meta_scheduler.parameter_history.get("train_loss", [])],
        "val": [v for _, v in trainer.meta_scheduler.parameter_history.get("val_loss", [])],
        "stop_reason": trainer.meta_scheduler.parameter_history.get("stop_reason"),
    }
    return params, history
