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
`training.freeze_features` trains the flow alone. `training.remat: true`
checkpoints each block of the plain path (`CondRealNVP.remat`).

Data parallelism (`mesh=`, `parallel/mesh.py`; `bcnf_tpu/train/trainer.py:130-160`):
without a mesh the Trainer runs on a mesh of one shard on `device`, the same
steps. The ActNorm data init runs on the unsharded first rows, then the
params are replicated, one copy per local shard. The batch is rounded down to a
multiple of the mesh size, so a mean of equal-shard means is the global
mean. Each step, each local shard runs forward and `backward()` on its
replica and its slice of the batch, inside the model's precision, drawing
dropout from its own generator (the epoch's seed with the shard index
folded in, as JAX folds the axis index into the step key; a mesh of one
shard draws from the run's generator, as the unsharded step); grads and
metrics go through `pmean`; clip and Adam update the first replica, which
is copied into the others: one optimizer state, and replicas that cannot
drift apart (across processes every rank applies the same update to the
same all-reduced grads). Validation shards its padded batches and reduces
weighted sums and weights, so its exact weighted metrics stay exact.
Checkpoints hold one replica (topology-independent) and are written only
where `is_host_zero()`. The model's kernel gates read each shard's rows.
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
from bcnf_tpu_torch.models.cnf import matmul_precision
from bcnf_tpu_torch.parallel.mesh import (
    Mesh,
    even_batch,
    is_host_zero,
    pmean,
    replicate_trainable,
    shard_backward,
    shard_batch,
    sync_replicas,
)
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
from bcnf_tpu_torch.utils.prng import fold_in, fold_in_step


def _trainable(params: Any) -> Any:
    """Fresh leaf tensors that require grad: the caller's tree is left as it is."""
    return map_tree(lambda t: t.detach().clone().requires_grad_(True), params)


def hybrid_loss(model: Any, params: Any, y: torch.Tensor, conditions: Sequence[torch.Tensor],
                generator: torch.Generator | None, hybrid_weight: float,
                nll_fn: Any = inn_nll_loss) -> tuple[torch.Tensor, ...]:
    """`(loss, nll, mse, mean logdet)` of a training batch, the hybrid
    objective `(nll + w * mse) / (1 + w)` (mse of the head's prediction
    when `w > 0`, else 0), with dropout from `generator`: the Trainer's
    and the online loop's."""
    if model.n_conditions > 0:
        z, log_det, h = model.forward(params, y, *conditions, generator=generator, train=True, return_features=True)
    else:
        z, log_det = model.forward(params, y, generator=generator, train=True)
        h = None
    nll = nll_fn(z, log_det)
    if hybrid_weight > 0 and h is not None:
        mse = torch.mean((model.predict_head(params, h) - y) ** 2)
    else:
        mse = torch.zeros((), device=y.device)
    loss = (nll + mse * hybrid_weight) / (1 + hybrid_weight)
    return loss, nll, mse, torch.mean(log_det)


class Trainer:
    """Reference `Trainer` (`src/bcnf/train/trainer.py:20`) on PyTorch; runs on
    `device` (default CUDA; raises without a card unless `device="cpu"`), or
    data-parallel on `mesh` (a `parallel.Mesh`; its first device holds the
    dataset and the optimizer). Without a mesh, `self.mesh` is one shard on
    `device`."""

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
        self.mesh = mesh if mesh is not None else Mesh([resolve_device(device)])
        self.device = self.mesh.devices[0]
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
        return hybrid_loss(model, params, y, conditions, generator, self.hybrid_weight, self.loss_function)

    def train_step(self, model: Any, replicas: Sequence[Any], opt_state: ClippedOptimizer, y: torch.Tensor,
                   conditions: Sequence[torch.Tensor], generators: Sequence[torch.Generator | None]) -> torch.Tensor:
        """One clipped update in place; returns the batch's metrics on the
        device, `[loss, nll, mse, mean logdet]`. `replicas` holds one param
        tree per local shard of the mesh, the optimizer's first
        (`replicate_trainable`), and `generators` their dropout generators
        (`shard_generators`). The grads come from `shard_grads`; the first
        replica is updated and copied into the others."""
        metrics = self.shard_grads(model, replicas, y, conditions, generators)
        if self.config["training"].get("freeze_features", False) and "features" in replicas[0]:
            for p in tree_leaves(replicas[0]["features"]):  # flow-only training: zero conditioner grads
                p.grad = None
        opt_state.step()
        sync_replicas(replicas)
        return metrics

    def shard_grads(self, model: Any, replicas: Sequence[Any], y: torch.Tensor, conditions: Sequence[torch.Tensor],
                    generators: Sequence[torch.Generator | None]) -> torch.Tensor:
        """The data-parallel grads of one batch (`bcnf_tpu/train/trainer.py:130-152`):
        each local shard runs forward and `backward()` on its replica and its
        rows of the batch, at the model's precision (as JAX traces its grad
        inside the model's precision context), with its own dropout
        generator; the grads (a leaf without one counts as zero) and the
        metrics go through `pmean` (`shard_backward`). Leaves the mean grads
        in the first replica's `.grad` and returns the mean `[loss, nll, mse,
        mean logdet]`."""
        shards = [(ys, cs, gen) for (ys, cs), gen in zip(shard_batch(self.mesh, (y, list(conditions))), generators)]
        return shard_backward(self.mesh, replicas, shards,
                              lambda p, ys, cs, gen: torch.stack(self.loss_fn(model, p, ys, cs, gen)),
                              model.precision)

    def shard_generators(self, epoch: int) -> list[torch.Generator]:
        """The local shards' dropout generators of an epoch: its seed with the
        shard index folded in (a resumed run draws the same masks)."""
        seed = fold_in_step(self.seed, epoch)
        return [torch.Generator(device=d).manual_seed(fold_in(seed, shard))
                for shard, d in zip(self.mesh.local_shards, self.mesh.devices)]

    @torch.no_grad()
    def val_step(self, model: Any, replicas: Sequence[Any], y: torch.Tensor, conditions: Sequence[torch.Tensor],
                 w: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """Weighted metrics of one padded validation batch (`w` is 1 for real
        rows, 0 for wrap-around pad rows; `bcnf_tpu/train/trainer.py:185-206`),
        at the model's precision, over the mesh: each shard's weighted sums
        and weights are reduced (a ratio of means is the ratio of the sums),
        then the spread of z around the batch's mean in a second reduce.
        Returns `(metrics, total weight, z mean, z std)`."""
        shards = shard_batch(self.mesh, (y, list(conditions), w))
        zs, sums = [], []
        with matmul_precision(model.precision):
            for replica, (ys, cs, ws) in zip(replicas, shards):
                if model.n_conditions > 0:
                    z, log_det, h = model.forward(replica, ys, *cs, return_features=True)
                else:
                    z, log_det = model.forward(replica, ys)
                    h = None
                if self.hybrid_weight > 0 and h is not None:
                    s_mse = torch.sum(ws[:, None] * (model.predict_head(replica, h) - ys) ** 2)
                else:
                    s_mse = torch.zeros((), device=ys.device)
                sums.append([torch.sum(ws * self.loss_function(z, log_det, reduction="none")), s_mse,
                             torch.sum(ws * log_det), torch.sum(ws), torch.sum(ws[:, None] * z, dim=0)])
                zs.append((z, ws))
        s_nll, s_mse, s_ld, wsum, s_z = pmean(self.mesh, sums)
        nll = s_nll / wsum
        mse = s_mse / (wsum * y.shape[1])
        loss = (nll + mse * self.hybrid_weight) / (1 + self.hybrid_weight)
        z_mean = s_z / wsum
        (s_var,) = pmean(self.mesh, [[torch.sum(ws[:, None] * (z - z_mean.to(z.device)) ** 2, dim=0)]
                                     for z, ws in zs])
        metrics = torch.stack([loss, nll, mse, s_ld / wsum])
        return metrics, wsum * self.mesh.size, z_mean, torch.sqrt(s_var / wsum)

    # ------------------------------------------------------------------

    def train(self, model: Any, params: Any = None, fold: int = -1) -> Any:
        """Train `model`, returning the trained parameter tree on the
        trainer's device (reference `Trainer.train`, `src/bcnf/train/trainer.py:50-111`)."""
        cfg_t = self.config["training"]
        # the matmul precision of the whole run (`bcnf_tpu/train/trainer.py:216-220`):
        # each step runs inside `matmul_precision(model.precision)`
        if cfg_t.get("precision"):
            model.precision = str(cfg_t["precision"])
        # block-boundary rematerialization of the plain path (the kernels
        # recompute each step's activations already)
        if cfg_t.get("remat") is not None:
            model.remat = bool(cfg_t["remat"])
        # float32 is the contract outside the model's work: no TF32 in any
        # matmul or convolution
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

        # one generator for the shuffles (and, on one shard, the dropout masks), on the device
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
        replicas = replicate_trainable(self.mesh, params)
        opt_state = optimizer.init(params)

        start_epoch = 0
        if self.checkpoint_dir:
            ckpt_path = latest_checkpoint(self.checkpoint_dir)
            if ckpt_path:
                state = load_checkpoint(ckpt_path)
                params = params_from_numpy(state["params"], self.device, requires_grad=True)
                replicas = replicate_trainable(self.mesh, params)
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

        # a dataset smaller than the batch would otherwise give no batch; even shards
        batch_size = even_batch(self.mesh, min(cfg_t["batch_size"], train_set.n))

        for epoch in range(start_epoch, n_epochs):
            ms.update_epoch(epoch)

            # ---- training pass: metrics stay on the device until the epoch ends
            # one shard draws its masks from the run's generator, between the shuffles, as
            # an unsharded step always has; several draw from their own (`shard_generators`)
            dropout = [generator] if self.mesh.size == 1 else self.shard_generators(epoch)
            train_metrics = [
                self.train_step(model, replicas, opt_state, by, bc, dropout)
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
                sync_replicas(replicas)
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
            val = [self.val_step(model, replicas, by, bc, bw) for by, bc, bw in val_set.batches_padded(batch_size)]
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

            if (self.checkpoint_every and self.checkpoint_dir and (epoch + 1) % self.checkpoint_every == 0
                    and is_host_zero()):
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
