"""Online ("infinite data") training: a fresh simulated batch every step
(port of `bcnf_tpu/train/online.py`).

The trainer draws a new batch from the prior at every step, on the run's
device: prior draws, integration, the acceptance filters, the observation
noise and, for video conditions, the renders, then the train step. No
dataset is held and no batch crosses from the host. Held-out evaluation
batches are more simulation, from a stream of their own.

Rejection keeps the JAX package's oversample-and-compact: draw
`ceil(batch * oversample)` candidates, compute the acceptance mask, and take
the first `batch` rows of a stable argsort of the rejection mask. When fewer
than `batch` rows are accepted, that takes rejected rows too, as the JAX
code does (its docstring says accepted rows repeat; ROADMAP.md §3).

`OnlineSimulator.sample_batch` is two stages: `draw` takes every random
number of a batch from a `torch.Generator` (the prior's rows and the noise),
and `assemble` computes the batch from those draws and nothing else (but the
MC renderer, which draws its points). So a test can feed JAX's own draws to
`assemble` and hold the batch against JAX's.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from bcnf_tpu_torch.bridge import map_tree, params_from_numpy, params_to_numpy
from bcnf_tpu_torch.config import PARAMETER_ALIASES, ParameterIndexMapping
from bcnf_tpu_torch.simulation.observation import add_airborne_noise
from bcnf_tpu_torch.simulation.physics import n_steps_for, simulate_trajectory
from bcnf_tpu_torch.simulation.priors import sample_ballistic_parameters
from bcnf_tpu_torch.simulation.sampling import _stage_render, _vectors
from bcnf_tpu_torch.train.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from bcnf_tpu_torch.train.history import MetricSink
from bcnf_tpu_torch.train.optim import cosine_decay_schedule, make_optimizer, set_learning_rate
from bcnf_tpu_torch.utils.misc import inn_nll_loss, resolve_device


class OnlineSimulator:
    """A `(y, conditions)` batch source drawn from the prior on the
    generator's device."""

    def __init__(
        self,
        prior_config: dict,
        parameter_index_mapping: ParameterIndexMapping,
        condition_groups: Sequence[Sequence[str]] = (("trajectories",),),
        dt: float = 0.067,
        T: float = 2.0,
        num_cams: int = 2,
        break_on_impact: bool = False,
        filter_runaway: bool = True,
        oversample: float = 1.25,
        n_substeps: int = 4,
        ratio: tuple[int, int] = (16, 9),
        fov_horizontal: float = 70.0,
        cam1_radian: float = 0.0,
        renderer: str = "analytic",
        legacy_cam_geometry: bool = False,
        observation_noise: float = 0.0,
    ) -> None:
        self.prior = prior_config.to_dict() if hasattr(prior_config, "to_dict") else dict(prior_config)
        self.mapping = parameter_index_mapping
        self.condition_groups = tuple(tuple(g) for g in condition_groups)
        self.dt = float(dt)
        self.T = float(T)
        self.num_cams = num_cams
        self.break_on_impact = break_on_impact
        self.filter_runaway = filter_runaway
        self.oversample = oversample
        self.n_substeps = n_substeps
        self.n_steps = n_steps_for(T, dt)
        # video conditions: the accepted rows are rendered on the device
        self.render = any("videos" in g for g in self.condition_groups)
        self.ratio = tuple(ratio)
        self.fov_horizontal = float(fov_horizontal)
        self.cam1_radian = float(cam1_radian)
        self.renderer = renderer
        self.legacy_cam_geometry = bool(legacy_cam_geometry)
        self.observation_noise = float(observation_noise)

    def _vectorize(self, p: dict[str, torch.Tensor]) -> torch.Tensor:
        cols = []
        for name in self.mapping.parameters:
            key = name if name in p else next((a for a in PARAMETER_ALIASES.get(name, ()) if a in p), None)
            if key is None:
                raise KeyError(f"Parameter {name} not produced by the simulator")
            cols.append(p[key])
        return torch.stack(cols, dim=-1)

    def draw(self, generator: torch.Generator, batch: int) -> dict[str, Any]:
        """Every random draw of one batch, on the generator's device: the
        prior's `ceil(batch * oversample)` candidate rows (``"params"``) and,
        with observation noise, standard-normal draws of the batch's
        trajectory shape (``"noise"``)."""
        draws: dict[str, Any] = {
            "params": sample_ballistic_parameters(generator, math.ceil(batch * self.oversample), self.prior,
                                                  self.num_cams)}
        if self.observation_noise > 0:
            draws["noise"] = torch.randn((batch, self.n_steps, 3), generator=generator, device=generator.device)
        return draws

    def assemble(self, draws: dict[str, Any], batch: int,
                 generator: torch.Generator | None = None) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
        """The batch `(y (batch, D), conditions)` from `draw`'s draws
        (`bcnf_tpu/train/online.py:96-163`): integrate every candidate, accept
        the finite rows (and, with `filter_runaway`, those neither thrust
        upwards nor started underground), compact, add the noise, render.
        `generator` serves the MC renderer only."""
        p = draws["params"]
        x0, v0, g, w, a = _vectors(p, "x0", "v0", "g", "w", "a")
        traj = simulate_trajectory(x0, v0, g, w, p["b"], p["m"], p["rho"], p["r"], a, n_steps=self.n_steps,
                                   dt=self.dt, break_on_impact=self.break_on_impact, n_substeps=self.n_substeps)
        accept = torch.isfinite(traj).flatten(1).all(dim=1)
        if self.filter_runaway:
            accept &= ~(p["g_z"] + p["a_z"] > 0)  # reference `sampling.py:320`
            accept &= ~(p["x0_z"] < 0)  # reference `sampling.py:332`
        # compact: the accepted rows first, in order (a stable sort), then `batch` of them
        idx = torch.argsort((~accept).to(torch.uint8), stable=True)[:batch]
        p = {k: v[idx] for k, v in p.items()}
        traj = traj[idx]
        y = self._vectorize(p)

        data = dict(p)
        if self.observation_noise > 0:
            data["trajectories"] = add_airborne_noise(traj, draws["noise"], self.observation_noise)
        else:
            data["trajectories"] = traj
        if self.render:
            cam_radians = torch.cat(
                [torch.full((batch, 1), self.cam1_radian, device=traj.device), p["cam_radian_array"]], dim=-1)
            data["cam_radian_array"] = cam_radians
            data["videos"], _ = _stage_render(generator, p, traj, cam_radians, self.num_cams, self.ratio,
                                              self.fov_horizontal, self.renderer, self.legacy_cam_geometry,
                                              keep_videos=True)

        conditions = []
        # run configs say `cam_radian`; the prior sampler emits `cam_radian_array`
        key_aliases = {"cam_radian": "cam_radian_array"}
        for group in self.condition_groups:
            vals = []
            for c in group:
                v = data[c if c in data else key_aliases.get(c, c)]
                vals.append(v[:, None] if v.dim() == 1 else v)
            conditions.append(torch.cat(vals, dim=1) if len(vals) > 1 else vals[0])
        return y, tuple(conditions)

    def sample_batch(self, generator: torch.Generator, batch: int) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
        """Draw an accepted batch on the generator's device: `(y (B, D), conditions)`."""
        return self.assemble(self.draw(generator, batch), batch, generator)


def _stream_seed(seed: int, index: int) -> int:
    """The seed of the `index`-th batch of a stream seeded `seed`: JAX's
    `fold_in(key(seed), index)` in spirit, by NumPy's `SeedSequence`."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0])


def train_online(
    model: Any,
    params: Any,
    simulator: OnlineSimulator,
    n_steps: int = 1000,
    batch_size: int = 256,
    lr: float = 2e-4,
    lr_decay: bool = False,
    max_grad_norm: float = 1.0,
    eval_every: int = 100,
    eval_batches: int = 4,
    hybrid_weight: float = 0.0,
    seed: int = 0,
    sink: MetricSink | None = None,
    timeout: float | None = None,
    loss_fn: Callable | None = None,
    mesh: Any = None,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 500,
    resume: bool = False,
    device: str | torch.device | None = None,
) -> tuple[Any, dict]:
    """Step-based training over fresh simulated batches on `device` (default
    CUDA), `bcnf_tpu/train/online.py:166-372`: clip, then Adam, optionally
    at optax's cosine decay over the step budget (`alpha=0.02`); the
    data-dependent ActNorm init on a first batch while every scale is 1;
    the hybrid objective; every `eval_every` steps (and at the last) the mean
    NLL of `eval_batches` held-out batches, the `i`-th batch after step `s`
    drawn from its own stream (seed ``seed + 1``, index ``s * eval_batches +
    i``); the wall-clock `timeout`.

    With `checkpoint_dir` the loop saves ``online_{step}.pkl`` every
    `checkpoint_every` steps and at the end: params, optimizer state, the
    generator's state, the step and the history. `resume=True` continues
    from the newest one, and so the exact data stream on the same device.
    Returns `(params, history)`.
    """
    if mesh is not None:
        raise NotImplementedError("data-parallel online training is not ported yet (ROADMAP.md, slice 11)")
    dev = resolve_device(device)
    # float32 is the contract: no TF32 in any matmul or convolution
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    loss_fn = loss_fn or inn_nll_loss
    n_cond = model.n_conditions
    optimizer = make_optimizer("Adam", lr=lr, max_grad_norm=max_grad_norm)
    schedule = cosine_decay_schedule(lr, max(n_steps, 1), alpha=0.02) if lr_decay else None

    params = map_tree(lambda t: t.detach().to(dev), params)
    # Glow-style data-dependent ActNorm init, only while the scales are still
    # at their 1.0 default (a resumed checkpoint overwrites params below)
    if (
        getattr(model, "actnorm", None) is not None
        and "actnorm" in params.get("blocks", {})
        and bool(torch.all(params["blocks"]["actnorm"]["scale"] == 1.0))
    ):
        y0, conds0 = simulator.sample_batch(torch.Generator(device=dev).manual_seed(seed + 99), batch_size)
        params = model.init_actnorm(params, y0, *conds0)
    params = map_tree(lambda t: t.detach().clone().requires_grad_(True), params)
    opt = optimizer.init(params)
    generator = torch.Generator(device=dev).manual_seed(seed)  # the batches' and the dropout's stream
    step_start = 0
    history: dict[str, Any] = {"train_loss": [], "eval_nll": []}

    if checkpoint_dir is not None and resume:
        ckpt_path = latest_checkpoint(checkpoint_dir, prefix="online_")
        if ckpt_path is not None:
            state = load_checkpoint(ckpt_path)
            params = params_from_numpy(state["params"], dev, requires_grad=True)
            opt = optimizer.init(params)
            opt.load_state_dict(state["opt_state"])
            generator.set_state(state["generator"])
            step_start = int(state["step"])
            history = state.get("history", history)
            history.pop("stop_reason", None)

    def objective(y: torch.Tensor, conditions: tuple) -> torch.Tensor:
        if n_cond > 0:
            z, log_det, h = model.forward(params, y, *conditions, generator=generator, train=True,
                                          return_features=True)
        else:
            z, log_det = model.forward(params, y, generator=generator, train=True)
            h = None
        nll = loss_fn(z, log_det)
        mse = torch.zeros((), device=y.device)
        if hybrid_weight > 0 and h is not None:
            mse = torch.mean((model.predict_head(params, h) - y) ** 2)
        return torch.stack([(nll + mse * hybrid_weight) / (1 + hybrid_weight), nll, mse])

    @torch.no_grad()
    def eval_nll(index: int) -> float:
        y, conditions = simulator.sample_batch(
            torch.Generator(device=dev).manual_seed(_stream_seed(seed + 1, index)), batch_size)
        z, log_det = model.forward(params, y, *conditions) if n_cond > 0 else model.forward(params, y)
        return float(loss_fn(z, log_det))

    def save(step: int) -> None:
        save_checkpoint(
            os.path.join(checkpoint_dir, f"online_{step}.pkl"),
            {"params": params_to_numpy(params), "opt_state": opt.state_dict(), "generator": generator.get_state(),
             "step": step, "history": history},
            metadata={"step": step, "batch_size": batch_size, "seed": seed},
        )

    start = time.time()
    stop_reason = "max_steps"
    done = step_start
    for step in range(step_start, n_steps):
        if schedule is not None:
            set_learning_rate(opt, schedule(step))
        y, conditions = simulator.sample_batch(generator, batch_size)
        opt.zero_grad()
        metrics = objective(y, conditions)
        metrics[0].backward()
        opt.step()
        done = step + 1
        if done % eval_every == 0 or done == n_steps:
            train_loss = float(metrics[0].detach())
            evals = [eval_nll(step * eval_batches + i) for i in range(eval_batches)]
            eval_nll_mean = sum(evals) / len(evals)
            history["train_loss"].append((done, train_loss))
            history["eval_nll"].append((done, eval_nll_mean))
            if sink is not None:
                sink.log({"train_loss": train_loss, "eval_nll": eval_nll_mean}, done)
        if checkpoint_dir is not None and done % checkpoint_every == 0:
            save(done)
        if timeout is not None and time.time() - start > timeout:
            stop_reason = "timeout"
            break
    if checkpoint_dir is not None:
        save(done)
    history["stop_reason"] = stop_reason
    return map_tree(lambda t: t.detach(), params), history
