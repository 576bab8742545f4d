"""CLI of the port (`bcnf_tpu/__main__.py`: its training, serving and
evaluation subcommands).

Subcommands:

- ``generate`` — simulate a dataset from a prior config (priors, filters,
  trajectories, optional renders) and pickle it in the JAX package's schema
- ``train``  — build a model from a run config, train it on a dataset
  (generated from the config's ``data`` section when ``data.path`` holds
  none), or with ``--online`` on a fresh simulated batch every step, and
  write `params.pkl` (a NumPy tree, the format `bcnf-tpu train` writes) and
  `config.json` to the output directory
- ``sample`` — posterior sampling from a model directory as either package's
  ``train`` writes it (`config.json` + `params.pkl`)
- ``eval``   — test NLL, calibration ranks and CDF residuals, posterior
  diagnostics and resimulation on a test dataset; writes `report.json` (the
  JAX package's keys) and the figures (matplotlib)
- ``size``   — parameter count for a run config
- ``hpo``    — checkpointable Gaussian-process hyperparameter search scored
  by k-fold cross-validation (`hpo/driver.py`); re-running resumes

``generate``, ``train``, ``sample``, ``eval`` and ``hpo`` run on the GPU
unless ``--device cpu`` is given. Every run config in ``configs/runs/``
builds, the video ones (``CNN`` encoder) included. ``sample --precision``,
``eval --precision`` (after the test NLL, as in JAX) and
``training.precision`` take the model's precision strings
(`models/cnf.py: PRECISIONS`): the reduced ones run the kernels in one TF32
pass; float32 stays the default.

Data parallelism (`parallel/mesh.py`): ``train --dp-devices N`` trains on a
mesh of N shards over all processes (the batch rounded down to a multiple
of N), ``sample``/``eval --dp-devices N`` shard their condition rows (the
results equal one device's). On CUDA each process takes its first N /
processes cards and raises when fewer are visible; with ``--device cpu``
the shards are logical CPU shards. ``train --coordinator host:port
--num-processes P --process-id I`` joins P processes first (one command
each; NCCL on CUDA, gloo on the CPU); only process 0 writes files. Every
process takes its first visible cards, so processes that share a host must
each see only their own (``CUDA_VISIBLE_DEVICES``): NCCL refuses two ranks
on one card.

Usage: ``python -m bcnf_tpu_torch generate -c configs/data_prior.yaml -o test.pkl -n 200``,
``python -m bcnf_tpu_torch train -c RUN.yaml -o MODEL_DIR``, then
``python -m bcnf_tpu_torch eval -m MODEL_DIR -d test.pkl -o REPORT_DIR``.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    commands = {"train": _cmd_train, "size": _cmd_size, "sample": _cmd_sample, "generate": _cmd_generate,
                "eval": _cmd_eval, "hpo": _cmd_hpo}
    commands[args.command_name](args)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Ballistic Conditional Normalizing Flows on PyTorch/CUDA (bcnf_tpu_torch)"
    )
    subparsers = parser.add_subparsers(dest="command_name", required=True)

    train_parser = subparsers.add_parser("train")
    train_parser.add_argument("-c", "--config", type=str, required=True, help="Path to the run configuration file")
    train_parser.add_argument("-o", "--output-dir", type=str, default=None, help="Directory to store the results")
    train_parser.add_argument("-p", "--project", type=str, default="bcnf-test", help="Project name for metric sinks")
    train_parser.add_argument("-f", "--force", action="store_true", help="Overwrite the output directory if it exists")
    train_parser.add_argument("--wandb", action="store_true", help="Also log to Weights & Biases (requires wandb)")
    train_parser.add_argument("--checkpoint-every", type=int, default=0, help="Checkpoint every N epochs (0 = off)")
    train_parser.add_argument("--seed", type=int, default=None)
    train_parser.add_argument("--freeze-features", action="store_true",
                              help="Zero conditioner gradients (train the flow only)")
    train_parser.add_argument("-d", "--data", type=str, default=None,
                              help="Override data.path (dataset pickle or shard directory)")
    train_parser.add_argument("--timeout", type=float, default=None,
                              help="Override training.timeout (seconds of training wall-clock)")
    train_parser.add_argument("--on-divergence", type=str, default=None, choices=["raise", "stop", "rescue"],
                              help="Override training.on_divergence")
    train_parser.add_argument("--device", type=str, default=None,
                              help="Device to train on (default: cuda; 'cpu' runs the plain path)")
    train_parser.add_argument("--pretrained-features", type=str, default=None,
                              help="Path to a params.pkl (or features subtree pickle) whose "
                                   "feature-network weights initialize this model's conditioner")
    train_parser.add_argument("--online", action="store_true",
                              help="Infinite-data regime: draw a fresh simulated batch from the prior every step "
                                   "(on the device, no dataset pickle); also enabled by training.online: true")
    train_parser.add_argument("--online-steps", type=int, default=None,
                              help="Step budget for --online (default: training.online_steps or 5000)")
    train_parser.add_argument("--online-lr-decay", action="store_true",
                              help="Cosine-decay the lr over the --online step budget "
                                   "(also training.online_lr_decay: true)")
    train_parser.add_argument("--dp-devices", type=int, default=0,
                              help="Data-parallel over N devices (0 = single-device): a 1-D mesh, params "
                                   "replicated, batch sharded, grads mean-reduced")
    train_parser.add_argument("--coordinator", type=str, default=None,
                              help="Multi-process: the coordinator's address host:port for torch.distributed. "
                                   "Each process takes its first visible cards: give processes on one host "
                                   "disjoint CUDA_VISIBLE_DEVICES")
    train_parser.add_argument("--num-processes", type=int, default=None, help="Multi-process: total process count")
    train_parser.add_argument("--process-id", type=int, default=None, help="Multi-process: this process's id")

    size_parser = subparsers.add_parser("size")
    size_parser.add_argument("-c", "--config", type=str, required=True)

    sample_parser = subparsers.add_parser("sample")
    sample_parser.add_argument("-m", "--model-dir", type=str, required=True,
                               help="Directory with params.pkl + config.json")
    sample_parser.add_argument("-d", "--data", type=str, required=True, help="Dataset pickle with conditions")
    sample_parser.add_argument("-n", "--n-samples", type=int, default=1000)
    sample_parser.add_argument("-o", "--output", type=str, required=True, help="Output .npy path")
    sample_parser.add_argument("--seed", type=int, default=0)
    sample_parser.add_argument("--dp-devices", type=int, default=0,
                               help="Shard condition rows over an N-device data mesh (0 = single-device)")
    sample_parser.add_argument("--precision", type=str, default=None,
                               help="Matmul precision override, e.g. BF16_BF16_F32_X3 (the kernels in one "
                                    "TF32 pass); default float32")
    sample_parser.add_argument("--device", type=str, default=None,
                               help="Device to sample on (default: cuda; 'cpu' runs the plain path)")

    gen_parser = subparsers.add_parser("generate")
    gen_parser.add_argument("-c", "--config", type=str, required=True, help="Prior (data) configuration file")
    gen_parser.add_argument("-o", "--output", type=str, required=True, help="Output pickle path")
    gen_parser.add_argument("-n", "--n-samples", type=int, default=1000)
    gen_parser.add_argument("--output-type", type=str, default="trajectories",
                            choices=["videos", "trajectories", "parameters"])
    gen_parser.add_argument("--dt", type=float, default=1 / 30)
    gen_parser.add_argument("-T", type=float, default=2.0)
    gen_parser.add_argument("--no-filter", action="store_true")
    gen_parser.add_argument("--break-on-impact", action="store_true")
    gen_parser.add_argument("--renderer", type=str, default="mc", choices=["mc", "analytic"])
    gen_parser.add_argument("--observation-noise", type=float, default=0.0,
                            help="Airborne Gaussian observation noise std applied to the emitted trajectories")
    gen_parser.add_argument("--seed", type=int, default=None)
    gen_parser.add_argument("--device", type=str, default=None,
                            help="Device to simulate on (default: cuda; 'cpu' runs there)")

    eval_parser = subparsers.add_parser("eval")
    eval_parser.add_argument("-m", "--model-dir", type=str, required=True,
                             help="Directory with params.pkl + config.json")
    eval_parser.add_argument("-d", "--data", type=str, required=True, help="Test dataset pickle")
    eval_parser.add_argument("-o", "--output-dir", type=str, required=True, help="Report output directory")
    eval_parser.add_argument("-M", "--m-samples", type=int, default=10_000,
                             help="Posterior samples per test point (the calibration protocol)")
    eval_parser.add_argument("--resim-samples", type=int, default=1000,
                             help="Posterior samples per trajectory for resimulation")
    eval_parser.add_argument("--max-points", type=int, default=200, help="Test points to evaluate")
    eval_parser.add_argument("--skip-resim", action="store_true")
    eval_parser.add_argument("--seed", type=int, default=0)
    eval_parser.add_argument("--dp-devices", type=int, default=0,
                             help="Shard posterior sampling + resimulation rows over an N-device data mesh "
                                  "(0 = single-device)")
    eval_parser.add_argument("--precision", type=str, default=None,
                             help="Matmul precision override for sampling, applied after the test NLL, e.g. "
                                  "BF16_BF16_F32_X3 (the kernels in one TF32 pass); default float32")
    eval_parser.add_argument("--device", type=str, default=None,
                             help="Device to evaluate on (default: cuda; 'cpu' runs the plain path)")

    hpo_parser = subparsers.add_parser("hpo")
    hpo_parser.add_argument("-d", "--data", type=str, required=True, help="Training dataset pickle")
    hpo_parser.add_argument("-o", "--output-dir", type=str, required=True,
                            help="Checkpoint + best.json directory (re-run to resume)")
    hpo_parser.add_argument("--n-calls", type=int, default=25)
    hpo_parser.add_argument("--n-initial-points", type=int, default=8)
    hpo_parser.add_argument("--n-splits", type=int, default=3)
    hpo_parser.add_argument("--n-epochs", type=int, default=60)
    hpo_parser.add_argument("--n-samples", type=int, default=1000)
    hpo_parser.add_argument("--seed", type=int, default=0)
    hpo_parser.add_argument("--space", type=str, default=None,
                            help="JSON dict of {dim: [low, high]} overrides for the search space, "
                                 'e.g. \'{"n_blocks": [16, 32], "lr": [1e-3, 3e-3]}\'')
    hpo_parser.add_argument("--device", type=str, default=None,
                            help="Device to train the folds on (default: cuda; 'cpu' runs the plain path)")
    return parser


def _cmd_train(args: argparse.Namespace) -> None:
    """`bcnf_tpu/__main__.py:153-299`: the processes join first, then the mesh
    is built (`--dp-devices` > 1), then the model."""
    import torch

    from bcnf_tpu_torch.bridge import params_to_numpy
    from bcnf_tpu_torch.config import load_config, sub_root_path
    from bcnf_tpu_torch.models import CondRealNVP, count_params
    from bcnf_tpu_torch.parallel import initialize_distributed, is_host_zero, make_mesh
    from bcnf_tpu_torch.train import Trainer
    from bcnf_tpu_torch.train.history import JSONLSink, MultiSink, StdoutSink
    from bcnf_tpu_torch.utils.misc import resolve_device

    device = resolve_device(args.device)
    # the processes join before anything else touches the device
    initialize_distributed(args.coordinator, args.num_processes, args.process_id, device)
    mesh = None
    if args.dp_devices and args.dp_devices > 1:
        mesh = make_mesh(args.dp_devices, device)
        print(f"Data-parallel mesh over {args.dp_devices} devices ({mesh.process_count} process(es))")
    model_name = os.path.splitext(os.path.basename(args.config))[0]
    output_dir = args.output_dir or os.path.join("{{BCNF_ROOT}}", "models", "bcnf-models", model_name)
    resolved = sub_root_path(output_dir)
    os.makedirs(resolved, exist_ok=True)
    if len(os.listdir(resolved)) > 0 and not args.force:
        print(f"Output directory {resolved} already exists and is not empty. Use -f to overwrite.")
        sys.exit(1)

    config = load_config(args.config)
    model = CondRealNVP.from_config(config)
    # --seed, default 0, as the JAX CLI's `jax.random.key(args.seed or 0)`
    params = model.init(torch.Generator().manual_seed(args.seed if args.seed is not None else 0), device=device)
    print(f"Loaded {model_name} with {count_params(params):,} parameters on {device}")

    sinks = [StdoutSink(), JSONLSink(os.path.join(resolved, "metrics.jsonl"))]
    if args.wandb:
        from bcnf_tpu_torch.train.history import WandbSink

        sinks.append(WandbSink(args.project, model_name, config.to_dict()))

    cfg = {k.lower(): v for k, v in config.items()}
    cfg["training"] = dict(cfg["training"])
    cfg["data"] = dict(cfg["data"])
    if args.data is not None:
        cfg["data"]["path"] = args.data
    if args.timeout is not None:
        cfg["training"]["timeout"] = args.timeout
    if args.on_divergence is not None:
        cfg["training"]["on_divergence"] = args.on_divergence
        if args.on_divergence == "rescue":
            cfg["training"]["keep_best"] = True

    if args.online or cfg["training"].get("online"):
        _train_online(args, cfg, model, params, sinks, resolved, device, mesh)
        return

    if args.pretrained_features:
        cfg["training"]["pretrained_features"] = args.pretrained_features
    if args.freeze_features:
        cfg["training"]["freeze_features"] = True

    trainer = Trainer(
        config=cfg,
        project_name=args.project,
        run_name=model_name,
        parameter_index_mapping=model.parameter_index_mapping,
        hybrid_weight=config["global"].get("hybrid_weight", 0) or 0,
        verbose=True,
        sink=MultiSink(*sinks),
        seed=args.seed,
        checkpoint_dir=os.path.join(resolved, "ckpts") if args.checkpoint_every else None,
        checkpoint_every=args.checkpoint_every,
        device=device,
        mesh=mesh,
    )
    try:
        params = trainer.train(model, params)
    except KeyboardInterrupt:
        print("Training interrupted by user")
    finally:
        for sink in sinks:
            sink.close()

    if is_host_zero():
        with open(os.path.join(resolved, "params.pkl"), "wb") as f:
            pickle.dump(params_to_numpy(params), f)
        with open(os.path.join(resolved, "config.json"), "w") as f:
            json.dump({"config_path": args.config}, f)
        print(f"Model saved to {resolved}")


def _train_online(args: argparse.Namespace, cfg: dict, model, params, sinks: list, resolved: str, device,
                  mesh) -> None:
    """The online (infinite-data) regime of `train` (`bcnf_tpu/__main__.py:214-263`):
    a fresh batch simulated on the device every step (on a mesh, each shard
    its part, the batch rounded down to a mesh multiple); `params.pkl` and
    `config.json` with the JAX package's keys."""
    from bcnf_tpu_torch.bridge import params_to_numpy
    from bcnf_tpu_torch.config import load_yaml
    from bcnf_tpu_torch.parallel import even_batch, is_host_zero
    from bcnf_tpu_torch.train.history import MultiSink
    from bcnf_tpu_torch.train.online import OnlineSimulator, train_online

    data_cfg = cfg["data"]
    simulator = OnlineSimulator(
        load_yaml(data_cfg["config_file"]),
        model.parameter_index_mapping,
        condition_groups=cfg["global"]["conditions"],
        dt=float(data_cfg["dt"]),
        T=float(data_cfg["T"]),
        num_cams=int(data_cfg.get("num_cams", 2)),
        break_on_impact=bool(data_cfg.get("break_on_impact", False)),
        renderer=str(data_cfg.get("renderer", "analytic")),
        observation_noise=float(data_cfg.get("observation_noise", 0.0)),
    )
    opt_kwargs = dict(cfg["optimizer"].get("kwargs", {}))
    batch = int(cfg["training"]["batch_size"])
    if mesh is not None:
        batch = even_batch(mesh, batch)  # even per-device shards, as the Trainer rounds
    try:
        params, history = train_online(
            model, params, simulator,
            n_steps=args.online_steps or int(cfg["training"].get("online_steps", 5000)),
            batch_size=batch,
            lr=float(opt_kwargs.get("lr", 2e-4)),
            lr_decay=bool(args.online_lr_decay or cfg["training"].get("online_lr_decay", False)),
            hybrid_weight=float(cfg["global"].get("hybrid_weight", 0) or 0),
            seed=args.seed or 0,
            sink=MultiSink(*sinks),
            timeout=cfg["training"].get("timeout"),
            checkpoint_dir=os.path.join(resolved, "ckpts") if args.checkpoint_every else None,
            checkpoint_every=args.checkpoint_every or 500,
            resume=bool(args.checkpoint_every),
            device=device,
            mesh=mesh,
        )
    finally:
        for sink in sinks:
            sink.close()
    if is_host_zero():
        with open(os.path.join(resolved, "params.pkl"), "wb") as f:
            pickle.dump(params_to_numpy(params), f)
        with open(os.path.join(resolved, "config.json"), "w") as f:
            json.dump({"config_path": args.config, "online": True,
                       "history_tail": {k: v[-3:] for k, v in history.items() if isinstance(v, list)}}, f)
        print(f"Online-trained model saved to {resolved} (stop: {history.get('stop_reason')})")


def _cmd_hpo(args: argparse.Namespace) -> None:
    """Checkpointable GP hyperparameter search (`bcnf_tpu/__main__.py:302-314`;
    re-running the same command resumes from the per-iteration checkpoint)."""
    from bcnf_tpu_torch.hpo.driver import run_hpo

    summary = run_hpo(
        args.data, args.output_dir,
        n_calls=args.n_calls, n_initial_points=args.n_initial_points,
        n_splits=args.n_splits, n_epochs=args.n_epochs,
        n_samples=args.n_samples, seed=args.seed,
        space_bounds=json.loads(args.space) if args.space else None,
        device=args.device,
    )
    print(json.dumps(summary, indent=2, default=float))


def _cmd_size(args: argparse.Namespace) -> None:
    from bcnf_tpu_torch.config import load_config
    from bcnf_tpu_torch.models import CondRealNVP, count_params

    model = CondRealNVP.from_config(load_config(args.config))
    print(f"Model size: {count_params(model.init(device='cpu')):,} parameters")


def _make_eval_mesh(args: argparse.Namespace):
    """The data mesh of `eval`/`sample --dp-devices N` (`bcnf_tpu/__main__.py:353-365`):
    one shard on the command's device at N <= 1; else N shards (`make_mesh`)."""
    from bcnf_tpu_torch.parallel import Mesh, make_mesh
    from bcnf_tpu_torch.utils.misc import resolve_device

    n = args.dp_devices
    if n <= 1:
        return Mesh([resolve_device(args.device)])
    mesh = make_mesh(n, args.device)
    print(f"Sharding rows over a {n}-device data mesh")
    return mesh


def _cmd_sample(args: argparse.Namespace) -> None:
    import numpy as np
    import torch

    from bcnf_tpu_torch.bridge import params_from_numpy
    from bcnf_tpu_torch.config import load_config
    from bcnf_tpu_torch.models import CondRealNVP
    from bcnf_tpu_torch.parallel import replicate, sample_sharded
    from bcnf_tpu_torch.train.data import TrainerDataHandler
    from bcnf_tpu_torch.utils.misc import get_data_type, resolve_device

    device = resolve_device(args.device)
    mesh = _make_eval_mesh(args)
    # float32 is the contract outside the model's work (which runs at its
    # precision): no TF32 in any matmul or convolution
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with open(os.path.join(args.model_dir, "config.json")) as f:
        config_path = json.load(f)["config_path"]
    config = load_config(config_path)
    model = CondRealNVP.from_config(config)
    if args.precision:
        model.precision = args.precision
    with open(os.path.join(args.model_dir, "params.pkl"), "rb") as f:
        params = params_from_numpy(pickle.load(f), device)

    cfg = {k.lower(): v for k, v in config.items()}
    cfg["data"] = dict(cfg["data"])
    cfg["data"]["path"] = args.data
    _, conditions = TrainerDataHandler().get_data_for_training(
        cfg, model.parameter_index_mapping, get_data_type(config["global"]["dtype"])
    )
    generator = torch.Generator().manual_seed(args.seed)
    conditions = [torch.from_numpy(c) for c in conditions]
    with torch.no_grad():  # the condition rows sharded, the draws one device's: the same samples on any mesh
        samples = sample_sharded(mesh, model, replicate(mesh, params), generator, args.n_samples, *conditions)
    np.save(args.output, samples.cpu().numpy())
    print(f"Wrote posterior samples {tuple(samples.shape)} to {args.output}")


def _cmd_generate(args: argparse.Namespace) -> None:
    from bcnf_tpu_torch.simulation.sampling import generate_data
    from bcnf_tpu_torch.utils.io import save_data

    data = generate_data(
        config_file=args.config,
        n=args.n_samples,
        output_type=args.output_type,
        dt=args.dt,
        T=args.T,
        do_filter=not args.no_filter,
        break_on_impact=args.break_on_impact,
        renderer=args.renderer,
        observation_noise=args.observation_noise,
        seed=args.seed,
        verbose=True,
        device=args.device,
    )
    save_data(data, args.output)
    print(f"Wrote {args.n_samples} samples to {args.output}")


def eval_report(args: argparse.Namespace) -> tuple[dict, dict, dict]:
    """The computation of `eval` (`bcnf_tpu/__main__.py:410-623`), which draws
    no figure: test NLL in 256-row batches, calibration ranks and CDF
    residuals, the posterior diagnostics (512 draws in chunks of 128 per 100
    points), then resimulation. Writes `report.json` (the JAX package's keys
    and verdict rules) and returns `(report, figure_data, stage_seconds)`;
    `_cmd_eval` draws the figures from `figure_data`. With `--dp-devices`
    the ranks and the resimulation shard their rows over a data mesh, as in
    JAX (their results equal one device's)."""
    import time

    import numpy as np
    import torch

    from bcnf_tpu_torch.bridge import params_from_numpy
    from bcnf_tpu_torch.config import load_config
    from bcnf_tpu_torch.eval.calibration import compute_CDF_residuals, compute_y_hat_ranks, sidak_joint_band
    from bcnf_tpu_torch.models import CondRealNVP
    from bcnf_tpu_torch.models.cnf import check_precision
    from bcnf_tpu_torch.simulation.resimulation import impact_points, resimulate
    from bcnf_tpu_torch.train.data import TrainerDataHandler
    from bcnf_tpu_torch.utils.io import load_data
    from bcnf_tpu_torch.utils.misc import get_data_type, inn_nll_loss, resolve_device

    device = resolve_device(args.device)
    mesh = _make_eval_mesh(args)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.precision:
        check_precision(args.precision)  # a bad string fails before any work
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.model_dir, "config.json")) as f:
        config_path = json.load(f)["config_path"]
    config = load_config(config_path)
    model = CondRealNVP.from_config(config)
    with open(os.path.join(args.model_dir, "params.pkl"), "rb") as f:
        params = params_from_numpy(pickle.load(f), device)

    cfg = {k.lower(): v for k, v in config.items()}
    cfg["data"] = dict(cfg["data"])
    cfg["data"]["path"] = args.data
    y, conditions = TrainerDataHandler().get_data_for_training(
        cfg, model.parameter_index_mapping, get_data_type(config["global"]["dtype"]), device=device
    )
    y = y[: args.max_points]
    conditions = [torch.from_numpy(np.ascontiguousarray(c[: args.max_points])).to(device) for c in conditions]
    y_dev = torch.from_numpy(np.ascontiguousarray(y)).to(device)
    stages: dict[str, float] = {}
    t0 = time.perf_counter()

    # test NLL
    nlls = []
    with torch.no_grad():
        for b in range(0, len(y), 256):
            z, ld = model.forward(params, y_dev[b: b + 256], *[c[b: b + 256] for c in conditions])
            nlls.append(inn_nll_loss(z, ld, reduction="none").cpu().numpy())
    test_nll = float(np.concatenate(nlls).mean())
    print(f"test NLL: {test_nll:.3f}")
    stages["nll"] = time.perf_counter() - t0

    # the sampling-only precision override, after the NLL pass so that the
    # NLL stays comparable across precisions (`bcnf_tpu/__main__.py:463-467`):
    # it changes the ranks, the diagnostics and the resimulation only
    if args.precision:
        model.precision = args.precision

    # calibration (the reference protocol: M posterior samples, 32-bin ranks)
    t0 = time.perf_counter()
    ranks = compute_y_hat_ranks(
        model, params, y_dev, *conditions, M_samples=args.m_samples,
        generator=torch.Generator(device=device).manual_seed(args.seed), device=device, mesh=mesh,
    )
    t, resid, _ = compute_CDF_residuals(ranks, args.m_samples)
    names = list(model.parameter_index_mapping.parameters)
    stages["ranks"] = time.perf_counter() - t0

    # Rank statistics are undefined for parameters that are constant in the
    # dataset (the default prior fixes a_x/a_y/a_z at zero): every test point
    # lands at the same posterior quantile. The headline metric covers the
    # non-degenerate dimensions only; degenerate ones are listed apart.
    degenerate = np.asarray(y.std(axis=0) < 1e-12)
    per_dim = np.abs(resid).max(axis=1)  # resid: (D, t_divisions)
    nondegen_max = float(per_dim[~degenerate].max()) if (~degenerate).any() else 0.0

    # Identifiability diagnostic: per-dim posterior width (mean posterior std
    # across test points) against the dataset's spread, and the posterior
    # bias |E[theta|x] - theta*|.
    t0 = time.perf_counter()
    post_mean = np.zeros_like(y)
    post_sq = np.zeros_like(y)
    n_diag = 512
    chunk = 128
    with torch.no_grad():
        for b in range(0, len(y), 100):
            cond_b = [c[b: b + 100] for c in conditions]
            parts = []
            for ci_ in range(n_diag // chunk):
                g = torch.Generator(device=device).manual_seed(args.seed + 7 + ci_)
                parts.append(model.sample(params, g, chunk, *cond_b, device=device).cpu().numpy())
            draws = np.concatenate(parts)  # (n_diag, B, D)
            post_mean[b: b + 100] = draws.mean(axis=0)
            post_sq[b: b + 100] = draws.std(axis=0)
    width = post_sq.mean(axis=0)
    bias = np.abs(post_mean - y).mean(axis=0)
    prior_spread = y.std(axis=0)
    stages["diagnostics"] = time.perf_counter() - t0

    joint_band = sidak_joint_band(int((~degenerate).sum()))
    report = {
        "test_nll": test_nll,
        "n_points": int(len(y)),
        "M_samples": args.m_samples,
        "rank_mean_frac": float(np.mean(ranks) / args.m_samples),
        "max_scaled_cdf_residual": nondegen_max,
        "max_scaled_cdf_residual_all_dims": float(per_dim.max()),
        "scaled_cdf_residual_by_dim": {n: round(float(v), 4) for n, v in zip(names, per_dim)},
        "degenerate_dims": [n for n, d in zip(names, degenerate) if d],
        # 99% quantile of sup|Brownian bridge| (Kolmogorov distribution):
        # the pass bar for max_scaled_cdf_residual under perfect calibration
        "sup_band_99": 1.628,
        # Sidak-corrected joint band over the non-degenerate dims tested
        # (family-wise 99%), and per-dim verdicts
        "n_nondegenerate_dims": int((~degenerate).sum()),
        "sup_band_99_joint": round(joint_band, 4),
        "calibration_pass_per_dim_band": bool(nondegen_max < 1.628),
        "calibration_pass_joint_band": bool(nondegen_max < joint_band),
        "calibration_verdict_by_dim": {
            n: ("degenerate" if d else ("pass" if v < 1.628 else ("pass_joint" if v < joint_band else "fail")))
            for n, v, d in zip(names, per_dim, degenerate)
        },
        "posterior_width_by_dim": {n: round(float(v), 5) for n, v in zip(names, width)},
        "posterior_bias_by_dim": {n: round(float(v), 5) for n, v in zip(names, bias)},
        "data_spread_by_dim": {n: round(float(v), 5) for n, v in zip(names, prior_spread)},
    }
    figures: dict = {"ranks": ranks, "t": t, "resid": resid, "names": names}

    skip_resim = args.skip_resim
    if not skip_resim:
        # resimulation needs only the true trajectories and the simulation
        # parameters; keep_output_type="trajectories" drops rendered videos
        data_dict = load_data(args.data, keep_output_type="trajectories")
        data_dict = {k: v[: args.max_points] for k, v in data_dict.items()}
        if "trajectories" not in data_dict:
            print("dataset has no 'trajectories' key; skipping resimulation")
            skip_resim = True
    if not skip_resim:
        t0 = time.perf_counter()
        X_resim = resimulate(
            model, params, cfg["data"]["T"], cfg["data"]["dt"], data_dict, None, *conditions,
            m_samples=args.resim_samples, generator=torch.Generator(device=device).manual_seed(args.seed + 1),
            device=device, mesh=mesh,
        )
        stages["resimulation"] = time.perf_counter() - t0
        X_true = np.asarray(data_dict["trajectories"])
        finite = np.isfinite(X_resim).all(axis=(2, 3))
        err = np.where(finite[..., None, None], X_resim - X_true[:, None], np.nan)
        per_step_mse = np.nanmedian(np.nansum(err**2, axis=-1), axis=1)  # (N, T)
        report["resim_median_mse_mean"] = float(np.nanmean(per_step_mse))
        report["resim_finite_frac"] = float(finite.mean())
        poi_r = impact_points(X_resim)
        poi_t = impact_points(X_true)
        # a plain sum, so an all-NaN impact point (no impact, or a diverged
        # resimulation) stays NaN and nanmedian excludes it
        sq = ((poi_r - poi_t[:, None]) ** 2).sum(axis=-1)
        dist = np.sqrt(sq)
        # The impact-error distribution is heavy-tailed (runaway draws), so
        # the scalar summaries are the median distance and an RMSE over the
        # resimulation notebook's +-42 m heatmap window.
        report["impact_median_dist"] = float(np.nanmedian(dist))
        inlier = np.abs(poi_r[..., :2]).max(axis=-1) <= 42.0
        sq_in = np.where(inlier, sq, np.nan)
        report["impact_rmse_within_42m"] = float(np.sqrt(np.nanmean(sq_in)))
        report["impact_inlier_frac"] = float(np.nanmean(inlier.astype(np.float64)))
        report["impact_defined_frac"] = float(np.isfinite(sq).mean())
        figures.update(X_true=X_true, X_resim=X_resim)

    with open(os.path.join(args.output_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    print("eval stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    return report, figures, stages


def _cmd_eval(args: argparse.Namespace) -> None:
    """Full evaluation report: test NLL, calibration, resimulation, then the figures."""
    from bcnf_tpu_torch.plots import plot_cdf_residuals, plot_rank_histograms, plot_resimulation

    _, fig, _ = eval_report(args)
    out = args.output_dir
    plot_rank_histograms(fig["ranks"], args.m_samples, fig["names"]).savefig(
        os.path.join(out, "rank_histograms.png"), dpi=150)
    plot_cdf_residuals(fig["t"], fig["resid"], fig["names"]).savefig(os.path.join(out, "cdf_residuals.png"), dpi=150)
    if "X_resim" in fig:
        plot_resimulation(fig["X_true"], fig["X_resim"]).savefig(os.path.join(out, "resimulation.png"), dpi=150)


if __name__ == "__main__":
    main()
