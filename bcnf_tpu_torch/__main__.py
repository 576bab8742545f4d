"""CLI of the port (`bcnf_tpu/__main__.py`, its training and serving slices).

Subcommands:

- ``train``  — build a model from a run config, train it on a dataset, and
  write `params.pkl` (a NumPy tree, the format `bcnf-tpu train` writes) and
  `config.json` to the output directory
- ``sample`` — posterior sampling from a model directory as either package's
  ``train`` writes it (`config.json` + `params.pkl`)
- ``size``   — parameter count for a run config

``train`` and ``sample`` run on the GPU unless ``--device cpu`` is given.

Usage: ``python -m bcnf_tpu_torch train -c RUN.yaml -d DATA.pkl -o MODEL_DIR``, then
``python -m bcnf_tpu_torch sample -m MODEL_DIR -d DATA.pkl -n 1000 -o out.npy``.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys


def main(argv: list[str] | None = None) -> None:
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
    # the JAX package's flags for paths the port has not reached yet: each raises
    train_parser.add_argument("--pretrained-features", type=str, default=None,
                              help="Not ported yet (ROADMAP.md, slice 10)")
    train_parser.add_argument("--online", action="store_true", help="Not ported yet (ROADMAP.md, slice 6)")
    train_parser.add_argument("--online-steps", type=int, default=None, help="Not ported yet (ROADMAP.md, slice 6)")
    train_parser.add_argument("--online-lr-decay", action="store_true", help="Not ported yet (ROADMAP.md, slice 6)")
    train_parser.add_argument("--dp-devices", type=int, default=0, help="Not ported yet above 1 (ROADMAP.md, slice 11)")
    train_parser.add_argument("--coordinator", type=str, default=None, help="Not ported yet (ROADMAP.md, slice 11)")
    train_parser.add_argument("--num-processes", type=int, default=None, help="Not ported yet (ROADMAP.md, slice 11)")
    train_parser.add_argument("--process-id", type=int, default=None, help="Not ported yet (ROADMAP.md, slice 11)")

    size_parser = subparsers.add_parser("size")
    size_parser.add_argument("-c", "--config", type=str, required=True)

    sample_parser = subparsers.add_parser("sample")
    sample_parser.add_argument("-m", "--model-dir", type=str, required=True,
                               help="Directory with params.pkl + config.json")
    sample_parser.add_argument("-d", "--data", type=str, required=True, help="Dataset pickle with conditions")
    sample_parser.add_argument("-n", "--n-samples", type=int, default=1000)
    sample_parser.add_argument("-o", "--output", type=str, required=True, help="Output .npy path")
    sample_parser.add_argument("--seed", type=int, default=0)
    sample_parser.add_argument("--precision", type=str, default=None,
                               help="Matmul precision; only float32 ('highest') is ported")
    sample_parser.add_argument("--device", type=str, default=None,
                               help="Device to sample on (default: cuda; 'cpu' runs the plain path)")

    args = parser.parse_args(argv)
    if args.command_name == "train":
        _cmd_train(args)
    elif args.command_name == "size":
        _cmd_size(args)
    else:
        _cmd_sample(args)


def _cmd_train(args: argparse.Namespace) -> None:
    """`bcnf_tpu/__main__.py:153-299` for one device."""
    not_ported = {
        "--online": (args.online or args.online_steps is not None or args.online_lr_decay, 6),
        "--dp-devices > 1": (args.dp_devices > 1, 11),
        "--pretrained-features": (args.pretrained_features is not None, 10),
        "--coordinator/--num-processes/--process-id": (
            any(v is not None for v in (args.coordinator, args.num_processes, args.process_id)), 11),
    }
    for flag, (given, slice_no) in not_ported.items():
        if given:
            raise NotImplementedError(f"train {flag} is not ported yet (ROADMAP.md, slice {slice_no})")

    import torch

    from bcnf_tpu_torch.bridge import params_to_numpy
    from bcnf_tpu_torch.config import load_config, sub_root_path
    from bcnf_tpu_torch.models import CondRealNVP, count_params
    from bcnf_tpu_torch.train import Trainer
    from bcnf_tpu_torch.train.history import JSONLSink, MultiSink, StdoutSink
    from bcnf_tpu_torch.utils.misc import resolve_device

    device = resolve_device(args.device)
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
    )
    try:
        params = trainer.train(model, params)
    except KeyboardInterrupt:
        print("Training interrupted by user")
    finally:
        for sink in sinks:
            sink.close()

    with open(os.path.join(resolved, "params.pkl"), "wb") as f:
        pickle.dump(params_to_numpy(params), f)
    with open(os.path.join(resolved, "config.json"), "w") as f:
        json.dump({"config_path": args.config}, f)
    print(f"Model saved to {resolved}")



def _cmd_size(args: argparse.Namespace) -> None:
    from bcnf_tpu_torch.config import load_config
    from bcnf_tpu_torch.models import CondRealNVP, count_params

    model = CondRealNVP.from_config(load_config(args.config))
    print(f"Model size: {count_params(model.init(device='cpu')):,} parameters")


def _cmd_sample(args: argparse.Namespace) -> None:
    import numpy as np
    import torch

    from bcnf_tpu_torch.bridge import params_from_numpy
    from bcnf_tpu_torch.config import load_config
    from bcnf_tpu_torch.models import CondRealNVP
    from bcnf_tpu_torch.train.data import TrainerDataHandler
    from bcnf_tpu_torch.utils.misc import get_data_type, resolve_device

    device = resolve_device(args.device)
    # float32 is the contract: no TF32 in any matmul or convolution
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
    with torch.no_grad():
        samples = model.sample(
            params, generator, args.n_samples, *[torch.from_numpy(c) for c in conditions], device=device
        )
    np.save(args.output, samples.cpu().numpy())
    print(f"Wrote posterior samples {tuple(samples.shape)} to {args.output}")


if __name__ == "__main__":
    main()
