"""CLI of the port (`bcnf_tpu/__main__.py`, the serving slice of it).

Subcommands:

- ``sample`` — posterior sampling from a model directory as `bcnf-tpu train`
  writes it (`config.json` + `params.pkl`), on the GPU unless
  ``--device cpu`` is given
- ``size``   — parameter count for a run config

Usage: ``python -m bcnf_tpu_torch sample -m MODEL_DIR -d DATA.pkl -n 1000 -o out.npy``.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        description="Ballistic Conditional Normalizing Flows on PyTorch/CUDA (bcnf_tpu_torch)"
    )
    subparsers = parser.add_subparsers(dest="command_name", required=True)

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
    if args.command_name == "size":
        _cmd_size(args)
    else:
        _cmd_sample(args)


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
