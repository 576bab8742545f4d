#!/usr/bin/env python3
"""The float64 check of `chip_smoke.py`'s phases 5 and 12 alone, on one
NVIDIA GPU, without the rest of the smoke: K2a and K2b in 3xTF32 on their
`wgmma` routes (`csrc/flow_fwd_wgmma.cu`, `csrc/flow_train_wgmma.cu`) and on
the row tiles they replace (forced), each output's distance from the plain
version evaluated in float64 beside the float32 plain version's, held to the
larger of the row tiles' distance and twice the float32 plain version's. The
check is the smoke's own (`chip_smoke.train_pair_margin`); this script only
feeds it, so a variant build can be checked in a minute.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/train_3xtf32_wgmma.py [--trained]

The flagship `trajectory_LSTM_large` at its published widths, on its random
weights from seed 0 (ActNorm moved off identity, as phase 2 moves it), 4096
rows with their own conditions (random y and trajectories from seed 0); with
`--trained`, first on weights trained as phase 12 trains them (the `train`
CLI on the published config for 1 epoch, its 5000 trajectories generated on
the card) and their first 4096 training rows. Exits 1 where a route is past
its bar. Imports nothing of JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 4096


def trained_batch(model, dev):
    """Weights trained as phase 12 trains them (the `train` CLI on the
    published flagship config for 1 epoch, its data generated on the card
    from the seed) and the first B training rows: (params, y, trajectories)."""
    import pickle
    import tempfile

    import torch
    import yaml

    import bcnf_tpu_torch.__main__ as cli
    from bcnf_tpu_torch.bridge import params_from_numpy
    from bcnf_tpu_torch.config import load_config, sub_root_path
    from bcnf_tpu_torch.train.data import TrainerDataHandler
    from chip_smoke import CONFIG

    build_dir = os.path.join(HERE, "bcnf_tpu_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        with open(sub_root_path(CONFIG)) as f:
            cfg = yaml.safe_load(f)
        cfg["data"]["path"] = os.path.join(tmp, "train_data")
        cfg["training"]["n_epochs"] = 1
        cfg_path, model_dir = os.path.join(tmp, "run.yaml"), os.path.join(tmp, "model")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f)
        cli.main(["train", "-c", cfg_path, "-o", model_dir])
        with open(os.path.join(model_dir, "params.pkl"), "rb") as f:
            trained_np = pickle.load(f)
        run_cfg = load_config(cfg_path)
        y, conds = TrainerDataHandler().get_data_for_training({k.lower(): v for k, v in run_cfg.items()},
                                                              model.parameter_index_mapping)
    return (params_from_numpy(trained_np, dev), torch.from_numpy(y[:B]).float().contiguous().to(dev),
            torch.from_numpy(conds[0][:B]).float().contiguous().to(dev))


def main() -> None:
    with_trained = "--trained" in sys.argv[1:]
    if set(sys.argv[1:]) - {"--trained"}:
        raise SystemExit(__doc__)
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    from bcnf_tpu_torch import CondRealNVP
    from bcnf_tpu_torch.config import load_config
    from bcnf_tpu_torch.ops import _build
    from chip_smoke import CONFIG, SEED, train_pair_margin

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    _build.build_all(["flow_fwd_wgmma", "flow_train_wgmma", "flow_kernel", "flow_train_kernel"])
    dev = torch.device("cuda")
    model = CondRealNVP.from_config(load_config(CONFIG))
    if with_trained:
        train_pair_margin(model, *trained_batch(model, dev), "trained weights (phase 12's recipe)")
    params = model.init(torch.Generator().manual_seed(SEED), device=dev)
    rng = np.random.default_rng(SEED)
    an = params["blocks"]["actnorm"]
    params = dict(params, blocks=dict(params["blocks"], actnorm={
        "scale": an["scale"] + 0.1 * torch.from_numpy(rng.normal(size=an["scale"].shape).astype(np.float32)).to(dev),
        "bias": 0.1 * torch.from_numpy(rng.normal(size=an["bias"].shape).astype(np.float32)).to(dev)}))
    x = torch.from_numpy(rng.normal(size=(B, model.size)).astype(np.float32)).to(dev)
    traj = torch.from_numpy(rng.normal(size=(B, 30, 3)).astype(np.float32)).to(dev)
    train_pair_margin(model, params, x, traj, "random weights")


if __name__ == "__main__":
    main()
