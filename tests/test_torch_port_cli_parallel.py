"""Port parity, data parallelism through the CLI (`--dp-devices`, the JAX
package's `bcnf_tpu/__main__.py:56-65, 98-115, 235-236, 269-272, 353-365`), on
CPU shards (`--device cpu`): `train --dp-devices 2` writes a model directory;
`eval --dp-devices 2` gives the ranks of `--dp-devices 1` exactly, its
resimulation within 1e-6 and its test NLL within 1e-6 (tests/test_parallel.py's
bars); `sample --dp-devices 2` gives `--dp-devices 1`'s samples exactly; a
batch that is not a multiple of the mesh is rounded down, for `Trainer` and
for `--online`."""

import json
import os
import pickle

import numpy as np
import pytest
import yaml

import bcnf_tpu_torch.train.online as online
import bcnf_tpu_torch.train.trainer as trainer_module
from bcnf_tpu_torch.__main__ import build_parser, eval_report, main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRIOR = os.path.join(REPO, "configs", "data_prior.yaml")


@pytest.fixture(autouse=True)
def _root_env(monkeypatch):
    monkeypatch.setenv("BCNF_ROOT", REPO)


def _config(d, batch_size: int) -> dict:
    return {
        "global": {
            "cnf_version": 2,
            "parameter_selection": ["x0_x", "x0_y", "x0_z", "v0_x", "v0_y", "v0_z", "g", "w_x", "w_y", "w_z",
                                    "b", "m", "a_x", "a_y", "a_z", "r", "A", "Cd", "rho"],
            "conditions": [["trajectories"]],
            "dtype": "float32",
        },
        "data": {"path": str(d / "data"), "config_file": "{{BCNF_ROOT}}/configs/data_prior.yaml",
                 "n_samples": 64, "output_type": "trajectories", "dt": 0.1, "T": 0.5, "num_cams": 2,
                 "break_on_impact": False, "do_filter": False, "verbose": False},
        "model": {"kwargs": {"size": 19, "nested_sizes": [16, 16], "n_blocks": 3, "n_conditions": 12,
                             "act_norm": True, "random_state": 0}},
        "feature_networks": [
            {"type": "ConcatenateCondition", "kwargs": {"input_size": None, "output_size": 15}},
            {"type": "FullyConnected", "kwargs": {"sizes": [15, 16, 12]}},
        ],
        "optimizer": {"type": "Adam", "kwargs": {"lr": 2.0e-3}},
        "lr_scheduler": {"type": "ReduceLROnPlateau", "kwargs": {"patience": 50}},
        "training": {"validation_split": 0.25, "val_loss_window_size": 3, "val_loss_patience": 1000,
                     "val_loss_tolerance": 0.01, "val_loss_tolerance_mode": "abs", "batch_size": batch_size,
                     "n_epochs": 2, "timeout": None, "random_state": 0},
    }


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A model directory from `train --dp-devices 2` (its data generated from
    the config) and a held-out set from `generate`."""
    d = tmp_path_factory.mktemp("cli_parallel")
    config = d / "tiny.yaml"
    config.write_text(yaml.safe_dump(_config(d, batch_size=16), sort_keys=False))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BCNF_ROOT", REPO)
        main(["train", "-c", str(config), "-o", str(d / "model"), "--device", "cpu", "--seed", "1",
              "--dp-devices", "2"])
        main(["generate", "-c", PRIOR, "-o", str(d / "test.pkl"), "-n", "16", "--no-filter", "--dt", "0.1",
              "-T", "0.5", "--device", "cpu", "--seed", "2"])
    return d


def test_train_with_dp_devices_writes_a_model_dir(model_dir):
    with open(model_dir / "model" / "params.pkl", "rb") as f:
        params = pickle.load(f)
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        else:
            leaves.append(t)

    walk(params)
    assert leaves and all(isinstance(a, np.ndarray) and np.isfinite(a).all() for a in leaves)
    assert json.loads((model_dir / "model" / "config.json").read_text())["config_path"].endswith("tiny.yaml")


def test_eval_with_dp_devices_equals_one_device(model_dir, tmp_path):
    base = ["eval", "-m", str(model_dir / "model"), "-d", str(model_dir / "test.pkl"), "-M", "32",
            "--resim-samples", "8", "--device", "cpu"]
    runs = [eval_report(build_parser().parse_args([*base, "-o", str(tmp_path / n), "--dp-devices", n]))
            for n in ("1", "2")]
    (rep1, fig1, _), (rep2, fig2, _) = runs
    np.testing.assert_array_equal(fig1["ranks"], fig2["ranks"])
    np.testing.assert_allclose(fig2["X_resim"], fig1["X_resim"], rtol=0, atol=1e-6)
    assert abs(rep1["test_nll"] - rep2["test_nll"]) <= 1e-6
    assert rep1["rank_mean_frac"] == rep2["rank_mean_frac"]


def test_sample_with_dp_devices_equals_one_device(model_dir, tmp_path):
    outs = []
    for n in ("1", "2", "4"):
        out = tmp_path / f"s{n}.npy"
        main(["sample", "-m", str(model_dir / "model"), "-d", str(model_dir / "test.pkl"), "-n", "5", "-o", str(out),
              "--device", "cpu", "--seed", "3", "--dp-devices", n])
        outs.append(np.load(out))
    assert outs[0].shape == (5, 16, 19) and np.isfinite(outs[0]).all()
    for other in outs[1:]:
        np.testing.assert_array_equal(other, outs[0])
    with pytest.raises(ValueError, match="does not shard evenly"):
        main(["sample", "-m", str(model_dir / "model"), "-d", str(model_dir / "test.pkl"), "-n", "5",
              "-o", str(tmp_path / "s3.npy"), "--device", "cpu", "--dp-devices", "3"])


def test_batch_not_a_multiple_of_the_mesh_is_rounded_down(model_dir, tmp_path, monkeypatch):
    config = tmp_path / "odd.yaml"
    config.write_text(yaml.safe_dump(_config(model_dir, batch_size=30), sort_keys=False))
    rows = []
    step = trainer_module.Trainer.train_step

    def recording_step(self, model, params, opt_state, y, conditions, generator):
        rows.append(y.shape[0])
        return step(self, model, params, opt_state, y, conditions, generator)

    monkeypatch.setattr(trainer_module.Trainer, "train_step", recording_step)
    main(["train", "-c", str(config), "-o", str(tmp_path / "m"), "--device", "cpu", "--dp-devices", "4"])
    assert rows and set(rows) == {28}  # 30 rounded down to a multiple of 4
    batches = []
    run = online.train_online

    def recording_online(*args, **kw):
        batches.append(kw["batch_size"])
        return run(*args, **kw)

    monkeypatch.setattr(online, "train_online", recording_online)
    main(["train", "-c", str(config), "-o", str(tmp_path / "o"), "--device", "cpu", "--dp-devices", "4", "--online",
          "--online-steps", "2"])
    assert batches == [28]
    # a batch smaller than the mesh leaves no row a shard: both paths raise
    small = tmp_path / "small.yaml"
    small.write_text(yaml.safe_dump(_config(model_dir, batch_size=3), sort_keys=False))
    for i, extra in enumerate(([], ["--online", "--online-steps", "1"])):
        with pytest.raises(ValueError, match="gives no row to each of 4 shards"):
            main(["train", "-c", str(small), "-o", str(tmp_path / f"s{i}"), "--device", "cpu", "--dp-devices", "4",
                  *extra])
    assert (tmp_path / "o" / "params.pkl").exists()
