"""Port parity, the evaluation path through the CLI: `generate` -> `train`
(the data generated when `data.path` holds none) -> `eval`, on the CPU,
held against the JAX package's CLI on the same model directory and data.

A tiny run config (`tests/test_cli.py`'s) keeps each step to seconds."""

import json
import os
import pickle

import numpy as np
import pytest
import torch
import yaml

from bcnf_tpu.__main__ import main as jax_main
from bcnf_tpu_torch.__main__ import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRIOR = os.path.join(REPO, "configs", "data_prior.yaml")
TINY_GRID = ["--dt", "0.1", "-T", "0.5"]


@pytest.fixture(autouse=True)
def _root_env(monkeypatch):
    monkeypatch.setenv("BCNF_ROOT", REPO)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A model directory from the port's `train`, whose dataset did not
    exist and was generated, and a test set from the port's `generate`."""
    d = tmp_path_factory.mktemp("cli_eval")
    cfg = {
        "global": {
            "cnf_version": 2,
            "parameter_selection": ["x0_x", "x0_y", "x0_z", "v0_x", "v0_y", "v0_z", "g", "w_x", "w_y", "w_z",
                                    "b", "m", "a_x", "a_y", "a_z", "r", "A", "Cd", "rho"],
            "conditions": [["trajectories"]],
            "dtype": "float32",
        },
        "data": {"path": str(d / "data"), "config_file": "{{BCNF_ROOT}}/configs/data_prior.yaml",
                 "n_samples": 96, "output_type": "trajectories", "dt": 0.1, "T": 0.5, "num_cams": 2,
                 "break_on_impact": False, "do_filter": False, "verbose": False},
        "model": {"kwargs": {"size": 19, "nested_sizes": [16, 16], "n_blocks": 3, "n_conditions": 12,
                             "act_norm": True, "random_state": 0}},
        "feature_networks": [
            {"type": "ConcatenateCondition", "kwargs": {"input_size": None, "output_size": 15}},
            {"type": "FullyConnected", "kwargs": {"sizes": [15, 16, 12]}},
        ],
        "optimizer": {"type": "Adam", "kwargs": {"lr": 2.0e-3}},
        "lr_scheduler": {"type": "ReduceLROnPlateau",
                         "kwargs": {"mode": "min", "factor": 0.5, "patience": 50, "threshold_mode": "abs",
                                    "threshold": 0.1}},
        "training": {"validation_split": 0.25, "val_loss_window_size": 3, "val_loss_patience": 1000,
                     "val_loss_tolerance": 0.01, "val_loss_tolerance_mode": "abs", "batch_size": 32,
                     "n_epochs": 2, "timeout": None, "random_state": 0},
    }
    config = d / "tiny.yaml"
    config.write_text(yaml.safe_dump(cfg, sort_keys=False))
    model_dir = d / "model"
    main(["train", "-c", str(config), "-o", str(model_dir), "--device", "cpu", "--seed", "1"])
    test_set = d / "test.pkl"
    main(["generate", "-c", PRIOR, "-o", str(test_set), "-n", "24", "--no-filter", "--renderer", "analytic",
          *TINY_GRID, "--seed", "2", "--device", "cpu"])
    return d, model_dir, test_set


def test_generate_writes_the_jax_schema(tmp_path):
    ours, ref = tmp_path / "ours.pkl", tmp_path / "ref.pkl"
    main(["generate", "-c", PRIOR, "-o", str(ours), "-n", "10", *TINY_GRID, "--seed", "0", "--device", "cpu"])
    jax_main(["generate", "-c", PRIOR, "-o", str(ref), "-n", "10", *TINY_GRID, "--seed", "0",
              "--renderer", "analytic"])
    with open(ours, "rb") as f:
        a = pickle.load(f)
    with open(ref, "rb") as f:
        b = pickle.load(f)
    assert sorted(a) == sorted(b) and "trajectories" in a and "videos" not in a
    for k in b:
        assert isinstance(a[k], list) and len(a[k]) == len(b[k]) == 10, k
        assert np.asarray(a[k]).shape == np.asarray(b[k]).shape and np.asarray(a[k]).dtype == np.float32, k
    assert np.isfinite(np.asarray(a["trajectories"])).all()


def test_train_without_data_generates_it_and_trains(trained):
    d, model_dir, _ = trained
    with open(d / "data" / "data.pkl", "rb") as f:
        data = pickle.load(f)
    assert len(data["trajectories"]) == 96 and np.asarray(data["trajectories"]).shape[1:] == (5, 3)
    assert json.loads((model_dir / "config.json").read_text()) == {"config_path": str(d / "tiny.yaml")}
    with open(model_dir / "params.pkl", "rb") as f:
        params = pickle.load(f)
    assert all(np.isfinite(a).all() for a in _leaves(params))
    losses = [json.loads(ln) for ln in (model_dir / "metrics.jsonl").read_text().splitlines()]
    assert losses and all(np.isfinite(v) for m in losses for v in m.values() if isinstance(v, float))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("resim", [False, True], ids=["skip_resim", "resim"])
def test_eval_report_matches_jax_on_the_same_model_and_data(trained, tmp_path, resim):
    _, model_dir, test_set = trained
    flags = ["-m", str(model_dir), "-d", str(test_set), "-M", "40", "--resim-samples", "6", "--max-points", "24"]
    if not resim:
        flags.append("--skip-resim")
    main(["eval", *flags, "-o", str(tmp_path / "ours"), "--device", "cpu"])
    jax_main(["eval", *flags, "-o", str(tmp_path / "ref")])
    ours = json.loads((tmp_path / "ours" / "report.json").read_text())
    ref = json.loads((tmp_path / "ref" / "report.json").read_text())
    assert sorted(ours) == sorted(ref)
    assert abs(ours["test_nll"] - ref["test_nll"]) <= 1e-4  # same weights and points: deterministic
    for k in ("n_points", "M_samples", "sup_band_99", "sup_band_99_joint", "degenerate_dims",
              "n_nondegenerate_dims", "data_spread_by_dim"):
        assert ours[k] == ref[k], k
    assert sorted(ours["calibration_verdict_by_dim"]) == sorted(ref["calibration_verdict_by_dim"])
    assert 0 < ours["rank_mean_frac"] < 1
    figures = {"rank_histograms.png", "cdf_residuals.png"} | ({"resimulation.png"} if resim else set())
    assert figures <= set(os.listdir(tmp_path / "ours"))
    if resim:
        assert 0 < ours["resim_finite_frac"] <= 1 and np.isfinite(ours["resim_median_mse_mean"])


def test_eval_refusals_and_device_rule(trained, tmp_path):
    _, model_dir, test_set = trained
    base = ["eval", "-m", str(model_dir), "-d", str(test_set), "-o", str(tmp_path / "r")]
    # the precision override: a string the port does not take fails before any work; a reduced one runs
    with pytest.raises(ValueError, match="BF16_BF16_F32_X3"):
        main([*base, "--precision", "tensorfloat32", "--device", "cpu"])
    assert not (tmp_path / "r").exists()
    main([*base, "--precision", "bfloat16", "--device", "cpu", "-M", "16", "--max-points", "4", "--skip-resim"])
    with open(tmp_path / "r" / "report.json") as f:
        assert np.isfinite(json.load(f)["test_nll"])
    # --dp-devices shards the ranks and the resimulation over a mesh of CPU shards
    # (tests/test_torch_port_cli_parallel.py holds its report against one device's)
    main([*base, "--dp-devices", "2", "--device", "cpu", "-M", "16", "--max-points", "4", "--resim-samples", "4"])
    with open(tmp_path / "r" / "report.json") as f:
        report = json.load(f)
    assert np.isfinite(report["test_nll"]) and 0 < report["resim_finite_frac"] <= 1
    if torch.cuda.is_available():
        pytest.skip("checks the device rule of a host without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(base)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["generate", "-c", PRIOR, "-o", str(tmp_path / "g.pkl"), "-n", "2"])
