"""The port's CLI end to end on the CPU, mirroring tests/test_cli.py:
`generate` -> `train` -> `sample` -> `eval` at a small run config, `sample
--precision BF16_BF16_F32_X3`, and `hpo` (3 calls, 2 initial points, 2
folds, 1 epoch); the re-runs of `train` (with `--checkpoint-every`) and of
`hpo` resume from their checkpoints."""

import json
import os
import pickle

import numpy as np
import pytest
import torch
import yaml

from bcnf_tpu.hpo.gp_minimize import load_checkpoint as jax_load_checkpoint
from bcnf_tpu_torch.__main__ import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRIOR = os.path.join(REPO, "configs", "data_prior.yaml")
TINY_GRID = ["--dt", "0.1", "-T", "0.5"]
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _root_env(monkeypatch):
    monkeypatch.setenv("BCNF_ROOT", REPO)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """tests/test_cli.py's tiny run config, and a 64-point dataset from the
    port's `generate` on its grid."""
    d = tmp_path_factory.mktemp("cli_e2e")
    data = d / "data.pkl"
    main(["generate", "-c", PRIOR, "-o", str(data), "-n", "64", "--no-filter", "--renderer", "analytic",
          *TINY_GRID, "--seed", "3", *CPU])
    cfg = {
        "global": {"cnf_version": 2,
                   "parameter_selection": ["x0_x", "x0_y", "x0_z", "v0_x", "v0_y", "v0_z", "g", "w_x", "w_y",
                                           "w_z", "b", "m", "a_x", "a_y", "a_z", "r", "A", "Cd", "rho"],
                   "conditions": [["trajectories"]], "dtype": "float32"},
        "data": {"path": str(data), "config_file": "{{BCNF_ROOT}}/configs/data_prior.yaml", "n_samples": 64,
                 "output_type": "trajectories", "dt": 0.1, "T": 0.5, "num_cams": 2, "break_on_impact": False,
                 "do_filter": False, "verbose": False},
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
                     "n_epochs": 3, "timeout": None, "random_state": 0},
    }
    path = d / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return str(path), d


def test_cli_generate_train_sample_eval(tiny, tmp_path, capsys):
    """generate -> train -> sample -> eval, all on the CPU; `sample
    --precision BF16_BF16_F32_X3` gives the float32 samples there (the CPU
    computes float32 at every precision, as JAX's does); a re-run of `train`
    with `--checkpoint-every` resumes from its last epoch."""
    path, d = tiny
    model_dir = tmp_path / "model"
    main(["train", "-c", path, "-o", str(model_dir), "-f", "--checkpoint-every", "1", *CPU])
    assert (model_dir / "params.pkl").exists() and (model_dir / "metrics.jsonl").exists()
    assert json.loads((model_dir / "config.json").read_text())["config_path"] == path
    capsys.readouterr()
    main(["train", "-c", path, "-o", str(model_dir), "-f", "--checkpoint-every", "1", *CPU])
    assert "Resumed from" in capsys.readouterr().out

    test_set = tmp_path / "test.pkl"
    main(["generate", "-c", PRIOR, "-o", str(test_set), "-n", "12", "--no-filter", "--renderer", "analytic",
          *TINY_GRID, "--seed", "4", *CPU])
    samples = {}
    for precision in (None, "BF16_BF16_F32_X3"):
        out = tmp_path / f"samples_{precision}.npy"
        main(["sample", "-m", str(model_dir), "-d", str(test_set), "-n", "8", "-o", str(out), *CPU,
              *(["--precision", precision] if precision else [])])
        samples[precision] = np.load(out)
        assert samples[precision].shape == (8, 12, 19) and np.isfinite(samples[precision]).all()
    np.testing.assert_array_equal(samples[None], samples["BF16_BF16_F32_X3"])

    report_dir = tmp_path / "report"
    main(["eval", "-m", str(model_dir), "-d", str(test_set), "-o", str(report_dir), "-M", "32",
          "--resim-samples", "8", "--precision", "default", *CPU])
    report = json.loads((report_dir / "report.json").read_text())
    assert np.isfinite(report["test_nll"]) and report["n_points"] == 12 and report["M_samples"] == 32
    assert 0 < report["rank_mean_frac"] < 1


def test_cli_hpo_runs_checkpoints_and_resumes(tiny, tmp_path, capsys):
    """`hpo` with JAX's flags: three calls (two random, one from the GP),
    `hpo_checkpoint.pkl` in JAX's format and `best.json`; a re-run with one
    more call resumes from the checkpoint; `--space` bounds every point."""
    _, d = tiny
    out = tmp_path / "hpo"
    args = ["hpo", "-d", str(d / "data.pkl"), "-o", str(out), "--n-initial-points", "2", "--n-splits", "2",
            "--n-epochs", "1", "--n-samples", "64", *CPU]
    main([*args, "--n-calls", "3"])
    state = jax_load_checkpoint(str(out / "hpo_checkpoint.pkl"))
    assert sorted(state) == ["func_vals", "rng_seed", "x_iters"] and len(state["x_iters"]) == 3
    assert isinstance(state["rng_seed"], int) and all(isinstance(x, list) for x in state["x_iters"])
    best = json.loads((out / "best.json").read_text())
    assert best["n_evaluations"] == 3 and sorted(best["best_params"]) == sorted(
        ["n_blocks", "nested_width", "n_nested_layers", "n_conditions", "lr", "dropout"])
    capsys.readouterr()
    main([*args, "--n-calls", "4"])
    assert "Resumed HPO" in capsys.readouterr().out
    with open(out / "hpo_checkpoint.pkl", "rb") as f:
        resumed = pickle.load(f)
    assert resumed["x_iters"][:3] == state["x_iters"] and resumed["func_vals"][:3] == state["func_vals"]
    assert json.loads((out / "best.json").read_text())["n_evaluations"] == 4

    out2 = tmp_path / "hpo2"
    main(["hpo", "-d", str(d / "data.pkl"), "-o", str(out2), "--n-calls", "2", "--n-initial-points", "2",
          "--n-splits", "2", "--n-epochs", "1", "--n-samples", "32", *CPU,
          "--space", json.dumps({"n_blocks": [3, 4], "nested_width": [8, 12]})])
    for x in jax_load_checkpoint(str(out2 / "hpo_checkpoint.pkl"))["x_iters"]:
        assert 3 <= x[0] <= 4 and 8 <= x[1] <= 12


def test_hpo_without_device_raises_on_gpu_less_host(tiny, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the device rule of a host without a GPU")
    _, d = tiny
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["hpo", "-d", str(d / "data.pkl"), "-o", str(tmp_path / "h"), "--n-calls", "1"])
