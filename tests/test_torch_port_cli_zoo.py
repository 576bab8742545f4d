"""Port parity, the model zoo through the CLI: `train` -> `sample` -> `eval`
on the CPU for shrunken copies of `configs/runs/nll/t_PTRF_small.yaml` (the
Transformer encoder, width 46 with 4 heads, positional embeddings) and of
`configs/runs/trajectory_LSTM_noisy_calib7.yaml` (the RQS coupling), with
their datasets generated by `train`. `size` is held against `bcnf-tpu size`
on the published configs, and `eval`'s test NLL against `bcnf-tpu eval` on
the same model directory and test set (1e-4, as
tests/test_torch_port_cli_eval.py). Sampled draws are not compared: the two
packages' random streams differ."""

import json
import os

import numpy as np
import pytest
import yaml

from bcnf_tpu.__main__ import main as jax_main
from bcnf_tpu_torch.__main__ import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRIOR = os.path.join(REPO, "configs", "data_prior.yaml")
TINY_GRID = ["--dt", "0.1", "-T", "0.5"]
CONFIGS = {"t_PTRF_small": "configs/runs/nll/t_PTRF_small.yaml",
           "calib7": "configs/runs/trajectory_LSTM_noisy_calib7.yaml"}


@pytest.fixture(autouse=True)
def _root_env(monkeypatch):
    monkeypatch.setenv("BCNF_ROOT", REPO)


def _shrunk(name: str, data_dir: str) -> dict:
    """The published config at a few blocks and narrow widths, on a 5-frame
    grid with 64 generated trajectories and 2 short epochs."""
    with open(os.path.join(REPO, CONFIGS[name])) as f:
        cfg = yaml.safe_load(f)
    cfg["model"]["kwargs"].update(nested_sizes=[16, 16] if name == "t_PTRF_small" else [8, 8], n_blocks=3,
                                  n_conditions=12)
    enc = cfg["feature_networks"][1]["kwargs"]
    if name == "t_PTRF_small":
        enc.update(n_blocks=2, output_size=12)  # trf_size 46 with 4 heads kept
    else:
        enc.update(hidden_size=6, output_size=12)
    cfg["data"].update(path=data_dir, n_samples=64, dt=0.1, T=0.5, verbose=False)
    cfg["training"].update(batch_size=16, n_epochs=2, timeout=None, val_loss_window_size=2, validation_split=0.25,
                           verbose=False)
    return cfg


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def trained(request, tmp_path_factory):
    name = request.param
    d = tmp_path_factory.mktemp(name)
    config = d / f"{name}.yaml"
    config.write_text(yaml.safe_dump(_shrunk(name, str(d / "data")), sort_keys=False))
    model_dir = d / "model"
    main(["train", "-c", str(config), "-o", str(model_dir), "--device", "cpu", "--seed", "1"])
    test_set = d / "test.pkl"
    main(["generate", "-c", PRIOR, "-o", str(test_set), "-n", "16", "--no-filter", "--renderer", "analytic",
          *TINY_GRID, "--seed", "2", "--device", "cpu"])
    return name, d, model_dir, test_set


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_size_matches_jax_on_the_published_config(name, capsys):
    path = os.path.join(REPO, CONFIGS[name])
    main(["size", "-c", path])
    ours = capsys.readouterr().out.strip()
    jax_main(["size", "-c", path])
    assert ours == capsys.readouterr().out.strip()
    assert ours == {"t_PTRF_small": "Model size: 1,810,633 parameters",
                    "calib7": "Model size: 337,201 parameters"}[name]


def test_train_then_sample(trained, tmp_path):
    name, d, model_dir, test_set = trained
    losses = [json.loads(ln) for ln in (model_dir / "metrics.jsonl").read_text().splitlines()]
    assert losses and all(np.isfinite(v) for m in losses for v in m.values() if isinstance(v, float))
    out = tmp_path / "samples.npy"
    main(["sample", "-m", str(model_dir), "-d", str(test_set), "-n", "7", "-o", str(out), "--device", "cpu",
          "--seed", "3"])
    samples = np.load(out)
    size = 21 if name == "t_PTRF_small" else 19
    assert samples.shape == (7, 16, size) and np.isfinite(samples).all()


def test_eval_test_nll_matches_jax_on_the_same_model_and_data(trained, tmp_path):
    name, d, model_dir, test_set = trained
    flags = ["-m", str(model_dir), "-d", str(test_set), "-M", "30", "--max-points", "16", "--skip-resim"]
    main(["eval", *flags, "-o", str(tmp_path / "ours"), "--device", "cpu"])
    jax_main(["eval", *flags, "-o", str(tmp_path / "ref")])
    ours = json.loads((tmp_path / "ours" / "report.json").read_text())
    ref = json.loads((tmp_path / "ref" / "report.json").read_text())
    assert sorted(ours) == sorted(ref)
    assert np.isfinite(ours["test_nll"])
    assert abs(ours["test_nll"] - ref["test_nll"]) <= 1e-4, (ours["test_nll"], ref["test_nll"])
    for k in ("n_points", "M_samples", "degenerate_dims", "n_nondegenerate_dims"):
        assert ours[k] == ref[k], k
    assert 0 < ours["rank_mean_frac"] < 1
