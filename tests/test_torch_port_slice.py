"""Port parity, slice level: the flagship topology (trajectory_LSTM_large's
feature stack and flow, at small widths) built through `from_config` in both
packages, JAX weights bridged into the port, and the `sample` CLI on a model
directory the JAX package's format describes."""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from bcnf_tpu.config import load_config as jax_load_config
from bcnf_tpu.models import CondRealNVP as JaxCondRealNVP
from bcnf_tpu.train.data import TrainerDataHandler as JaxDataHandler
from bcnf_tpu_torch.__main__ import main
from bcnf_tpu_torch.bridge import params_from_numpy, params_to_numpy
from bcnf_tpu_torch.config import load_config, sub_root_path
from bcnf_tpu_torch.models import CondRealNVP, count_params
from bcnf_tpu_torch.train.data import TrainerDataHandler

N_TRAJ, T_STEPS = 5, 30


def _small_flagship_config() -> dict:
    with open(sub_root_path("{{BCNF_ROOT}}/configs/runs/trajectory_LSTM_large.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["model"]["kwargs"].update(nested_sizes=[24] * 5, n_conditions=16, n_blocks=4)
    cfg["feature_networks"][1]["kwargs"].update(hidden_size=8, output_size=16)
    return cfg


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice")
    path = tmp / "small_flagship.yaml"
    path.write_text(yaml.safe_dump(_small_flagship_config()))
    jm = JaxCondRealNVP.from_config(jax_load_config(str(path), verify=False))
    tm = CondRealNVP.from_config(load_config(str(path), verify=False))
    jp = jax.tree.map(np.asarray, jax.device_get(jm.init(jax.random.key(7))))
    rng = np.random.default_rng(3)
    scale = jp["blocks"]["actnorm"]["scale"]
    jp["blocks"]["actnorm"]["scale"] = (1.0 + 0.2 * rng.normal(size=scale.shape)).astype(np.float32)
    traj = rng.normal(size=(N_TRAJ, T_STEPS, 3)).astype(np.float32)
    return path, jm, jp, tm, traj, rng


def test_from_config_builds_the_same_topology(slice_setup):
    path, jm, jp, tm, traj, rng = slice_setup
    assert tm.n_blocks == jm.n_blocks == 4 and tm.nested_sizes == jm.nested_sizes
    assert tm.dropout == jm.dropout == 0.407 and tm.act_norm and tm.size == 19
    ours = tm.init(torch.Generator().manual_seed(0), device="cpu")
    assert count_params(ours) == sum(int(a.size) for a in jax.tree.leaves(jp))


def test_bridge_round_trip_is_exact(slice_setup):
    path, jm, jp, tm, traj, rng = slice_setup
    back = params_to_numpy(params_from_numpy(jp, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    tp = params_from_numpy(jp, "cpu")
    assert sorted(tp["features"]["nets"][1]["lstm"]["layers"][1]["bwd"]) == ["b_hh", "b_ih", "w_hh", "w_ih"]


def test_slice_encode_then_inverse_matches_jax(slice_setup):
    path, jm, jp, tm, traj, rng = slice_setup
    jpj = jax.tree.map(jnp.asarray, jp)
    tp = params_from_numpy(jp, "cpu")
    h_ref = jm.encode(jpj, (jnp.asarray(traj),))
    h = tm.encode(tp, (torch.from_numpy(traj),))
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=1e-5, rtol=0)
    z = rng.normal(size=(9, N_TRAJ, 19)).astype(np.float32)
    y_ref = jax.vmap(lambda zz: jm.inverse_given_h(jpj, zz, h_ref))(jnp.asarray(z))
    y = tm.inverse_given_h(tp, torch.from_numpy(z), h)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-4, rtol=0)


def _write_model_dir(tmp, path, jp, traj, rng):
    model_dir = tmp / "model"
    model_dir.mkdir()
    with open(model_dir / "params.pkl", "wb") as f:  # as `bcnf-tpu train` writes it
        pickle.dump(jp, f)
    with open(model_dir / "config.json", "w") as f:
        json.dump({"config_path": str(path)}, f)
    names = list(load_config(str(path), verify=False)["global"]["parameter_selection"])
    data = {"trajectories": traj}
    data.update({n: rng.normal(size=len(traj)).astype(np.float32) for n in names})
    with open(tmp / "data.pkl", "wb") as f:
        pickle.dump(data, f)
    return model_dir, tmp / "data.pkl", data


def test_sample_cli_on_cpu_matches_the_api(slice_setup, tmp_path):
    path, jm, jp, tm, traj, rng = slice_setup
    model_dir, data_path, _ = _write_model_dir(tmp_path, path, jp, traj, rng)
    out = tmp_path / "samples.npy"
    main(["sample", "-m", str(model_dir), "-d", str(data_path), "-n", "12", "-o", str(out),
          "--seed", "4", "--device", "cpu"])
    cli = np.load(out)
    assert cli.shape == (12, N_TRAJ, 19) and np.isfinite(cli).all()
    api = tm.sample(params_from_numpy(jp, "cpu"), torch.Generator().manual_seed(4), 12,
                    torch.from_numpy(traj), device="cpu")
    np.testing.assert_allclose(cli, api.numpy(), atol=1e-6, rtol=0)
    # and the samples are the JAX model's inverse of the same z
    z = torch.randn((12, N_TRAJ, 19), generator=torch.Generator().manual_seed(4)).numpy()
    jpj = jax.tree.map(jnp.asarray, jp)
    ref = jm.inverse_given_h(jpj, jnp.asarray(z), jm.encode(jpj, (jnp.asarray(traj),)))
    np.testing.assert_allclose(cli, np.asarray(ref), atol=1e-4, rtol=0)


def test_size_cli_counts_the_flagship(capsys):
    main(["size", "-c", "{{BCNF_ROOT}}/configs/runs/trajectory_LSTM_large.yaml"])
    assert "48,852,615 parameters" in capsys.readouterr().out


def test_data_handler_matches_jax_and_waits_for_the_simulator(slice_setup, tmp_path):
    path, jm, jp, tm, traj, rng = slice_setup
    _, data_path, _ = _write_model_dir(tmp_path, path, jp, traj, rng)
    cfg = {k.lower(): v for k, v in load_config(str(path), verify=False).items()}
    cfg["data"] = dict(cfg["data"], path=str(data_path))
    y, conds = TrainerDataHandler().get_data_for_training(cfg, tm.parameter_index_mapping)
    y_ref, conds_ref = JaxDataHandler().get_data_for_training(cfg, jm.parameter_index_mapping)
    np.testing.assert_array_equal(y, y_ref)
    assert len(conds) == len(conds_ref) == 1
    np.testing.assert_array_equal(conds[0], conds_ref[0])
    cfg["data"] = dict(cfg["data"], path=str(tmp_path / "missing.pkl"))
    with pytest.raises(FileNotFoundError, match="data generation waits for the simulator slice"):
        TrainerDataHandler().get_data_for_training(cfg, tm.parameter_index_mapping)
