"""Port parity, the CLI's online and pretrained-features paths and `size`
for the video model, against the JAX package on the CPU.

`train --online` writes what `bcnf-tpu train --online` writes
(`bcnf_tpu/__main__.py:214-263`): `params.pkl` as a NumPy tree that JAX's
model loads, `config.json` with `config_path`, `online` and
`history_tail`, the metrics file and, with `--checkpoint-every`, the
`online_{step}.pkl` checkpoints. `--pretrained-features` grafts a saved
feature tree as JAX's `load_pretrained_features` does, and a mismatched
tree raises in both packages alike.
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from bcnf_tpu.__main__ import main as jax_main
from bcnf_tpu.config import load_config as jax_load_config
from bcnf_tpu.models import CondRealNVP as JaxCondRealNVP
from bcnf_tpu.models.pretrained import load_pretrained_features as jax_load_pretrained
from bcnf_tpu_torch.__main__ import main
from bcnf_tpu_torch.bridge import map_tree, params_to_numpy
from bcnf_tpu_torch.config import load_config, sub_root_path
from bcnf_tpu_torch.models import CondRealNVP
from bcnf_tpu_torch.models.pretrained import load_pretrained_features


def _toy_config(tmp_path, name: str = "toy.yaml", hidden: int = 6, **training) -> str:
    """The flagship's run config cut to toy widths (5 frames at dt 0.1)."""
    with open(sub_root_path("{{BCNF_ROOT}}/configs/runs/trajectory_LSTM_large.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["model"]["kwargs"].update(nested_sizes=[16] * 3, n_conditions=8, n_blocks=3)
    cfg["feature_networks"][1]["kwargs"].update(hidden_size=hidden, output_size=8)
    cfg["data"].update(dt=0.1, T=0.5, observation_noise=0.05)
    cfg["training"].update(batch_size=16, n_epochs=1, **training)
    path = tmp_path / name
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _dataset(tmp_path, cfg_path: str, n: int = 40) -> str:
    with open(cfg_path) as f:
        names = yaml.safe_load(f)["global"]["parameter_selection"]
    rng = np.random.default_rng(21)
    data = {"trajectories": rng.normal(size=(n, 5, 3)).astype(np.float32)}
    data.update({p: rng.normal(size=n).astype(np.float32) for p in names})
    path = tmp_path / "data.pkl"
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return str(path)


def _jax_loads(cfg_path: str, params: dict) -> None:
    """JAX's model from the same config takes the tree: its structure and
    leaf shapes, and a finite log_prob."""
    jm = JaxCondRealNVP.from_config(jax_load_config(cfg_path, verify=False))
    ref = jax.eval_shape(jm.init, jax.random.key(0))
    assert jax.tree.structure(params) == jax.tree.structure(ref)
    assert [a.shape for a in jax.tree.leaves(params)] == [a.shape for a in jax.tree.leaves(ref)]
    lp = jm.log_prob(jax.tree.map(jnp.asarray, params), jnp.zeros((2, 19)), jnp.ones((2, 5, 3)))
    assert np.isfinite(np.asarray(lp)).all()


def test_train_online_cli_writes_the_jax_files_and_keys(tmp_path):
    cfg_path = _toy_config(tmp_path)
    out = tmp_path / "online"
    main(["train", "-c", cfg_path, "-o", str(out), "--online", "--online-steps", "4", "--online-lr-decay",
          "--checkpoint-every", "2", "--seed", "1", "--device", "cpu"])
    meta = json.loads((out / "config.json").read_text())
    assert set(meta) == {"config_path", "online", "history_tail"} and meta["online"] is True
    assert meta["config_path"] == cfg_path and set(meta["history_tail"]) == {"train_loss", "eval_nll"}
    assert [s for s, _ in meta["history_tail"]["eval_nll"]] == [4]
    assert sorted(p.name for p in (out / "ckpts").glob("*.pkl")) == ["online_2.pkl", "online_4.pkl"]
    assert json.loads((out / "metrics.jsonl").read_text().splitlines()[-1])["eval_nll"] == pytest.approx(
        meta["history_tail"]["eval_nll"][-1][1])
    with open(out / "params.pkl", "rb") as f:
        params = pickle.load(f)
    assert all(isinstance(a, np.ndarray) and np.isfinite(a).all() for a in jax.tree.leaves(params))
    _jax_loads(cfg_path, params)
    # `training.online` in the config takes the same branch; a rerun with
    # --checkpoint-every resumes from the newest checkpoint and stops at once
    main(["train", "-c", _toy_config(tmp_path, "cfg_online.yaml", online=True, online_steps=2), "-o",
          str(tmp_path / "from_config"), "--device", "cpu"])
    assert json.loads((tmp_path / "from_config" / "config.json").read_text())["online"] is True
    main(["train", "-c", cfg_path, "-o", str(out), "-f", "--online", "--online-steps", "4", "--checkpoint-every", "2",
          "--seed", "1", "--device", "cpu"])
    with open(out / "params.pkl", "rb") as f:
        again = pickle.load(f)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(params)))


def test_pretrained_features_round_trip(tmp_path):
    """A model trained by the CLI, its features grafted into a new run with
    `--pretrained-features` and `--freeze-features`: the new run's features
    are the saved ones, bit for bit, and its flow trained; the port's graft
    equals JAX's on the same pickle, whole tree or bare subtree."""
    cfg_path = _toy_config(tmp_path)
    data = _dataset(tmp_path, cfg_path)
    main(["train", "-c", cfg_path, "-d", data, "-o", str(tmp_path / "a"), "--seed", "1", "--device", "cpu"])
    with open(tmp_path / "a" / "params.pkl", "rb") as f:
        saved = pickle.load(f)
    main(["train", "-c", cfg_path, "-d", data, "-o", str(tmp_path / "b"), "--seed", "2", "--device", "cpu",
          "--pretrained-features", str(tmp_path / "a" / "params.pkl"), "--freeze-features"])
    with open(tmp_path / "b" / "params.pkl", "rb") as f:
        grafted = pickle.load(f)
    for a, b in zip(jax.tree.leaves(grafted["features"]), jax.tree.leaves(saved["features"])):
        assert np.array_equal(a, b)
    assert not np.array_equal(grafted["final"]["a"]["layers"][0]["w"], saved["final"]["a"]["layers"][0]["w"])

    model = CondRealNVP.from_config(load_config(cfg_path, verify=False))
    jm = JaxCondRealNVP.from_config(jax_load_config(cfg_path, verify=False))
    bare = tmp_path / "features.pkl"
    with open(bare, "wb") as f:
        pickle.dump(saved["features"], f)
    for path in (tmp_path / "a" / "params.pkl", bare):
        ours = load_pretrained_features(model.init(device="cpu"), str(path))
        ref = jax_load_pretrained(jm.init(jax.random.key(0)), str(path))
        assert ours["features"]["nets"][1]["lstm"]["layers"][0]["fwd"]["w_hh"].dtype == torch.float32
        map_tree(lambda a, b: np.testing.assert_array_equal(a.numpy(), np.asarray(b)), ours["features"],
                 ref["features"])  # key by key


def test_mismatched_pretrained_features_raise_as_in_jax(tmp_path):
    cfg_path = _toy_config(tmp_path)
    model = CondRealNVP.from_config(load_config(cfg_path, verify=False))
    jm = JaxCondRealNVP.from_config(jax_load_config(cfg_path, verify=False))
    wider = CondRealNVP.from_config(load_config(_toy_config(tmp_path, "wide.yaml", hidden=7), verify=False))
    feats = params_to_numpy(wider.init(device="cpu")["features"])  # an LSTM of 7 units, not 6
    cases = {"shape mismatch": feats, "structure mismatch": {"nets": feats["nets"][:1]}}
    for what, tree in cases.items():
        path = tmp_path / f"{what.split()[0]}.pkl"
        with open(path, "wb") as f:
            pickle.dump(tree, f)
        with pytest.raises(ValueError, match=what):
            jax_load_pretrained(jm.init(jax.random.key(0)), str(path))
        with pytest.raises(ValueError, match=what):
            load_pretrained_features(model.init(device="cpu"), str(path))
        with pytest.raises(ValueError, match=what):
            main(["train", "-c", cfg_path, "-d", _dataset(tmp_path, cfg_path), "-o", str(tmp_path / "x"), "-f",
                  "--device", "cpu", "--pretrained-features", str(path)])
    with pytest.raises(ValueError, match="no feature networks"):
        load_pretrained_features({"final": {}}, str(path))


def test_size_prints_the_jax_count_for_the_video_model(capsys):
    config = "{{BCNF_ROOT}}/configs/runs/videos_CNN_LSTM_large.yaml"
    jax_main(["size", "-c", config])
    ref = capsys.readouterr().out.strip().splitlines()[-1]
    main(["size", "-c", config])
    ours = capsys.readouterr().out.strip().splitlines()[-1]
    assert ours == ref == "Model size: 67,787,515 parameters"
