"""Port parity, training slice: the model's training loss and grads, one
optimizer update, ActNorm data init, the split, the plateau scheduler and
the metric history, a short `Trainer.train` and the `train` CLI, each held
against the JAX package on the same seeded numpy inputs and bridged weights
(JAX on its XLA path: the CPU keeps its kernel gates closed). Tolerances: the
loss 1e-5 and grads atol 5e-4 / rtol 1e-3 (tests/test_flow_kernel.py:307,
313); per-epoch val_loss rtol 1e-3 after three updates, where the two
frameworks' float32 sums and Adam arithmetic differ only in rounding."""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from bcnf_tpu.config import load_config as jax_load_config
from bcnf_tpu.models import CondRealNVP as JaxCondRealNVP
from bcnf_tpu.models import ConcatenateCondition as JaxConcat
from bcnf_tpu.models import FeatureNetworkStack as JaxStack
from bcnf_tpu.models import LSTMFeatureNetwork as JaxLSTMNet
from bcnf_tpu.train import Trainer as JaxTrainer
from bcnf_tpu.train.data import TrainerDataHandler as JaxDataHandler
from bcnf_tpu.train.history import TrainerParameterHistoryHandler as JaxHistory
from bcnf_tpu.train.optim import ReduceLROnPlateau as JaxPlateau
from bcnf_tpu.train.optim import make_optimizer as jax_make_optimizer
from bcnf_tpu.utils.misc import inn_nll_loss as jax_nll
from bcnf_tpu_torch.__main__ import main
from bcnf_tpu_torch.bridge import map_tree, params_from_numpy, params_to_numpy, tree_leaves
from bcnf_tpu_torch.config import load_config as port_load_config
from bcnf_tpu_torch.config import sub_root_path
from bcnf_tpu_torch.models import CondRealNVP, ConcatenateCondition, FeatureNetworkStack, LSTMFeatureNetwork
from bcnf_tpu_torch.parallel import make_mesh
from bcnf_tpu_torch.train import (
    DeviceDataset,
    ReduceLROnPlateau,
    Trainer,
    TrainerDataHandler,
    TrainerParameterHistoryHandler,
    get_learning_rate,
    make_optimizer,
    train_CondRealNVP,
)
from bcnf_tpu_torch.utils.misc import inn_nll_loss

SIZE, N_COND_FEATURES, NESTED, N_BLOCKS, T_STEPS = 7, 8, [16, 16, 16], 4, 6


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _models(hybrid: bool = False, dropout: float = 0.0):
    kw = dict(input_size=3, hidden_size=6, output_size=N_COND_FEATURES, num_layers=2, bidirectional=True)
    model_kw = dict(size=SIZE, nested_sizes=NESTED, n_blocks=N_BLOCKS, n_conditions=N_COND_FEATURES,
                    act_norm=True, random_state=0, hybrid=hybrid, dropout=dropout)
    jm = JaxCondRealNVP(feature_network_stack=JaxStack([JaxConcat(None, 3), JaxLSTMNet(**kw)]), **model_kw)
    tm = CondRealNVP(feature_network_stack=FeatureNetworkStack(
        [ConcatenateCondition(None, 3), LSTMFeatureNetwork(**kw)]), **model_kw)
    return jm, tm


def _data(n: int, seed: int):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(n, SIZE)).astype(np.float32)
    traj = rng.normal(size=(n, T_STEPS, 3)).astype(np.float32)
    return y, traj


def _config(n_epochs: int, batch_size: int, **training) -> dict:
    return {
        "global": {"dtype": "float32"},
        "optimizer": {"type": "Adam", "kwargs": {"lr": 2e-3}},
        "lr_scheduler": {"type": "ReduceLROnPlateau",
                         "kwargs": {"mode": "min", "factor": 0.5, "patience": 1, "threshold_mode": "abs",
                                    "threshold": 0.1}},
        "training": {"validation_split": 0.25, "val_loss_window_size": 2, "val_loss_patience": 50,
                     "val_loss_tolerance": 0.1, "val_loss_tolerance_mode": "abs", "random_state": 3,
                     "batch_size": batch_size, "n_epochs": n_epochs, "timeout": None, **training},
    }


# ---------------------------------------------------------------------------
# the loss and its grads on bridged params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hybrid_weight", [0.0, 0.5], ids=["nll", "hybrid"])
def test_loss_and_grads_match_jax_value_and_grad(hybrid_weight):
    """The Trainer's loss_fn on bridged params against JAX's value_and_grad
    of the same objective (`bcnf_tpu/train/trainer.py:113-128`)."""
    jm, tm = _models(hybrid=hybrid_weight > 0)
    jp = _np_tree(jm.init(jax.random.key(2)))
    rng = np.random.default_rng(5)
    jp["blocks"]["actnorm"]["scale"] = (1.0 + 0.2 * rng.normal(size=(N_BLOCKS - 1, SIZE))).astype(np.float32)
    y, traj = _data(12, seed=6)

    def jax_loss(p):
        z, ld, h = jm.forward(p, jnp.asarray(y), jnp.asarray(traj), train=True, return_features=True)
        nll = jax_nll(z, ld)
        mse = jnp.mean((jm.predict_head(p, h) - y) ** 2) if hybrid_weight > 0 else jnp.zeros(())
        return (nll + mse * hybrid_weight) / (1 + hybrid_weight)

    v_ref, g_ref = jax.value_and_grad(jax_loss)(jax.tree.map(jnp.asarray, jp))
    trainer = Trainer(_config(1, 12), data=(y, [traj]), hybrid_weight=hybrid_weight, device="cpu")
    tp = params_from_numpy(jp, "cpu", requires_grad=True)
    loss, nll, mse, ld = trainer.loss_fn(tm, tp, torch.from_numpy(y), [torch.from_numpy(traj)], None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(v_ref), atol=1e-5, rtol=0)
    assert (mse.item() > 0) == (hybrid_weight > 0)
    flat_ref = jax.tree.leaves_with_path(_np_tree(g_ref))
    ours = list(tree_leaves(map_tree(lambda t: t.grad, tp)))
    assert len(ours) == len(flat_ref)
    for (path, ref), g in zip(flat_ref, ours):
        if "ortho" in jax.tree_util.keystr(path):
            assert g is None and not np.any(ref)  # the fixed mixes: stop_gradient in JAX, detached here
            continue
        np.testing.assert_allclose(g.numpy(), ref, atol=5e-4, rtol=1e-3, err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# optimizer, scheduler, history, split, ActNorm init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kwargs", [("Adam", {}), ("AdamW", {}), ("SGD", {"momentum": 0.9})])
def test_clipped_updates_match_optax(name, kwargs):
    """Two updates, the first clipped (global norm > 1), the second not, one
    leaf without a grad (optax sees zeros there)."""
    rng = np.random.default_rng(7)
    tree = {"a": rng.normal(size=(5, 3)).astype(np.float32), "b": [rng.normal(size=(4,)).astype(np.float32),
                                                                   rng.normal(size=(2, 2)).astype(np.float32)]}
    grads = [jax.tree.map(lambda a: (3.0 * rng.normal(size=a.shape)).astype(np.float32), tree),
             jax.tree.map(lambda a: (0.01 * rng.normal(size=a.shape)).astype(np.float32), tree)]
    for g in grads:
        g["b"][1] = np.zeros_like(g["b"][1])
    jopt = jax_make_optimizer(name, lr=1e-2, **kwargs)
    jp = jax.tree.map(jnp.asarray, tree)
    state = jopt.init(jp)
    tp = params_from_numpy(tree, "cpu", requires_grad=True)
    opt = make_optimizer(name, lr=1e-2, **kwargs).init(tp)
    for g in grads:
        updates, state = jopt.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        for p, gl in zip(tree_leaves(tp), tree_leaves(g)):
            p.grad = None if not np.any(gl) else torch.from_numpy(gl)
        opt.step()
    for a, b in zip(tree_leaves(params_to_numpy(tp)), jax.tree.leaves(_np_tree(jp))):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)
    assert get_learning_rate(opt) == pytest.approx(1e-2)


def test_adamw_decays_at_optax_default():
    opt = make_optimizer("AdamW", lr=1e-3).init({"w": torch.ones(3, requires_grad=True)})
    assert opt.torch_optimizer.param_groups[0]["weight_decay"] == 1e-4
    with pytest.raises(NotImplementedError):
        make_optimizer("RMSprop")


def test_plateau_scheduler_and_history_match_jax():
    metrics = [5.0, 4.0, 4.05, 4.02, 3.99, 4.1, 4.2, 2.0, 2.01, 2.02, 2.03, 2.04, 2.05, 2.05, 2.05]
    kw = dict(mode="min", factor=0.5, patience=2, threshold=0.1, threshold_mode="abs")
    ours, ref = ReduceLROnPlateau(**kw), JaxPlateau(**kw)
    hist_kw = dict(val_loss_window_size=3, val_loss_patience=4, val_loss_tolerance_mode="rel", val_loss_tolerance=1e-2)
    h_ours, h_ref = TrainerParameterHistoryHandler(**hist_kw), JaxHistory(**hist_kw)
    lr_ours = lr_ref = 1e-3
    exceeded = []
    for epoch, m in enumerate(metrics):
        for h in (h_ours, h_ref):
            h.update_epoch(epoch)
            h.update_rolling_validation_loss(m)
            h.log("val_loss", m)
        lr_ours, lr_ref = ours.step(h_ours.val_loss_rolling_avg, lr_ours), ref.step(h_ref.val_loss_rolling_avg, lr_ref)
        h_ours.update_best_loss()
        h_ref.update_best_loss()
        assert lr_ours == lr_ref
        assert h_ours.patience_exceeded == h_ref.patience_exceeded
        assert ours.state_dict() == ref.state_dict()
        exceeded.append(h_ours.patience_exceeded)
    assert lr_ours < 1e-3 and any(exceeded)
    assert h_ours.parameter_history == h_ref.parameter_history


def test_split_and_device_batches():
    y, traj = _data(23, seed=8)
    (ty, (tc,)), (vy, (vc,)) = TrainerDataHandler.split_dataset(y, [traj], 0.3, seed=11)
    (jy, (jc,)), (jvy, (jvc,)) = JaxDataHandler.split_dataset(y, [traj], 0.3, seed=11)
    for a, b in ((ty, jy), (tc, jc), (vy, jvy), (vc, jvc)):
        np.testing.assert_array_equal(a, b)
    ds = DeviceDataset(ty, [tc], torch.device("cpu"))
    seen = torch.cat([b for b, _ in ds.batches(5, torch.Generator().manual_seed(0))])
    assert ds.n_batches(5) == 4 and ds.n_batches(5, drop_remainder=True) == 3
    assert sorted(map(tuple, seen.numpy().tolist())) == sorted(map(tuple, ty.tolist()))  # a permutation
    padded = list(ds.batches_padded(5))
    assert all(b.shape == (5, SIZE) for b, _, _ in padded)
    w = torch.cat([w for _, _, w in padded])
    assert w.sum() == ds.n and torch.equal(padded[-1][0][1:], torch.from_numpy(ty[:4]))  # wrap-around rows


def test_init_actnorm_matches_jax():
    jm, tm = _models()
    jp = jm.init(jax.random.key(4))
    y, traj = _data(40, seed=9)
    ref = _np_tree(jm.init_actnorm(jp, jnp.asarray(y), jnp.asarray(traj))["blocks"]["actnorm"])
    tp = params_from_numpy(_np_tree(jp), "cpu")
    ours = tm.init_actnorm(tp, torch.from_numpy(y), torch.from_numpy(traj))["blocks"]["actnorm"]
    np.testing.assert_allclose(ours["scale"].numpy(), ref["scale"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ours["bias"].numpy(), ref["bias"], atol=1e-5, rtol=1e-5)
    assert torch.equal(tp["blocks"]["actnorm"]["scale"], torch.ones(N_BLOCKS - 1, SIZE))  # input untouched


# ---------------------------------------------------------------------------
# the Trainer, checkpoint/resume, stop rules
# ---------------------------------------------------------------------------


def test_trainer_val_loss_matches_jax_trainer():
    """Three epochs with the whole train split as one batch (so the shuffle
    cannot matter), from the same weights; ActNorm data init on both sides."""
    jm, tm = _models()
    jp = _np_tree(jm.init(jax.random.key(1)))
    y, traj = _data(32, seed=10)
    cfg = _config(3, 24)
    ref = JaxTrainer(cfg, data=(y, [traj]))
    ref.train(jm, jax.tree.map(jnp.asarray, jp))
    ours = Trainer(cfg, data=(y, [traj]), device="cpu")
    ours.train(tm, params_from_numpy(jp, "cpu"))
    h_ref, h = ref.meta_scheduler.parameter_history, ours.meta_scheduler.parameter_history
    assert [e for e, _ in h["val_loss"]] == [e for e, _ in h_ref["val_loss"]] == [1, 2, 3]
    for key in ("val_loss", "train_loss", "log_det_J"):
        np.testing.assert_allclose([v for _, v in h[key]], [v for _, v in h_ref[key]], rtol=1e-3, atol=1e-4,
                                   err_msg=key)
    assert h["stop_reason"] == h_ref["stop_reason"] == "max_epochs"


def test_checkpoint_resume_gives_the_uninterrupted_params(tmp_path):
    _, tm = _models()
    y, traj = _data(30, seed=12)
    p0 = tm.init(torch.Generator().manual_seed(0), device="cpu")
    straight = Trainer(_config(4, 8), data=(y, [traj]), device="cpu").train(tm, p0)
    first = Trainer(_config(2, 8), data=(y, [traj]), device="cpu", checkpoint_dir=str(tmp_path), checkpoint_every=1)
    first.train(tm, p0)
    assert sorted(p.name for p in tmp_path.glob("ckpt_*.pkl")) == ["ckpt_0.pkl", "ckpt_1.pkl"]
    resumed = Trainer(_config(4, 8), data=(y, [traj]), device="cpu", checkpoint_dir=str(tmp_path),
                      checkpoint_every=1).train(tm, p0)
    for a, b in zip(tree_leaves(resumed), tree_leaves(straight)):
        assert torch.equal(a, b)
    assert torch.equal(p0["blocks"]["actnorm"]["scale"], torch.ones(N_BLOCKS - 1, SIZE))  # caller's tree kept


def test_stop_rules_and_refusals():
    _, tm = _models()
    y, traj = _data(20, seed=13)
    p0 = tm.init(torch.Generator().manual_seed(1), device="cpu")
    t = Trainer(_config(5, 8, timeout=0.0), data=(y, [traj]), device="cpu")
    t.train(tm, p0)
    assert t.meta_scheduler.parameter_history["stop_reason"] == "timeout"
    assert len(t.meta_scheduler.parameter_history["val_loss"]) == 1
    t = Trainer(dict(_config(6, 8), training=dict(_config(6, 8)["training"], val_loss_patience=0)),
                data=(y, [traj]), device="cpu")
    t.train(tm, p0)
    assert t.meta_scheduler.parameter_history["stop_reason"] == "val_loss_plateau"
    t = Trainer(_config(3, 8, keep_best=True, freeze_features=True), data=(y, [traj]), device="cpu")
    best = t.train(tm, p0)
    val = [v for _, v in t.meta_scheduler.parameter_history["val_loss"]]
    assert t.meta_scheduler.parameter_history["stop_reason"] == "max_epochs" and len(val) == 3
    for a, b in zip(tree_leaves(best["features"]), tree_leaves(p0["features"])):
        assert torch.equal(a, b)  # frozen conditioner
    # training.remat and a mesh train (held against the plain and the one-device runs in
    # tests/test_torch_port_utils.py and tests/test_torch_port_parallel.py)
    for trainer in (Trainer(_config(1, 8, remat=True), data=(y, [traj]), device="cpu"),
                    Trainer(_config(1, 8), data=(y, [traj]), mesh=make_mesh(2, device="cpu"))):
        params = trainer.train(tm, p0)
        assert trainer.meta_scheduler.parameter_history["stop_reason"] == "max_epochs"
        assert all(torch.isfinite(t).all() for t in tree_leaves(params))
    assert tm.remat  # training.remat: true set the model's flag


def test_train_condrealnvp_functional_api():
    _, tm = _models()
    y, traj = _data(24, seed=14)
    params, history = train_CondRealNVP(tm, tm.init(torch.Generator().manual_seed(2), device="cpu"),
                                        y[:16], [traj[:16]], y[16:], [traj[16:]], n_epochs=2, batch_size=8,
                                        device="cpu")
    assert len(history["train"]) == len(history["val"]) == 2 and history["stop_reason"] == "max_epochs"
    z, ld = tm.forward(params, torch.from_numpy(y[16:]), torch.from_numpy(traj[16:]))
    assert torch.isfinite(inn_nll_loss(z, ld))


class _CudaRows:
    """Stands in for a CUDA batch of `n` rows: all the gate reads of it."""

    is_cuda = True

    def __init__(self, n: int) -> None:
        self.shape = (n, SIZE)

    def dim(self) -> int:
        return 2


def test_training_gate(monkeypatch):
    """`_use_fused_train` of the JAX package: closed for coupling dropout in
    training, for a batch under the floor (256, or BCNF_FUSED_TRAIN_MIN_BATCH)
    and for a CPU tensor; the plain autograd path runs there."""
    _, tm = _models()
    _, tm_drop = _models(dropout=0.2)
    assert tm.fused_train_min_batch == 256
    assert tm._use_fused_train(True, _CudaRows(256))
    assert not tm._use_fused_train(True, _CudaRows(255))
    assert not tm._use_fused_train(True, torch.zeros(512, SIZE))  # a CPU tensor
    assert not tm_drop._use_fused_train(True, _CudaRows(512))
    assert tm_drop._use_fused_train(False, _CudaRows(512))  # dropout only matters in training
    monkeypatch.setenv("BCNF_FUSED_TRAIN_MIN_BATCH", "1024")
    assert not tm._use_fused_train(True, _CudaRows(512))


@pytest.mark.parametrize("size,nested,takes", [
    (19, [526] * 5, True),     # the flagship
    (38, [526] * 5, True),     # the widest size K2b's rows kernel holds at Hp 544
    (39, [526] * 5, False),    # its shared memory refuses one more
    (19, [526] * 14, True),    # nh = 13: 16 weight-grad jobs a step, kAtbMaxJobs
    (19, [526] * 15, False),   # nh = 14: 17 jobs
    (19, [1100] * 5, False),   # past the widest compiled width (32 * 32)
], ids=["flagship", "size38", "size39", "nh13", "nh14", "width1100"])
def test_training_gate_closes_on_shapes_the_kernels_do_not_take(size, nested, takes):
    """`_fused_train_takes` reads the limits the kernels' launchers check
    (`kSmemLimit`, `kAtbMaxJobs`, from their headers): where K2a/K2b would
    return cudaErrorInvalidValue the gate closes and plain autograd trains,
    as JAX falls back to XLA (the card raised at size 39 and at nh 14, and
    ran size 38 and nh 13)."""
    stack = FeatureNetworkStack([ConcatenateCondition(None, 3), LSTMFeatureNetwork(3, 6, N_COND_FEATURES, 1)])
    model = CondRealNVP(size=size, nested_sizes=nested, n_blocks=3, n_conditions=N_COND_FEATURES,
                        feature_network_stack=stack, act_norm=True)
    assert model._fused_train_takes() is takes
    rows = _CudaRows(512)
    rows.shape = (512, size)
    assert model._use_fused_train(True, rows) is takes


# ---------------------------------------------------------------------------
# the train CLI: a model directory both packages read
# ---------------------------------------------------------------------------


def test_train_cli_writes_a_model_dir_jax_loads(tmp_path):
    with open(sub_root_path("{{BCNF_ROOT}}/configs/runs/trajectory_LSTM_large.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["model"]["kwargs"].update(nested_sizes=[16] * 3, n_conditions=8, n_blocks=3, dropout=0.0)
    cfg["feature_networks"][1]["kwargs"].update(hidden_size=6, output_size=8)
    cfg["training"].update(n_epochs=2, batch_size=8)
    cfg_path = tmp_path / "small.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    names = list(cfg["global"]["parameter_selection"])
    rng = np.random.default_rng(15)
    data = {"trajectories": rng.normal(size=(20, 30, 3)).astype(np.float32)}
    data.update({n: rng.normal(size=20).astype(np.float32) for n in names})
    with open(tmp_path / "data.pkl", "wb") as f:
        pickle.dump(data, f)
    out = tmp_path / "model"
    main(["train", "-c", str(cfg_path), "-d", str(tmp_path / "data.pkl"), "-o", str(out), "--device", "cpu",
          "--seed", "3"])
    assert json.loads((out / "config.json").read_text()) == {"config_path": str(cfg_path)}
    assert len((out / "metrics.jsonl").read_text().splitlines()) > 0
    with open(out / "params.pkl", "rb") as f:
        params = pickle.load(f)
    assert all(isinstance(a, np.ndarray) for a in jax.tree.leaves(params))
    jm = JaxCondRealNVP.from_config(jax_load_config(str(cfg_path), verify=False))
    y = rng.normal(size=(5, 19)).astype(np.float32)
    traj = data["trajectories"][:5]
    ref = jm.log_prob(jax.tree.map(jnp.asarray, params), jnp.asarray(y), jnp.asarray(traj))
    tm = CondRealNVP.from_config(port_load_config(str(cfg_path), verify=False))
    ours = tm.log_prob(params_from_numpy(params, "cpu"), torch.from_numpy(y), torch.from_numpy(traj))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    main(["sample", "-m", str(out), "-d", str(tmp_path / "data.pkl"), "-n", "3", "-o", str(tmp_path / "s.npy"),
          "--device", "cpu"])
    assert np.load(tmp_path / "s.npy").shape == (3, 20, 19)
    # a missing dataset is generated from the config's data section, saved, and trained on
    cfg["data"]["n_samples"] = 24
    cfg_path.write_text(yaml.safe_dump(cfg))
    main(["train", "-c", str(cfg_path), "-d", str(tmp_path / "none.pkl"), "-o", str(out), "-f",
          "--device", "cpu"])
    with open(tmp_path / "none.pkl", "rb") as f:
        generated = pickle.load(f)
    assert len(generated["trajectories"]) == 24 and np.asarray(generated["trajectories"]).shape[1:] == (30, 3)
    assert (out / "params.pkl").exists()
    # the data-parallel flags: a 2-shard CPU mesh; a coordinator without --num-processes joins nothing
    for flags in (["--dp-devices", "2"], ["--coordinator", "localhost:1"]):
        (out / "params.pkl").unlink()
        main(["train", "-c", str(cfg_path), "-o", str(out), "-f", "--device", "cpu", *flags])
        with open(out / "params.pkl", "rb") as f:
            assert all(np.isfinite(a).all() for a in jax.tree.leaves(pickle.load(f)))
