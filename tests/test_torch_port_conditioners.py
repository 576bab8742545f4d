"""Port parity, conditioners: `FullyConnectedFeatureNetwork`,
`VerboseLSTM.apply_verbose` and `DualDomainLSTM` against the JAX package on
bridged params (dropout off), a cut-down `t_DLSTM_large` built by
`from_config` in both packages (log_prob, inverse, a short Trainer), and
every run config, the video (CNN) ones included, built at its published
widths with the JAX package's parameter tree. Tolerances: features 1e-5, flow outputs
1e-4 (tests/test_flow_kernel.py), per-epoch losses rtol 1e-3 (as
tests/test_torch_port_train.py)."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from bcnf_tpu.config import load_config as jax_load_config
from bcnf_tpu.models import CondRealNVP as JaxCondRealNVP
from bcnf_tpu.models.feature_network import DualDomainLSTM as JaxDualDomainLSTM
from bcnf_tpu.models.feature_network import FullyConnectedFeatureNetwork as JaxFC
from bcnf_tpu.models.feature_network import VerboseLSTM as JaxVerboseLSTM
from bcnf_tpu.train import Trainer as JaxTrainer
from bcnf_tpu_torch.bridge import params_from_numpy, tree_leaves
from bcnf_tpu_torch.config import load_config, sub_root_path
from bcnf_tpu_torch.factories import FeatureNetworkFactory
from bcnf_tpu_torch.models import CondRealNVP, DualDomainLSTM, FullyConnectedFeatureNetwork, VerboseLSTM, count_params
from bcnf_tpu_torch.models import cnn
from bcnf_tpu_torch.ops import lstm, nn
from bcnf_tpu_torch.train import Trainer

ROOT = sub_root_path("{{BCNF_ROOT}}")


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _both(jax_net, port_net, x: np.ndarray, seed: int):
    params = _np_tree(jax_net.init(jax.random.key(seed)))
    ref = jax_net.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    ours = port_net.apply(params_from_numpy(params, "cpu"), torch.from_numpy(x))
    return params, ref, ours


@pytest.mark.parametrize("flatten", [True, False], ids=["flatten", "per-frame"])
def test_fully_connected_matches_jax(flatten):
    x = np.random.default_rng(0).normal(size=(6, 5, 4)).astype(np.float32)
    sizes = [20 if flatten else 4, 16, 12, 8]
    _, ref, ours = _both(JaxFC(sizes, flatten=flatten), FullyConnectedFeatureNetwork(sizes, flatten=flatten), x, 1)
    assert ours.shape == ((6, 8) if flatten else (6, 5, 8))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bidirectional", "one-way"])
def test_verbose_lstm_matches_jax(bidirectional):
    kw = dict(input_size=3, hidden_size=8, num_layers=3, bidirectional=bidirectional)
    jax_net, port_net = JaxVerboseLSTM(**kw), VerboseLSTM(**kw)
    params = _np_tree(jax_net.init(jax.random.key(2)))
    x = np.random.default_rng(3).normal(size=(5, 12, 3)).astype(np.float32)
    x_ref, h_ref = jax_net.apply_verbose(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp = params_from_numpy(params, "cpu")
    x_out, h_out = port_net.apply_verbose(tp, torch.from_numpy(x))
    assert h_out.shape == (5, 3, 12, port_net.output_size)
    np.testing.assert_allclose(x_out.numpy(), np.asarray(x_ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(h_out.numpy(), np.asarray(h_ref), atol=1e-5, rtol=0)
    assert torch.equal(port_net.apply(tp, torch.from_numpy(x)), x_out)


@pytest.mark.parametrize("pooling", ["mean", "max"])
def test_dual_domain_lstm_matches_jax(pooling):
    kw = dict(input_size=3, hidden_size=8, fc_sizes=[24, 16], num_layers=2, bidirectional=True, pooling=pooling)
    x = np.random.default_rng(4).normal(size=(6, 30, 3)).astype(np.float32)
    params, ref, ours = _both(JaxDualDomainLSTM(**kw), DualDomainLSTM(**kw), x, 5)
    assert sorted(params) == ["fc", "freq", "time"] and ours.shape == (6, 16)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_dual_domain_lstm_fused_matches_its_loop(monkeypatch):
    """Under BCNF_FUSED_LSTM=1 the time and frequency LSTMs take the fused
    recurrence (its plain versions here): values and grads of the loop's."""
    net = DualDomainLSTM(input_size=3, hidden_size=8, fc_sizes=[16], num_layers=2, bidirectional=True)
    params = net.init(torch.Generator().manual_seed(6))
    x = torch.randn((7, 30, 3), generator=torch.Generator().manual_seed(7))
    outs = []
    for flag in ("0", "1"):
        monkeypatch.setenv("BCNF_FUSED_LSTM", flag)
        p = {k: v for k, v in params.items()}
        leaves = list(tree_leaves(p))
        for t in leaves:
            t.requires_grad_(True)
            t.grad = None
        out = net.apply(p, x)
        out.pow(2).sum().backward()
        outs.append((out.detach(), [t.grad.clone() for t in leaves]))
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=1e-5, rtol=0)
    for a, b in zip(outs[1][1], outs[0][1]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# t_DLSTM_large, cut down: the same structure at small widths and depth
# ---------------------------------------------------------------------------

N_TRAJ, T_STEPS, SIZE = 6, 30, 21


def _small_dlstm_config(dropout: float | None = None) -> dict:
    with open(os.path.join(ROOT, "configs/runs/nll/t_DLSTM_large.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["model"]["kwargs"].update(nested_sizes=[16, 16], n_blocks=3, n_conditions=16)
    cfg["feature_networks"][1]["kwargs"].update(hidden_size=8, num_layers=2, fc_sizes=[16])
    if dropout is not None:
        cfg["model"]["kwargs"]["dropout"] = dropout
        cfg["feature_networks"][1]["kwargs"].update(dropout=dropout, fc_dropout=dropout)
    return cfg


@pytest.fixture(scope="module")
def dlstm(tmp_path_factory):
    path = tmp_path_factory.mktemp("dlstm") / "small_dlstm.yaml"
    path.write_text(yaml.safe_dump(_small_dlstm_config()))
    jm = JaxCondRealNVP.from_config(jax_load_config(str(path), verify=False))
    tm = CondRealNVP.from_config(load_config(str(path), verify=False))
    jp = _np_tree(jm.init(jax.random.key(8)))
    rng = np.random.default_rng(9)
    jp["blocks"]["actnorm"]["scale"] = (1.0 + 0.2 * rng.normal(size=(2, SIZE))).astype(np.float32)
    return jm, tm, jp, rng


def test_small_dlstm_log_prob_and_inverse_match_jax(dlstm):
    jm, tm, jp, rng = dlstm
    assert tm.size == SIZE and tm.nested_sizes == [16, 16] and type(tm.features.feature_networks[1]) is DualDomainLSTM
    assert count_params(tm.init(torch.Generator().manual_seed(0), device="cpu")) == sum(
        int(a.size) for a in jax.tree.leaves(jp))
    traj = rng.normal(size=(N_TRAJ, T_STEPS, 3)).astype(np.float32)
    y = rng.normal(size=(N_TRAJ, SIZE)).astype(np.float32)
    jpj, tp = jax.tree.map(jnp.asarray, jp), params_from_numpy(jp, "cpu")
    ref = jm.log_prob(jpj, jnp.asarray(y), jnp.asarray(traj))
    ours = tm.log_prob(tp, torch.from_numpy(y), torch.from_numpy(traj))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    z = rng.normal(size=(N_TRAJ, SIZE)).astype(np.float32)
    y_ref = jm.inverse(jpj, jnp.asarray(z), jnp.asarray(traj))
    y_ours = tm.inverse(tp, torch.from_numpy(z), torch.from_numpy(traj))
    np.testing.assert_allclose(y_ours.numpy(), np.asarray(y_ref), atol=1e-4, rtol=0)


def test_small_dlstm_trainer_val_loss_matches_jax(tmp_path):
    """Three epochs, the whole train split as one batch, dropout off on both
    sides (the two frameworks draw different masks)."""
    path = tmp_path / "small_dlstm.yaml"
    cfg = _small_dlstm_config(dropout=0.0)
    cfg["optimizer"]["kwargs"]["lr"] = 2e-3
    cfg["training"].update(validation_split=0.25, batch_size=24, n_epochs=3, timeout=None, val_loss_window_size=2,
                           random_state=3)
    path.write_text(yaml.safe_dump(cfg))
    jm = JaxCondRealNVP.from_config(jax_load_config(str(path), verify=False))
    tm = CondRealNVP.from_config(load_config(str(path), verify=False))
    jp = _np_tree(jm.init(jax.random.key(10)))
    rng = np.random.default_rng(11)
    y = rng.normal(size=(32, SIZE)).astype(np.float32)
    traj = rng.normal(size=(32, T_STEPS, 3)).astype(np.float32)
    ref = JaxTrainer(cfg, data=(y, [traj]))
    ref.train(jm, jax.tree.map(jnp.asarray, jp))
    ours = Trainer(cfg, data=(y, [traj]), device="cpu")
    ours.train(tm, params_from_numpy(jp, "cpu"))
    h_ref, h = ref.meta_scheduler.parameter_history, ours.meta_scheduler.parameter_history
    assert [e for e, _ in h["val_loss"]] == [e for e, _ in h_ref["val_loss"]] == [1, 2, 3]
    for key in ("val_loss", "train_loss"):
        np.testing.assert_allclose([v for _, v in h[key]], [v for _, v in h_ref[key]], rtol=1e-3, atol=1e-4,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# every run config the port's registry serves, at its published widths
# ---------------------------------------------------------------------------

RUN_CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(os.path.join(ROOT, "configs/runs/**/*.yaml"),
                                                                 recursive=True))


def _shape_only_uniform(generator, shape, bound):
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("rel", RUN_CONFIGS)
def test_run_config_builds_with_the_jax_parameter_count(rel, monkeypatch):
    """The port builds the config and its parameter tree has the JAX
    package's leaf shapes (drawn as shapes only, so the full widths cost no
    memory here)."""
    path = os.path.join(ROOT, rel)
    jm = JaxCondRealNVP.from_config(jax_load_config(path, verify=False))
    ref = jax.eval_shape(jm.init, jax.random.key(0))
    for mod in (nn, lstm, cnn):
        monkeypatch.setattr(mod, "uniform", _shape_only_uniform)
    tm = CondRealNVP.from_config(load_config(path, verify=False))
    params = tm.init(torch.Generator().manual_seed(0), device="meta")
    assert count_params(params) == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(ref))
    assert sorted(tuple(t.shape) for t in tree_leaves(params)) == sorted(tuple(a.shape) for a in jax.tree.leaves(ref))


def test_registry_serves_the_jax_names_it_has_ported():
    from bcnf_tpu.factories import FeatureNetworkFactory as JaxFactory

    assert set(FeatureNetworkFactory.REGISTRY) == set(JaxFactory.REGISTRY)
    with pytest.raises(NotImplementedError, match="not implemented"):
        FeatureNetworkFactory.get_feature_network("GRU", {})
    refused = []
    for rel in RUN_CONFIGS:
        try:
            CondRealNVP.from_config(load_config(os.path.join(ROOT, rel), verify=False))
        except NotImplementedError:
            refused.append(rel)
    assert (len(RUN_CONFIGS), len(RUN_CONFIGS) - len(refused), len(refused)) == (99, 99, 0)
    assert {"configs/runs/nll/t_PTRF_large.yaml", "configs/runs/videos_CNN_LSTM_large.yaml"} <= set(RUN_CONFIGS)


# ---------------------------------------------------------------------------
# one model of each new family from its run config, on bridged JAX weights
# ---------------------------------------------------------------------------

ZOO = {  # config -> whether its flow is cut to 3 blocks of [8, 8]
    "configs/runs/nll/t_PTRF_xsmall.yaml": False,
    "configs/runs/hybrid/t_DPTRF_xsmall_hybrid.yaml": False,
    "configs/runs/hybrid/t_DFC_xsmall_hybrid.yaml": False,
    "configs/runs/trajectory_LSTM_noisy_calib7.yaml": False,
    "configs/runs/dev/trajectory_SFrExp_LSTM_SiGLU_2_large.yaml": True,
    "configs/runs/dev/trajectory_SFrExp_TRF_2_deep.yaml": True,
    "configs/runs/dev/trajectory_LSTM_FFT_large_small_cond.yaml": True,
}


@pytest.mark.parametrize("rel", sorted(ZOO), ids=lambda r: os.path.basename(r)[:-5])
def test_zoo_model_bridges_and_matches_jax(rel, tmp_path):
    """The bridge is a plain copy each way on the new trees (attention
    ``attn.{q,k,v,out}``, ``norm1/2``, ``ff1/2``, ``embed``, ``out``, the
    dual-domain ``{time, freq, fc}``, AnyGLU's ``{gate, value}``, a
    coupling's ``b``); the port's log_prob, inverse and hybrid head on the
    bridged weights match JAX's at 1e-4."""
    from bcnf_tpu_torch.bridge import params_to_numpy

    with open(os.path.join(ROOT, rel)) as f:
        cfg = yaml.safe_load(f)
    if ZOO[rel]:
        cfg["model"]["kwargs"].update(nested_sizes=[8, 8], n_blocks=3)
    path = tmp_path / "run.yaml"
    path.write_text(yaml.safe_dump(cfg))
    jm = JaxCondRealNVP.from_config(jax_load_config(str(path), verify=False))
    tm = CondRealNVP.from_config(load_config(str(path), verify=False))
    jp = _np_tree(jm.init(jax.random.key(12)))
    tp = params_from_numpy(jp, "cpu")
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    rng = np.random.default_rng(13)
    T = int(round(cfg["data"]["T"] / cfg["data"]["dt"]))
    traj = rng.normal(size=(5, T, 3)).astype(np.float32)
    y = rng.normal(size=(5, tm.size)).astype(np.float32)
    z = rng.normal(size=(5, tm.size)).astype(np.float32)
    jpj = jax.tree.map(jnp.asarray, jp)
    np.testing.assert_allclose(tm.log_prob(tp, torch.from_numpy(y), torch.from_numpy(traj)).numpy(),
                               np.asarray(jm.log_prob(jpj, jnp.asarray(y), jnp.asarray(traj))), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tm.inverse(tp, torch.from_numpy(z), torch.from_numpy(traj)).numpy(),
                               np.asarray(jm.inverse(jpj, jnp.asarray(z), jnp.asarray(traj))), atol=1e-4, rtol=0)
    if tm.hybrid:
        h_ref = jm.encode(jpj, (jnp.asarray(traj),))
        np.testing.assert_allclose(tm.predict_head(tp, tm.encode(tp, (torch.from_numpy(traj),))).numpy(),
                                   np.asarray(jm.predict_head(jpj, h_ref)), atol=1e-4, rtol=0)
