"""Port parity, op level: bcnf_tpu_torch ops against the bcnf_tpu (JAX) ops on
the same numpy inputs and weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcnf_tpu.config import ParameterIndexMapping as JaxPIM
from bcnf_tpu.config import load_config as jax_load_config
from bcnf_tpu.models.feature_network import (
    ConcatenateCondition as JaxConcat,
    FeatureNetworkStack as JaxStack,
    LSTMFeatureNetwork as JaxLSTMNet,
)
from bcnf_tpu.ops import lstm as jax_lstm
from bcnf_tpu.ops import nn as jax_nn
from bcnf_tpu.utils.misc import inn_nll_loss as jax_nll
from bcnf_tpu_torch.bridge import params_from_numpy
from bcnf_tpu_torch.config import ParameterIndexMapping, load_config
from bcnf_tpu_torch.models.feature_network import (
    ConcatenateCondition,
    FeatureNetworkStack,
    LSTMFeatureNetwork,
)
from bcnf_tpu_torch.ops import lstm, nn
from bcnf_tpu_torch.utils.misc import inn_nll_loss


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.mark.parametrize("name", sorted(jax_nn.ACTIVATIONS))
def test_activation_table_matches_jax(name):
    x = np.linspace(-6.0, 6.0, 1001, dtype=np.float32)
    ours = nn.get_activation(name)(_t(x)).numpy()
    ref = np.asarray(jax_nn.get_activation(name)(jnp.asarray(x)))
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)


def test_gelu_is_tanh_form():
    x = np.linspace(-3.0, 3.0, 601, dtype=np.float32)
    np.testing.assert_allclose(nn.gelu(_t(x)).numpy(), np.asarray(jax.nn.gelu(jnp.asarray(x))), atol=1e-6, rtol=0)
    # torch's default (erf) GELU is measurably different: the port must not use it
    assert torch.abs(torch.nn.functional.gelu(_t(x)) - nn.gelu(_t(x))).max() > 1e-4


def test_linear_matches_jax():
    rng = np.random.default_rng(0)
    p = {"w": rng.normal(size=(7, 5)).astype(np.float32), "b": rng.normal(size=5).astype(np.float32)}
    x = rng.normal(size=(4, 3, 7)).astype(np.float32)
    ref = np.asarray(jax_nn.linear_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    ours = nn.linear_apply(params_from_numpy(p, "cpu"), _t(x)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)


def test_linear_init_is_torch_default():
    p = nn.linear_init(torch.Generator().manual_seed(0), 64, 10)
    assert p["w"].shape == (64, 10) and p["b"].shape == (10,)
    assert p["w"].abs().max() <= 1 / 8 and p["w"].abs().max() > 0.1
    assert p["w"].dtype == torch.float32


@pytest.mark.parametrize("reduction", ["mean", "none"])
def test_inn_nll_loss_matches_jax(reduction):
    rng = np.random.default_rng(1)
    z = rng.normal(size=(6, 19)).astype(np.float32)
    ld = rng.normal(size=6).astype(np.float32)
    ref = np.asarray(jax_nll(jnp.asarray(z), jnp.asarray(ld), reduction=reduction))
    ours = inn_nll_loss(_t(z), _t(ld), reduction=reduction).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)


def test_dropout_is_identity_at_eval_and_scales_in_training():
    x = torch.ones(1000)
    g = torch.Generator().manual_seed(0)
    assert torch.equal(nn.dropout(g, x, 0.5, train=False), x)
    y = nn.dropout(g, x, 0.5, train=True)
    assert set(y.unique().tolist()) <= {0.0, 2.0} and 300 < int((y == 0).sum()) < 700


def test_unported_layer_families_raise():
    for name in ("AnyGLU", "LinearFFTEnriched"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            nn.get_dense_layer(name)


@pytest.mark.parametrize("bidirectional,num_layers", [(True, 2), (False, 1)])
def test_lstm_apply_matches_jax(bidirectional, num_layers):
    params = _np_tree(jax_lstm.lstm_init(jax.random.key(3), 3, 8, num_layers, bidirectional))
    x = np.random.default_rng(2).normal(size=(5, 12, 3)).astype(np.float32)
    ref = np.asarray(jax_lstm.lstm_apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x), 8))
    ours = lstm.lstm_apply(params_from_numpy(params, "cpu"), _t(x), 8).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


def test_lstm_init_layout_matches_jax():
    ours = lstm.lstm_init(torch.Generator().manual_seed(0), 3, 8, 2, True)
    ref = _np_tree(jax_lstm.lstm_init(jax.random.key(0), 3, 8, 2, True))
    for li in range(2):
        for d in ("fwd", "bwd"):
            for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
                assert tuple(ours["layers"][li][d][k].shape) == ref["layers"][li][d][k].shape


@pytest.mark.parametrize("pooling", ["mean", "max"])
def test_lstm_feature_network_and_stack_match_jax(pooling):
    kw = dict(input_size=3, hidden_size=8, output_size=16, num_layers=2, bidirectional=True, pooling=pooling)
    jax_stack = JaxStack([JaxConcat(input_size=None, output_size=3), JaxLSTMNet(**kw)])
    stack = FeatureNetworkStack([ConcatenateCondition(input_size=None, output_size=3), LSTMFeatureNetwork(**kw)])
    params = _np_tree(jax_stack.init(jax.random.key(4)))
    x = np.random.default_rng(5).normal(size=(6, 30, 3)).astype(np.float32)
    ref = np.asarray(jax_stack.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    ours = stack.apply(params_from_numpy(params, "cpu"), _t(x)).numpy()
    assert ours.shape == (6, 16)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)
    # the network alone
    net_ref = np.asarray(JaxLSTMNet(**kw).apply(jax.tree.map(jnp.asarray, params["nets"][1]), jnp.asarray(x)))
    net = LSTMFeatureNetwork(**kw).apply(params_from_numpy(params["nets"][1], "cpu"), _t(x)).numpy()
    np.testing.assert_allclose(net, net_ref, atol=1e-5, rtol=0)


def test_config_copy_matches_jax_loader():
    path = "{{BCNF_ROOT}}/configs/runs/trajectory_LSTM_large.yaml"
    assert load_config(path).to_dict() == jax_load_config(path).to_dict()
    names = list(load_config(path)["global"]["parameter_selection"])
    data = {n: np.arange(3.0) + i for i, n in enumerate(names) if n != "g"}
    data["g_z"] = np.full(3, -9.81)  # the alias table resolves g <-> g_z
    np.testing.assert_array_equal(ParameterIndexMapping(names).vectorize(data), JaxPIM(names).vectorize(data))
