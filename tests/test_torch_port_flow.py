"""Port parity, flow level: the plain version of the whole-flow kernel and the
port's CondRealNVP against the JAX package (the Pallas kernel in interpret
mode, and the XLA path: conftest's 8 CPU devices keep the JAX gate closed).
Tolerances are those of tests/test_flow_kernel.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcnf_tpu.models import CondRealNVP as JaxCondRealNVP
from bcnf_tpu.models import ConcatenateCondition as JaxConcat
from bcnf_tpu.models import FeatureNetworkStack as JaxStack
from bcnf_tpu.models import FullyConnectedFeatureNetwork as JaxFC
from bcnf_tpu.models import LSTMFeatureNetwork as JaxLSTMNet
from bcnf_tpu.models.cnf import orthonormal_init as jax_orthonormal_init
from bcnf_tpu.ops.flow_kernel import fused_flow as jax_fused_flow
from bcnf_tpu_torch.bridge import map_tree, params_from_numpy
from bcnf_tpu_torch.models import (
    CondRealNVP,
    ConcatenateCondition,
    FeatureNetworkStack,
    LSTMFeatureNetwork,
    orthonormal_init,
)
from bcnf_tpu_torch.ops.flow_kernel import fused_flow, fused_flow_reference

SIZE, N_COND_FEATURES, NESTED = 7, 16, [24, 24, 24]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


# ---------------------------------------------------------------------------
# module level: fused_flow_reference vs the Pallas kernel on the same stacked args
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stacked():
    stack = JaxStack([JaxConcat(input_size=None, output_size=6), JaxFC(sizes=[6, 32, N_COND_FEATURES])])
    model = JaxCondRealNVP(size=SIZE, nested_sizes=NESTED, n_blocks=4, n_conditions=N_COND_FEATURES,
                           feature_network_stack=stack, act_norm=True, random_state=0)
    params = model.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    blocks = dict(params["blocks"])
    blocks["actnorm"] = {  # off identity, so ActNorm is exercised
        "scale": jnp.asarray(1.0 + 0.2 * rng.normal(size=(3, SIZE)).astype(np.float32)),
        "bias": jnp.asarray(0.2 * rng.normal(size=(3, SIZE)).astype(np.float32)),
    }
    params = dict(params, blocks=blocks)
    N = 8
    h = model.encode(params, (jnp.asarray(rng.normal(size=(N, 6)).astype(np.float32)),))
    kargs, h_proj = model._fused_flow_args(params, h)
    return model, params, h, kargs, h_proj, N, rng


@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
@pytest.mark.parametrize("tiling", ["block_b>N", "block_b<N"])
def test_reference_matches_pallas_interpret(stacked, inverse, tiling):
    model, params, h, kargs, h_proj, N, rng = stacked
    B = 16 * N
    block_b = 2 * N if tiling == "block_b>N" else N // 2
    x = rng.normal(size=(B, SIZE)).astype(np.float32)
    ref = jax_fused_flow(jnp.asarray(x), h_proj, **kargs, inverse=inverse, n_cond=N, block_b=block_b,
                         precision="highest", interpret=True)
    ours = fused_flow(_t(x), _t(h_proj), **{k: _t(v) for k, v in kargs.items()}, inverse=inverse, n_cond=N)
    if inverse:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    else:
        np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref[0]), atol=1e-4, rtol=0)
        np.testing.assert_allclose(ours[1].numpy(), np.asarray(ref[1]), atol=1e-4, rtol=0)


def test_reference_ragged_rows_match_xla_inverse(stacked):
    """B = 7N + 3 rows (no tile rule on the port's side): row r against JAX's
    XLA inverse_given_h on the gathered condition h[r % N]."""
    model, params, h, kargs, h_proj, N, rng = stacked
    B = 7 * N + 3
    z = rng.normal(size=(B, SIZE)).astype(np.float32)
    ours = fused_flow_reference(_t(z), _t(h_proj), **{k: _t(v) for k, v in kargs.items()},
                                inverse=True, n_cond=N)
    h_rows = jnp.asarray(np.asarray(h)[np.arange(B) % N])
    ref = model.inverse_given_h(params, jnp.asarray(z), h_rows)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# model level: the port's CondRealNVP on bridged params vs JAX's XLA path
# ---------------------------------------------------------------------------


def _stacks():
    kw = dict(input_size=3, hidden_size=8, output_size=N_COND_FEATURES, num_layers=2, bidirectional=True)
    return (JaxStack([JaxConcat(input_size=None, output_size=3), JaxLSTMNet(**kw)]),
            FeatureNetworkStack([ConcatenateCondition(input_size=None, output_size=3), LSTMFeatureNetwork(**kw)]))


@pytest.fixture(scope="module")
def models():
    jax_stack, stack = _stacks()
    kw = dict(size=SIZE, nested_sizes=NESTED, n_blocks=4, n_conditions=N_COND_FEATURES, act_norm=True,
              random_state=0)
    jm = JaxCondRealNVP(feature_network_stack=jax_stack, **kw)
    tm = CondRealNVP(feature_network_stack=stack, **kw)
    rng = np.random.default_rng(1)
    jp = _np_tree(jm.init(jax.random.key(1)))
    jp["blocks"]["actnorm"] = {
        "scale": (1.0 + 0.2 * rng.normal(size=(3, SIZE))).astype(np.float32),
        "bias": (0.2 * rng.normal(size=(3, SIZE))).astype(np.float32),
    }
    traj = rng.normal(size=(6, 30, 3)).astype(np.float32)
    return jm, jax.tree.map(jnp.asarray, jp), tm, params_from_numpy(jp, "cpu"), traj, rng


def test_model_forward_matches_jax(models):
    jm, jp, tm, tp, traj, rng = models
    y = rng.normal(size=(6, SIZE)).astype(np.float32)
    z_ref, ld_ref = jm.forward(jp, jnp.asarray(y), jnp.asarray(traj))
    z, ld = tm.forward(tp, _t(y), _t(traj))
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=1e-4, rtol=0)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref), atol=1e-4, rtol=0)


def test_model_inverse_given_h_matches_jax(models):
    jm, jp, tm, tp, traj, rng = models
    z = rng.normal(size=(5, 6, SIZE)).astype(np.float32)  # (draws, N, size) broadcast over h
    y_ref = jm.inverse_given_h(jp, jnp.asarray(z), jm.encode(jp, (jnp.asarray(traj),)))
    y = tm.inverse_given_h(tp, _t(z), tm.encode(tp, (_t(traj),)))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tm.inverse(tp, _t(z[0]), _t(traj)).numpy(), y[0].numpy(), atol=1e-6, rtol=0)


def test_model_roundtrip(models):
    jm, jp, tm, tp, traj, rng = models
    y = _t(rng.normal(size=(6, SIZE)).astype(np.float32))
    z, _ = tm.forward(tp, y, _t(traj))
    np.testing.assert_allclose(tm.inverse(tp, z, _t(traj)).numpy(), y.numpy(), atol=5e-4, rtol=0)


def test_log_prob_matches_jax(models):
    jm, jp, tm, tp, traj, rng = models
    y = rng.normal(size=(6, SIZE)).astype(np.float32)
    ref = jm.log_prob(jp, jnp.asarray(y), jnp.asarray(traj))
    np.testing.assert_allclose(tm.log_prob(tp, _t(y), _t(traj)).numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_model_plain_path_matches_its_kernel_reference(models):
    """The composition (autograd path) and the stacked kernel reference are
    the same function."""
    jm, jp, tm, tp, traj, rng = models
    h = tm.encode(tp, (_t(traj),))
    kargs, h_proj = tm._fused_flow_args(tp, h)
    z = _t(rng.normal(size=(4, 6, SIZE)).astype(np.float32))
    ref = fused_flow_reference(z.reshape(-1, SIZE), h_proj, **kargs, inverse=True, n_cond=6).reshape(z.shape)
    np.testing.assert_allclose(tm.inverse_given_h(tp, z, h).numpy(), ref.numpy(), atol=1e-5, rtol=0)


def test_port_init_gives_the_jax_tree(models):
    jm, jp, tm, tp, traj, rng = models
    ours = tm.init(torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), _np_tree(jp))
    assert map_tree(lambda t: tuple(t.shape), ours) == shapes
    np.testing.assert_array_equal(ours["blocks"]["ortho"].numpy(), np.asarray(jp["blocks"]["ortho"]))


@pytest.mark.parametrize("seed,size", [(0, 7), ([20240325, 3], 19), ([5, 0], 2)])
def test_orthonormal_init_bit_identical(seed, size):
    ours = orthonormal_init(seed, size).numpy()
    ref = np.asarray(jax_orthonormal_init(seed, size))
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


def test_kernel_gate():
    _, stack = _stacks()
    kw = dict(size=SIZE, n_blocks=4, n_conditions=N_COND_FEATURES, feature_network_stack=stack)
    x = torch.zeros(2, SIZE)
    assert not CondRealNVP(nested_sizes=NESTED, **kw)._use_fused(False, x)  # a CPU tensor
    assert not CondRealNVP(nested_sizes=[24, 32], **kw)._use_fused(False, x)
    assert not CondRealNVP(nested_sizes=NESTED, activation="ReLU", **kw).coupling.fusable
    assert CondRealNVP(nested_sizes=NESTED, hybrid=True, **kw).hybrid  # the hybrid head is ported
    for bad in (dict(two_way=True), dict(coupling="rqs"), dict(precision="default")):
        with pytest.raises(NotImplementedError):
            CondRealNVP(nested_sizes=NESTED, **{**kw, **bad})
