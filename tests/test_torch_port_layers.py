"""Port parity, layers: the dense-layer families, FFT features and LayerNorm
of `bcnf_tpu_torch/ops/nn.py`, the named layers of
`bcnf_tpu_torch/models/layers.py`, and `FrExpFeatureNetwork`, each against
the JAX package on the same numpy inputs and bridged weights. Tolerances:
1e-6 for the layers (tests/test_layers.py's bar), 1e-5 for FrExp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcnf_tpu.models import layers as jax_layers
from bcnf_tpu.models.feature_network import FrExpFeatureNetwork as JaxFrExp
from bcnf_tpu.ops import nn as jax_nn
from bcnf_tpu_torch.bridge import params_from_numpy
from bcnf_tpu_torch.factories import FeatureNetworkFactory
from bcnf_tpu_torch.models import layers
from bcnf_tpu_torch.models.feature_network import FrExpFeatureNetwork
from bcnf_tpu_torch.ops import nn

LAYER_TOL = 1e-6


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _x(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("width", [9, 10])
@pytest.mark.parametrize("fn", ["fft_features", "fft_enrich"])
def test_fft_features_match_jax(fn, width):
    x = _x((4, 3, width), 1)
    ours = getattr(nn, fn)(torch.from_numpy(x))
    ref = np.asarray(getattr(jax_nn, fn)(jnp.asarray(x)))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, atol=LAYER_TOL, rtol=0)


@pytest.mark.parametrize("layer,kwargs", [
    ("Linear", None),
    ("AnyGLU", {"activation": "Sigmoid"}),
    ("AnyGLU", None),  # GELU gate, the family's default
    ("LinearFFTEnriched", None),
], ids=["Linear", "AnyGLU-sigmoid", "AnyGLU-gelu", "LinearFFTEnriched"])
def test_dense_families_match_jax(layer, kwargs):
    jf, tf = jax_nn.get_dense_layer(layer, kwargs), nn.get_dense_layer(layer, kwargs)
    params = _np_tree(jf.init(jax.random.key(2), 11, 7))
    ours_init = tf.init(torch.Generator().manual_seed(0), 11, 7)
    assert jax.tree.map(np.shape, params) == jax.tree.map(lambda t: tuple(t.shape), ours_init)
    x = _x((5, 11), 3)
    ref = np.asarray(jf.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    ours = tf.apply(params_from_numpy(params, "cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), ref, atol=LAYER_TOL, rtol=0)
    if layer == "AnyGLU":
        g = _x((6,), 4)
        np.testing.assert_allclose(tf.glu_act(torch.from_numpy(g)).numpy(), np.asarray(jf.glu_act(jnp.asarray(g))),
                                   atol=LAYER_TOL, rtol=0)


def test_layer_norm_matches_jax():
    x = 3.0 + 2.0 * _x((4, 5, 12), 5)
    params = {"scale": 1.0 + 0.1 * _x((12,), 6), "bias": 0.1 * _x((12,), 7)}
    ref = np.asarray(jax_nn.layer_norm_apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    ours = nn.layer_norm_apply(params_from_numpy(params, "cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), ref, atol=LAYER_TOL, rtol=0)
    assert {k: tuple(v.shape) for k, v in nn.layer_norm_init(12).items()} == {
        k: tuple(v.shape) for k, v in jax_nn.layer_norm_init(12).items()}


@pytest.mark.parametrize("name,kwargs", [
    ("AnyGLU", dict(input_size=6, output_size=5, activation="Sigmoid")),
    ("FFTLayer", dict(input_size=10)),
    ("FFTEnrichLayer", dict(input_size=9)),
    ("LinearFFTEnriched", dict(input_size=10, output_size=7)),
])
def test_named_layers_match_jax(name, kwargs):
    jl = getattr(jax_layers, name)(**kwargs)
    tl = FeatureNetworkFactory.get_feature_network(name, kwargs)
    assert type(tl) is getattr(layers, name)
    assert (tl.input_size, tl.output_size) == (jl.input_size, jl.output_size)
    params = _np_tree(jl.init(jax.random.key(8)))
    x = _x((3, kwargs["input_size"]), 9)
    ref = np.asarray(jl.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    ours = tl.apply(params_from_numpy(params, "cpu"), torch.from_numpy(x))
    assert ours.shape == ref.shape and ours.shape[-1] == tl.output_size
    np.testing.assert_allclose(ours.numpy(), ref, atol=LAYER_TOL, rtol=0)


# ---------------------------------------------------------------------------
# FrExp: normal values and zeros agree with JAX; subnormals differ by design
# ---------------------------------------------------------------------------

def _normal_values() -> np.ndarray:
    x = _x((6, 30, 3), 10) * np.float32(10.0) ** np.random.default_rng(11).integers(-20, 20, size=(6, 30, 3))
    x[0, :4] = [[0.0, -0.0, 1.0], [-1.0, 0.5, -2.0], [1e-30, -3e-37, 2e37], [np.inf, -np.inf, 7.25]]
    return x.astype(np.float32)


@pytest.mark.parametrize("separate_sign", [True, False], ids=["signed", "unsigned"])
def test_frexp_matches_jax(separate_sign):
    x = _normal_values()
    jn, tn = JaxFrExp(input_size=3, separate_sign=separate_sign), FrExpFeatureNetwork(3, separate_sign)
    assert tn.output_size == jn.output_size == 3 * (2 + int(separate_sign))
    ref = np.asarray(jn.apply({}, jnp.asarray(x)))
    ours = tn.apply({}, torch.from_numpy(x))
    assert ours.shape == ref.shape == (6, 30, tn.output_size) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=0)


def test_frexp_carries_no_gradient():
    x = torch.from_numpy(_normal_values()[1:]).requires_grad_(True)
    assert not FrExpFeatureNetwork(3, separate_sign=True).apply({}, x).requires_grad


def test_frexp_subnormals_differ_from_jax_by_design():
    """`jnp.frexp` on the CPU flushes a subnormal float32 to the smallest
    normal's exponent, `torch.frexp` gives its IEEE decomposition; the port
    keeps torch's (ROADMAP.md, differences by design). Both shown here."""
    x = np.array([[1e-40, -3e-39, 1.0e-45]], np.float32)
    jm, je = (np.asarray(a) for a in jnp.frexp(jnp.asarray(x)))
    tm, te = (t.numpy() for t in torch.frexp(torch.from_numpy(x)))
    np.testing.assert_array_equal(jm, [[0.5, -0.5, 0.5]])
    np.testing.assert_array_equal(je, [[-149, -149, -149]])
    np.testing.assert_array_equal(te, [[-132, -127, -148]])
    np.testing.assert_allclose(tm * np.exp2(te.astype(np.float64)), x, rtol=0, atol=0)  # exact in torch
    ours = FrExpFeatureNetwork(3).apply({}, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(ours, np.concatenate([tm, te.astype(np.float32)], axis=-1))
