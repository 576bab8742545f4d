"""Port parity, attention and the attention-based conditioners:
`bcnf_tpu_torch/ops/attention.py` (multi-head attention, the post-norm block,
the positional embeddings), `Transformer`, `DualDomainTransformer` and
`DualDomainFC` against the JAX package on bridged weights, dropout off.
Tolerance 1e-5, the conditioners' bar (tests/test_torch_port_conditioners.py).
Widths that the head count does not divide (46 with 4 heads, 70 with 8: the
published t_PTRF_small and t_DPTRF_medium) are among the cases."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcnf_tpu.models.feature_network import DualDomainFC as JaxDualDomainFC
from bcnf_tpu.models.feature_network import DualDomainTransformer as JaxDualDomainTransformer
from bcnf_tpu.models.feature_network import Transformer as JaxTransformer
from bcnf_tpu.ops import attention as jax_attention
from bcnf_tpu_torch.bridge import map_tree, params_from_numpy
from bcnf_tpu_torch.models import DualDomainFC, DualDomainTransformer, Transformer
from bcnf_tpu_torch.ops import attention

TOL = 1e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _x(shape, seed) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(a.shape), tree)


@pytest.mark.parametrize("d_model,n_heads", [(16, 4), (46, 4), (70, 8), (12, 1)])
def test_mha_matches_jax(d_model, n_heads):
    params = _np_tree(jax_attention.mha_init(jax.random.key(0), d_model, n_heads))
    ours_init = attention.mha_init(torch.Generator().manual_seed(0), d_model, n_heads)
    assert _shapes(params) == map_tree(lambda t: tuple(t.shape), ours_init)
    assert params["q"]["w"].shape == (d_model, n_heads * (d_model // n_heads))
    x = _x((3, 9, d_model), 1)
    ref = np.asarray(jax_attention.mha_apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x), n_heads))
    ours = attention.mha_apply(params_from_numpy(params, "cpu"), torch.from_numpy(x), n_heads)
    np.testing.assert_allclose(ours.numpy(), ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("d_model,n_heads", [(16, 4), (46, 4)])
def test_transformer_block_matches_jax(d_model, n_heads):
    params = _np_tree(jax_attention.transformer_block_init(jax.random.key(2), d_model, 24, n_heads))
    assert _shapes(params) == map_tree(lambda t: tuple(t.shape), attention.transformer_block_init(
        torch.Generator().manual_seed(0), d_model, 24, n_heads))
    params["norm1"]["scale"] = 1.0 + 0.1 * _x((d_model,), 3)
    params["norm2"]["bias"] = 0.1 * _x((d_model,), 4)
    x = _x((4, 10, d_model), 5)
    ref = np.asarray(jax_attention.transformer_block_apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                                                           n_heads, 0.1))
    ours = attention.transformer_block_apply(params_from_numpy(params, "cpu"), torch.from_numpy(x), n_heads, 0.1)
    np.testing.assert_allclose(ours.numpy(), ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("seq_len,dim", [(30, 256), (16, 46), (60, 7)])
def test_positional_embeddings_match_jax(seq_len, dim):
    ref = np.asarray(jax_attention.sinusoidal_positional_embeddings(seq_len, dim))
    ours = attention.sinusoidal_positional_embeddings(seq_len, dim)
    assert ours.shape == (seq_len, dim) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, atol=TOL, rtol=0)
    # the JAX formula, not the textbook one: column 1 is cos(pos / 10000^(2/dim))
    pos = np.arange(seq_len)
    np.testing.assert_allclose(ours[:, 1].numpy(), np.cos(pos / 10000 ** (2 / dim)), atol=TOL, rtol=0)


@pytest.mark.parametrize("trf_size,n_heads,pe", [(32, 4, True), (46, 4, True), (24, 2, False)],
                         ids=["d32-pe", "d46-pe", "d24"])
def test_transformer_matches_jax(trf_size, n_heads, pe):
    kw = dict(input_size=3, trf_size=trf_size, n_heads=n_heads, ff_size=20, n_blocks=2, output_size=12,
              add_positional_embeddings=pe)
    jn, tn = JaxTransformer(**kw), Transformer(**kw)
    params = _np_tree(jn.init(jax.random.key(6)))
    assert _shapes(params) == map_tree(lambda t: tuple(t.shape), tn.init(torch.Generator().manual_seed(0)))
    x = _x((5, 30, 3), 7)
    ref = np.asarray(jn.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    ours = tn.apply(params_from_numpy(params, "cpu"), torch.from_numpy(x))
    assert ours.shape == (5, 12)
    np.testing.assert_allclose(ours.numpy(), ref, atol=TOL, rtol=0)


def test_transformer_dropout_draws_from_the_generator():
    tn = Transformer(input_size=3, trf_size=16, n_heads=2, ff_size=16, n_blocks=1, output_size=8, dropout=0.5)
    params = tn.init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x((4, 10, 3), 8))
    a = tn.apply(params, x, torch.Generator().manual_seed(1), train=True)
    b = tn.apply(params, x, torch.Generator().manual_seed(1), train=True)
    assert torch.equal(a, b) and not torch.allclose(a, tn.apply(params, x))


@pytest.mark.parametrize("trf_size,n_heads", [(24, 4), (70, 8)])
def test_dual_domain_transformer_matches_jax(trf_size, n_heads):
    kw = dict(input_size=3, trf_size=trf_size, n_heads=n_heads, ff_size=16, n_blocks=2, fc_sizes=[20, 10],
              add_positional_embeddings=True)
    jn, tn = JaxDualDomainTransformer(**kw), DualDomainTransformer(**kw)
    params = _np_tree(jn.init(jax.random.key(9)))
    assert sorted(params) == ["fc", "freq", "time"]
    assert _shapes(params) == map_tree(lambda t: tuple(t.shape), tn.init(torch.Generator().manual_seed(0)))
    assert params["freq"]["embed"]["w"].shape == (6, trf_size)  # T//2+1 tokens of width 2C
    x = _x((4, 30, 3), 10)
    ref = np.asarray(jn.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    ours = tn.apply(params_from_numpy(params, "cpu"), torch.from_numpy(x))
    assert ours.shape == (4, 10) and tn.output_size == 10
    np.testing.assert_allclose(ours.numpy(), ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("sizes", [[32, 24], [40]])
def test_dual_domain_fc_matches_jax(sizes):
    kw = dict(input_size=60, sizes=sizes, fc_sizes=[16, 8])
    jn, tn = JaxDualDomainFC(**kw), DualDomainFC(**kw)
    params = _np_tree(jn.init(jax.random.key(11)))
    assert _shapes(params) == map_tree(lambda t: tuple(t.shape), tn.init(torch.Generator().manual_seed(0)))
    # the full FFT of the flattened input (2 * input_size features) and a fusion MLP of 2 * sizes[-1]
    assert params["freq"]["layers"][0]["w"].shape[0] == 120 and params["fc"]["layers"][0]["w"].shape[0] == 2 * sizes[-1]
    x = _x((5, 20, 3), 12)
    ref = np.asarray(jn.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    ours = tn.apply(params_from_numpy(params, "cpu"), torch.from_numpy(x))
    assert ours.shape == (5, 8)
    np.testing.assert_allclose(ours.numpy(), ref, atol=TOL, rtol=0)
