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
    # two-way, RQS and the other layer families build, and every kernel gate closes on them
    for other in (dict(two_way=True), dict(coupling="rqs"), dict(layer="AnyGLU"), dict(layer="LinearFFTEnriched")):
        m = CondRealNVP(nested_sizes=NESTED, **{**kw, **other})
        assert not m.coupling.fusable and not m._use_fused_train(False, x)
    # the precision table: the reduced strings open the gates in one TF32 pass, X6 closes them, others raise
    assert CondRealNVP(nested_sizes=NESTED, **{**kw, "precision": "default"}).kernel_mode == "tf32"
    x6 = CondRealNVP(nested_sizes=NESTED, **{**kw, "precision": "BF16_BF16_F32_X6"})
    assert x6.kernel_mode is None and x6.train_kernel_mode is None
    with pytest.raises(ValueError, match="BF16_BF16_F32_X6"):
        CondRealNVP(nested_sizes=NESTED, **{**kw, "precision": "tensorfloat32"})


# ---------------------------------------------------------------------------
# the other couplings: two-way affine (Linear, AnyGLU, LinearFFTEnriched) and
# RQS (one-way, two-way), layer by layer and as whole flows
# ---------------------------------------------------------------------------

COUPLINGS = {
    "affine-two-way": dict(two_way=True),
    "affine-two-way-anyglu": dict(two_way=True, layer="AnyGLU", layer_kwargs={"activation": "Sigmoid"},
                                  activation="Identity"),
    "affine-two-way-fft": dict(two_way=True, layer="LinearFFTEnriched"),
    "affine-anyglu": dict(layer="AnyGLU"),
    "affine-fft": dict(layer="LinearFFTEnriched"),
    "rqs": dict(coupling="rqs"),
    "rqs-two-way": dict(coupling="rqs", two_way=True, coupling_kwargs={"num_bins": 5, "tail_bound": 2.5}),
}


def _coupling_pair(opts: dict, n_cond: int = N_COND_FEATURES):
    from bcnf_tpu.models.cnf import AffineCoupling as JaxAffine
    from bcnf_tpu.models.cnf import RQSCoupling as JaxRQS
    from bcnf_tpu_torch.models import AffineCoupling, RQSCoupling

    kw = {k: v for k, v in opts.items() if k not in ("coupling", "coupling_kwargs")}
    kw.update(opts.get("coupling_kwargs") or {})
    jax_cls, cls = (JaxRQS, RQSCoupling) if opts.get("coupling") == "rqs" else (JaxAffine, AffineCoupling)
    return (jax_cls(input_size=SIZE, nested_sizes=[16, 16], n_conditions=n_cond, **kw),
            cls(input_size=SIZE, nested_sizes=[16, 16], n_conditions=n_cond, **kw))


@pytest.mark.parametrize("name", sorted(COUPLINGS))
def test_coupling_matches_jax(name):
    """Forward (z, logdet) and inverse of one coupling, with the condition
    given whole and as hoisted projections (`cond_proj`: a list per MLP, two
    matrices for AnyGLU, None for LinearFFTEnriched)."""
    jc, tc = _coupling_pair(COUPLINGS[name])
    jp = _np_tree(jc.init(jax.random.key(3)))
    tp = params_from_numpy(jp, "cpu")
    assert sorted(jp) == (["a", "b"] if tc.two_way else ["a"])
    assert jax.tree.map(np.shape, jp) == map_tree(lambda t: tuple(t.shape), tc.init(torch.Generator()))
    rng = np.random.default_rng(4)
    y, h = rng.normal(size=(9, SIZE)).astype(np.float32), rng.normal(size=(9, N_COND_FEATURES)).astype(np.float32)
    jpj = jax.tree.map(jnp.asarray, jp)
    proj_ref, proj = jc.cond_proj(jpj, jnp.asarray(h)), tc.cond_proj(tp, _t(h))
    for side in ("a", "b"):
        ref = proj_ref.get(side)
        assert (proj[side] is None) == (ref is None)
        if ref is not None:
            assert len(proj[side]) == len(ref) == (2 if "anyglu" in name else 1)
            for a, b in zip(proj[side], ref):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)
    for hp_ref, hp in ((None, None), (proj_ref, proj)):
        z_ref, ld_ref = jc.forward(jpj, jnp.asarray(y), jnp.asarray(h), hp_ref)
        z, ld = tc.forward(tp, _t(y), _t(h), hp)
        np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=1e-4, rtol=0)
        np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref), atol=1e-4, rtol=0)
        y_ref = jc.inverse(jpj, z_ref, jnp.asarray(h), hp_ref)
        y_back = tc.inverse(tp, z, _t(h), hp)
        np.testing.assert_allclose(y_back.numpy(), np.asarray(y_ref), atol=1e-4, rtol=0)
        np.testing.assert_allclose(y_back.numpy(), y, atol=5e-4, rtol=0)


def _flow_pair(opts: dict):
    jax_stack = JaxStack([JaxConcat(input_size=None, output_size=6), JaxFC(sizes=[6, 32, N_COND_FEATURES])])
    from bcnf_tpu_torch.models import FullyConnectedFeatureNetwork

    stack = FeatureNetworkStack([ConcatenateCondition(input_size=None, output_size=6),
                                 FullyConnectedFeatureNetwork(sizes=[6, 32, N_COND_FEATURES])])
    kw = dict(size=SIZE, nested_sizes=[16, 16, 16], n_blocks=3, n_conditions=N_COND_FEATURES, act_norm=True,
              random_state=0, **opts)
    return JaxCondRealNVP(feature_network_stack=jax_stack, **kw), CondRealNVP(feature_network_stack=stack, **kw)


@pytest.mark.parametrize("name", sorted(COUPLINGS))
def test_flow_with_other_couplings_matches_jax(name):
    """A whole CondRealNVP per option on bridged weights, dropout 0, the same
    z: forward and inverse at 1e-4, the round trip at 5e-4, and the grads of
    the NLL at atol 5e-4 / rtol 1e-3 (tests/test_flow_kernel.py:313)."""
    jm, tm = _flow_pair(COUPLINGS[name])
    rng = np.random.default_rng(5)
    jp = _np_tree(jm.init(jax.random.key(5)))
    jp["blocks"]["actnorm"]["scale"] = (1.0 + 0.2 * rng.normal(size=(2, SIZE))).astype(np.float32)
    assert jax.tree.map(np.shape, jp) == map_tree(lambda t: tuple(t.shape), tm.init(device="cpu"))
    assert not tm.coupling.fusable
    y, c = rng.normal(size=(8, SIZE)).astype(np.float32), rng.normal(size=(8, 6)).astype(np.float32)
    z0 = rng.normal(size=(8, SIZE)).astype(np.float32)
    jpj, tp = jax.tree.map(jnp.asarray, jp), params_from_numpy(jp, "cpu", requires_grad=True)
    z_ref, ld_ref = jm.forward(jpj, jnp.asarray(y), jnp.asarray(c))
    z, ld = tm.forward(tp, _t(y), _t(c))
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(z_ref), atol=1e-4, rtol=0)
    np.testing.assert_allclose(ld.detach().numpy(), np.asarray(ld_ref), atol=1e-4, rtol=0)
    with torch.no_grad():
        y_inv = tm.inverse(tp, _t(z0), _t(c))
        np.testing.assert_allclose(y_inv.numpy(), np.asarray(jm.inverse(jpj, jnp.asarray(z0), jnp.asarray(c))),
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(tm.inverse(tp, z, _t(c)).numpy(), y, atol=5e-4, rtol=0)

    def nll(p):
        zz, ll = jm.forward(p, jnp.asarray(y), jnp.asarray(c))
        return jnp.mean(0.5 * jnp.sum(zz**2, axis=-1) - ll)

    g_ref = _np_tree(jax.grad(nll)(jpj))
    torch.mean(0.5 * torch.sum(z**2, dim=-1) - ld).backward()
    grads = map_tree(lambda t: t.grad, tp)
    for path, ref in jax.tree_util.tree_leaves_with_path(g_ref):
        ours = grads
        for k in path:
            ours = ours[k.key if hasattr(k, "key") else k.idx]
        if "ortho" in jax.tree_util.keystr(path):
            continue  # fixed, not trained: stop_gradient in JAX, detach in the port
        np.testing.assert_allclose(ours.numpy(), ref, atol=5e-4, rtol=1e-3, err_msg=jax.tree_util.keystr(path))


def test_two_way_inverse_takes_the_corrected_order():
    """The two-way inverse undoes the forward (the reference's order would
    not): it conditions nn_b on z_b first, then nn_a on the recovered y_a."""
    _, tc = _coupling_pair(COUPLINGS["affine-two-way"])
    tp = tc.init(torch.Generator().manual_seed(7))
    y, h = torch.randn(5, SIZE), torch.randn(5, N_COND_FEATURES)
    z, _ = tc.forward(tp, y, h)
    assert not torch.allclose(z[:, : tc.d_a], y[:, : tc.d_a])  # both halves move
    torch.testing.assert_close(tc.inverse(tp, z, h), y, atol=5e-5, rtol=0)


@pytest.mark.parametrize("name", ["affine-fft", "affine-two-way-fft", "rqs-two-way"])
def test_sample_broadcasts_draws_over_conditions(name):
    """`sample`'s draws-major z (draws, N, size) against (N, c) conditions,
    also where the first layer takes the condition whole (LinearFFTEnriched):
    each draw as JAX's `inverse_given_h` gives it (JAX's `sample` maps over
    the draws)."""
    jm, tm = _flow_pair(COUPLINGS[name])
    jp = _np_tree(jm.init(jax.random.key(6)))
    rng = np.random.default_rng(7)
    c, z = rng.normal(size=(4, 6)).astype(np.float32), rng.normal(size=(3, 4, SIZE)).astype(np.float32)
    jpj, tp = jax.tree.map(jnp.asarray, jp), params_from_numpy(jp, "cpu")
    h_ref = jm.encode(jpj, (jnp.asarray(c),))
    with torch.no_grad():
        y = tm.inverse_given_h(tp, _t(z), tm.encode(tp, (_t(c),)))
        out = tm.sample(tp, torch.Generator().manual_seed(0), 3, _t(c), device="cpu")
    for d in range(3):
        np.testing.assert_allclose(y[d].numpy(), np.asarray(jm.inverse_given_h(jpj, jnp.asarray(z[d]), h_ref)),
                                   atol=1e-4, rtol=0)
    assert out.shape == (3, 4, SIZE) and torch.isfinite(out).all()


@pytest.mark.parametrize("name", ["rqs", "rqs-two-way", "affine-two-way-anyglu"])
def test_flow_logdet_matches_autograd_jacobian(name):
    """The whole flow's logdet against log|det| of its Jacobian by autograd,
    at tests/test_cnf.py:107's bars (2e-3 for RQS, 1e-4 for affine)."""
    _, tm = _flow_pair(COUPLINGS[name])
    tp = tm.init(torch.Generator().manual_seed(8), device="cpu")
    rng = np.random.default_rng(9)
    y = _t(0.5 * rng.normal(size=(4, SIZE)).astype(np.float32))
    c = _t(rng.normal(size=(1, 6)).astype(np.float32))
    _, ld = tm.forward(tp, y, c.expand(4, 6))
    for i in range(4):
        J = torch.autograd.functional.jacobian(lambda row: tm.forward(tp, row[None], c)[0][0], y[i])
        expected = torch.linalg.slogdet(J.double())[1].item()
        assert abs(ld[i].item() - expected) <= (2e-3 if name.startswith("rqs") else 1e-4), (i, ld[i].item(), expected)
