"""Port parity, per-coupling kernel: the plain version of K4 against the JAX
package's `fused_affine_coupling` (the Pallas kernel in interpret mode), and
a model with `use_pallas_coupling` whose per-block loop runs it against the
JAX package's XLA path, on the same seeded weights and inputs. Bars are those
of tests/test_coupling_kernel.py (atol 1e-4). The kernel itself is held
against the plain version on the card by the `gpu` tests of
tests/test_torch_port_imports.py (a file without JAX) and by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcnf_tpu.models import CondRealNVP as JaxCondRealNVP
from bcnf_tpu.models import ConcatenateCondition as JaxConcat
from bcnf_tpu.models import FeatureNetworkStack as JaxStack
from bcnf_tpu.models import LSTMFeatureNetwork as JaxLSTMNet
from bcnf_tpu.models.cnf import AffineCoupling as JaxAffineCoupling
from bcnf_tpu.ops.coupling_kernel import fused_affine_coupling as jax_fused_affine_coupling
from bcnf_tpu.ops.coupling_kernel import mlp_params_to_kernel_args as jax_kernel_args
from bcnf_tpu_torch.bridge import params_from_numpy
from bcnf_tpu_torch.models import CondRealNVP, ConcatenateCondition, FeatureNetworkStack, LSTMFeatureNetwork
from bcnf_tpu_torch.models.cnf import AffineCoupling
from bcnf_tpu_torch.ops import coupling_kernel
from bcnf_tpu_torch.ops.coupling_kernel import (
    fused_affine_coupling,
    fused_affine_coupling_reference,
    mlp_params_to_kernel_args,
)

SIZE, NESTED, N_COND, B = 19, [64, 64, 64], 32, 64


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def coupling():
    layer = JaxAffineCoupling(input_size=SIZE, nested_sizes=NESTED, n_conditions=N_COND)
    params = _np_tree(layer.init(jax.random.key(0)))
    rng = np.random.default_rng(1)
    y = rng.normal(size=(B, SIZE)).astype(np.float32)
    h = rng.normal(size=(B, N_COND)).astype(np.float32)
    port = AffineCoupling(input_size=SIZE, nested_sizes=NESTED, n_conditions=N_COND)
    return layer, params, port, params_from_numpy(params, "cpu"), y, h


def _jax_kernel(layer, params, rows, h_rows, inverse):
    jp = jax.tree.map(jnp.asarray, params)
    proj = layer.cond_proj(jp, jnp.asarray(h_rows))["a"][0]
    with jax.default_matmul_precision("highest"):
        return jax_fused_affine_coupling(jnp.asarray(rows[:, : layer.d_a]), jnp.asarray(rows[:, layer.d_a:]), proj,
                                         inverse=inverse, interpret=True, **jax_kernel_args(jp["a"], layer.d_a))


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_reference_matches_jax_interpret(coupling, inverse):
    layer, params, port, tp, y, h = coupling
    ref = _jax_kernel(layer, params, y, h, inverse)
    h_proj = port.cond_proj(tp, torch.from_numpy(h))["a"][0]
    args = mlp_params_to_kernel_args(tp["a"], port.d_a)
    ours = fused_affine_coupling(torch.from_numpy(y[:, : port.d_a]), torch.from_numpy(y[:, port.d_a:]), h_proj,
                                 **args, inverse=inverse)
    for a, b in zip((ours,) if inverse else ours, (ref,) if inverse else ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_rows_take_their_condition_modulo_n_cond(coupling, inverse):
    """Row r uses h_proj[r % N]: the JAX kernel fed the tiled per-row
    projections gives the same numbers."""
    layer, params, port, tp, y, h = coupling
    n = 16
    ref = _jax_kernel(layer, params, y, np.tile(h[:n], (B // n, 1)), inverse)
    ours = fused_affine_coupling_reference(
        torch.from_numpy(y[:, : port.d_a]), torch.from_numpy(y[:, port.d_a:]),
        port.cond_proj(tp, torch.from_numpy(h[:n]))["a"][0], **mlp_params_to_kernel_args(tp["a"], port.d_a),
        inverse=inverse, n_cond=n)
    for a, b in zip((ours,) if inverse else ours, (ref,) if inverse else ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)


def test_kernel_args_split_as_jax(coupling):
    layer, params, port, tp, y, h = coupling
    ours = mlp_params_to_kernel_args(tp["a"], port.d_a)
    ref = jax_kernel_args(params["a"], layer.d_a)
    assert len(ours["wm"]) == len(ref["wm"]) == len(NESTED) - 1
    for key in ("w1y", "b1", "wout", "bout"):
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(ref[key]))
    for a, b in zip(ours["wm"] + ours["bm"], ref["wm"] + ref["bm"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _models():
    kw = dict(input_size=3, hidden_size=6, output_size=8, num_layers=1, bidirectional=True)
    model_kw = dict(size=7, nested_sizes=[24, 24, 24], n_blocks=3, n_conditions=8, act_norm=True, random_state=0)
    jm = JaxCondRealNVP(feature_network_stack=JaxStack([JaxConcat(None, 3), JaxLSTMNet(**kw)]), **model_kw)
    tm = CondRealNVP(feature_network_stack=FeatureNetworkStack([ConcatenateCondition(None, 3),
                                                                LSTMFeatureNetwork(**kw)]), **model_kw)
    tm.use_pallas_coupling = True
    jp = _np_tree(jm.init(jax.random.key(3)))
    rng = np.random.default_rng(4)
    jp["blocks"]["actnorm"]["scale"] = (1.0 + 0.2 * rng.normal(size=(2, 7))).astype(np.float32)
    jp["blocks"]["actnorm"]["bias"] = (0.2 * rng.normal(size=(2, 7))).astype(np.float32)
    return jm, tm, jp, rng


@pytest.fixture
def gates_open(monkeypatch):
    """Opens the whole-flow gates on CPU tensors (they stand for a CUDA
    tensor with no grad) and counts the plain K4 and K1 calls behind the
    wrappers."""
    from bcnf_tpu_torch.ops import flow_kernel

    calls = {"K4": 0, "K1": 0}

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(CondRealNVP, "_use_fused", lambda self, train, x, *trees: not train)
    monkeypatch.setattr(CondRealNVP, "_use_fused_train", lambda self, train, x: True)  # K4 goes first
    monkeypatch.setattr(coupling_kernel, "fused_affine_coupling_reference",
                        counted("K4", coupling_kernel.fused_affine_coupling_reference))
    monkeypatch.setattr(flow_kernel, "fused_flow_reference", counted("K1", flow_kernel.fused_flow_reference))
    return calls


def test_model_per_coupling_path_matches_jax_xla(gates_open):
    """forward, log-det and the round trip through K4 in each of the 3
    couplings, against the JAX package's XLA path."""
    jm, tm, jp, rng = _models()
    y = rng.normal(size=(12, 7)).astype(np.float32)
    traj = rng.normal(size=(12, 5, 3)).astype(np.float32)
    jpj = jax.tree.map(jnp.asarray, jp)
    z_ref, ld_ref = jm.forward(jpj, jnp.asarray(y), jnp.asarray(traj))
    tp = params_from_numpy(jp, "cpu")
    z, ld = tm.forward(tp, torch.from_numpy(y), torch.from_numpy(traj))
    assert gates_open == {"K4": 3, "K1": 0}
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=1e-4, rtol=0)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref), atol=1e-4, rtol=0)
    y_back = tm.inverse(tp, z, torch.from_numpy(traj))
    assert gates_open == {"K4": 6, "K1": 0}
    np.testing.assert_allclose(y_back.numpy(), y, atol=1e-4, rtol=0)


def test_inverse_given_h_over_draws_matches_jax_vmap(gates_open):
    """(M, N, size) draws against N conditions: K4's rows take their
    condition modulo N; JAX vmaps its inverse over the draws."""
    jm, tm, jp, rng = _models()
    traj = rng.normal(size=(4, 5, 3)).astype(np.float32)
    z = rng.normal(size=(6, 4, 7)).astype(np.float32)
    jpj = jax.tree.map(jnp.asarray, jp)
    h_ref = jm.encode(jpj, (jnp.asarray(traj),))
    ref = jax.vmap(lambda zz: jm.inverse_given_h(jpj, zz, h_ref))(jnp.asarray(z))
    tp = params_from_numpy(jp, "cpu")
    ours = tm.inverse_given_h(tp, torch.from_numpy(z), tm.encode(tp, (torch.from_numpy(traj),)))
    assert gates_open == {"K4": 3, "K1": 0}
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_sample_keeps_the_whole_flow_kernel(gates_open):
    """sample(outer=True) takes K1 with use_pallas_coupling set, as JAX's
    sample does; without `outer`, inverse_given_h runs the couplings on K4."""
    jm, tm, jp, rng = _models()
    tp = params_from_numpy(jp, "cpu")
    traj = torch.from_numpy(rng.normal(size=(3, 5, 3)).astype(np.float32))
    out = tm.sample(tp, torch.Generator().manual_seed(0), 5, traj, device="cpu")
    assert out.shape == (5, 3, 7) and gates_open == {"K4": 0, "K1": 1}
    tm.sample(tp, torch.Generator().manual_seed(0), 3, traj, outer=False, device="cpu")
    assert gates_open == {"K4": 3, "K1": 1}


def test_gate_follows_use_pallas_coupling_and_closes_on_cpu():
    _, tm, jp, rng = _models()
    tp = params_from_numpy(jp, "cpu")
    y = torch.zeros((4, 7))
    assert not tm._use_fused_coupling(False, y)  # a CPU tensor
    before = fused_affine_coupling.launches
    tm.forward(tp, y, torch.zeros((4, 5, 3)))
    assert fused_affine_coupling.launches == before
    tm.use_pallas_coupling = False
    assert CondRealNVP(size=7, nested_sizes=[8, 8], n_blocks=2, n_conditions=0).use_pallas_coupling is False


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing(coupling):
    layer, params, port, tp, y, h = coupling
    args = mlp_params_to_kernel_args(tp["a"], port.d_a)
    x_a, x_b = torch.from_numpy(y[:, : port.d_a]), torch.from_numpy(y[:, port.d_a:])
    h_proj = port.cond_proj(tp, torch.from_numpy(h[:8]))["a"][0]
    before = fused_affine_coupling.launches
    z_b, ld = fused_affine_coupling(x_a, x_b, h_proj, **args)
    z_r, ld_r = fused_affine_coupling_reference(x_a, x_b, h_proj, **args, inverse=False, n_cond=8)
    assert torch.equal(z_b, z_r) and torch.equal(ld, ld_r)
    assert torch.equal(fused_affine_coupling(x_a, z_b, h_proj, **args, inverse=True),
                       fused_affine_coupling_reference(x_a, z_b, h_proj, **args, inverse=True, n_cond=8))
    assert fused_affine_coupling.launches == before



@pytest.mark.parametrize("bad", ["wm[0]", "bm[0]", "h_proj", "x_b", "dtype"])
def test_kernel_arguments_are_checked_before_a_launch(bad):
    """The checks the CUDA path runs before it hands pointers to the kernel."""
    from bcnf_tpu_torch.ops.coupling_kernel import _check_args

    args = dict(x_a=torch.zeros(5, 10), x_b=torch.zeros(5, 9), h_proj=torch.zeros(2, 16), w1y=torch.zeros(10, 16),
                b1=torch.zeros(16), wout=torch.zeros(16, 18), bout=torch.zeros(18),
                **{"wm[0]": torch.zeros(16, 16), "bm[0]": torch.zeros(16)})
    _check_args(args, n_cond=2)
    broken = {"wm[0]": torch.zeros(16, 15), "bm[0]": torch.zeros(15), "h_proj": torch.zeros(3, 16),
              "x_b": torch.zeros(9, 5).T, "dtype": torch.zeros(5, 10, dtype=torch.float64)}[bad]
    with pytest.raises((ValueError, TypeError)):
        _check_args({**args, ("x_a" if bad == "dtype" else bad): broken}, n_cond=2)


def _weights(args):
    return {k: args[k] for k in ("w1y", "b1", "wm", "bm", "wout", "bout")}


def test_prepared_coupling_once_per_parameter_version(coupling):
    """K4 prepares a coupling's weights once per parameter version: new views
    of the same parameters reuse the entry; an in-place update (which bumps
    `_version`) or a new tensor prepares them again; the prepared arguments
    equal `coupling_flow_args`' uncached ones."""
    layer, params, port, tp, y, h = coupling
    tp = {"a": {"layers": [{k: v.clone() for k, v in p.items()} for p in tp["a"]["layers"]]}}
    coupling_kernel._prepared.clear()
    before = fused_affine_coupling.preparations
    entry = coupling_kernel.prepared_coupling(**_weights(mlp_params_to_kernel_args(tp["a"], port.d_a)))
    for _ in range(3):  # each call slices new views of the same memory, as a model's per-block loop does
        assert coupling_kernel.prepared_coupling(**_weights(mlp_params_to_kernel_args(tp["a"], port.d_a))) is entry
    assert fused_affine_coupling.preparations == before + 1
    h_proj = port.cond_proj(tp, torch.from_numpy(h))["a"][0]
    args = mlp_params_to_kernel_args(tp["a"], port.d_a)
    uncached = coupling_kernel.coupling_flow_args(h_proj, **args)
    cached = dict(entry["args"], h_proj=coupling_kernel._pad_projection(h_proj, entry["args"]["b1"].shape[-1]))
    assert cached.keys() == uncached.keys()
    for key, t in uncached.items():
        assert torch.equal(cached[key], t), key

    tp["a"]["layers"][-1]["w"].add_(1.0)  # in place, as an optimizer step: the entry is stale
    fresh = coupling_kernel.prepared_coupling(**_weights(mlp_params_to_kernel_args(tp["a"], port.d_a)))
    assert fresh is not entry and fused_affine_coupling.preparations == before + 2
    assert torch.equal(fresh["args"]["wout"][0, : NESTED[-1]], tp["a"]["layers"][-1]["w"])
    tp["a"]["layers"][1]["w"] = tp["a"]["layers"][1]["w"].clone()  # a new tensor of the same values
    assert coupling_kernel.prepared_coupling(**_weights(mlp_params_to_kernel_args(tp["a"], port.d_a))) is not fresh
    assert fused_affine_coupling.preparations == before + 3


def test_prepared_couplings_keep_the_most_recent(coupling, monkeypatch):
    """Past PREPARED_CAPACITY couplings the least recently used is dropped
    (and prepared again when it returns); the rest stay."""
    layer, params, port, tp, y, h = coupling
    monkeypatch.setattr(coupling_kernel, "PREPARED_CAPACITY", 2)
    coupling_kernel._prepared.clear()
    copies = [{"a": {"layers": [{k: v.clone() for k, v in p.items()} for p in tp["a"]["layers"]]}} for _ in range(3)]
    weights = [_weights(mlp_params_to_kernel_args(c["a"], port.d_a)) for c in copies]
    before = fused_affine_coupling.preparations
    for w in weights:
        coupling_kernel.prepared_coupling(**w)
    assert len(coupling_kernel._prepared) == 2 and fused_affine_coupling.preparations == before + 3
    coupling_kernel.prepared_coupling(**weights[2])  # kept
    assert fused_affine_coupling.preparations == before + 3
    coupling_kernel.prepared_coupling(**weights[0])  # dropped: prepared again
    assert fused_affine_coupling.preparations == before + 4


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_k1_at_one_step_on_prepared_weights_matches_jax(coupling, inverse):
    """What the kernel computes on the prepared weights (K1 at one step, the
    plain version) against JAX's `fused_affine_coupling` in interpret mode."""
    from bcnf_tpu_torch.ops.flow_kernel import fused_flow_reference

    layer, params, port, tp, y, h = coupling
    coupling_kernel._prepared.clear()
    args = mlp_params_to_kernel_args(tp["a"], port.d_a)
    entry = coupling_kernel.prepared_coupling(**_weights(args))
    h_proj = port.cond_proj(tp, torch.from_numpy(h))["a"][0]
    flow_args = dict(entry["args"], h_proj=coupling_kernel._pad_projection(h_proj, entry["args"]["b1"].shape[-1]))
    out = fused_flow_reference(torch.from_numpy(y), **flow_args, inverse=inverse, n_cond=B)
    ref = _jax_kernel(layer, params, y, h, inverse)
    if inverse:
        np.testing.assert_allclose(out[:, port.d_a:].numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    else:
        np.testing.assert_allclose(out[0][:, port.d_a:].numpy(), np.asarray(ref[0]), atol=1e-4, rtol=0)
        np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), atol=1e-4, rtol=0)
