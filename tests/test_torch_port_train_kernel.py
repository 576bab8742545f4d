"""Port parity, training kernels: the plain versions of K2a (the whole-flow
training forward) and K2b (its backward) against the JAX package's
`fused_flow_train` (the Pallas kernels in interpret mode, differentiated by
`jax.value_and_grad` through their custom VJP), and the explicit backward
against torch autograd of the plain forward. Bars are those of
tests/test_flow_kernel.py:271-272, 307, 313. The kernels themselves are held
against these plain versions on the card (tests/test_torch_port_imports.py,
`gpu`; chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcnf_tpu.models import CondRealNVP as JaxCondRealNVP
from bcnf_tpu.models import ConcatenateCondition as JaxConcat
from bcnf_tpu.models import FeatureNetworkStack as JaxStack
from bcnf_tpu.models import FullyConnectedFeatureNetwork as JaxFC
from bcnf_tpu.ops.flow_kernel import fused_flow_train as jax_fused_flow_train
from bcnf_tpu_torch.ops.flow_kernel import (
    fused_flow_train,
    fused_flow_train_backward_reference,
    fused_flow_train_bwd,
    fused_flow_train_fwd,
    fused_flow_train_reference,
)

SIZE, N_COND_FEATURES, NESTED, N_BLOCKS = 7, 16, [24, 24, 24], 4
GRAD_NAMES = ("x", "h_proj", "an_scale", "an_bias", "w1y", "b1", "wm", "bm", "wout", "bout")
ARG_NAMES = ("an_scale", "an_bias", "ortho", "w1y", "b1", "wm", "bm", "wout", "bout")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def jax_model():
    stack = JaxStack([JaxConcat(input_size=None, output_size=6), JaxFC(sizes=[6, 32, N_COND_FEATURES])])
    model = JaxCondRealNVP(size=SIZE, nested_sizes=NESTED, n_blocks=N_BLOCKS, n_conditions=N_COND_FEATURES,
                           feature_network_stack=stack, act_norm=True, random_state=0)
    params = model.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    blocks = dict(params["blocks"])
    blocks["actnorm"] = {  # off identity, so the ActNorm grads are exercised
        "scale": jnp.asarray((1.0 + 0.2 * rng.normal(size=(N_BLOCKS - 1, SIZE))).astype(np.float32)),
        "bias": jnp.asarray((0.2 * rng.normal(size=(N_BLOCKS - 1, SIZE))).astype(np.float32)),
    }
    return model, dict(params, blocks=blocks)


def _training_args(jax_model, B: int, seed: int):
    """Per-row conditions (the training layout): h_proj is (S, B, Hp)."""
    model, params = jax_model
    rng = np.random.default_rng(seed)
    h = jnp.asarray(rng.normal(size=(B, N_COND_FEATURES)).astype(np.float32))
    kargs, h_proj = model._fused_flow_args(params, h)
    y = rng.normal(size=(B, SIZE)).astype(np.float32)
    return y, h_proj, kargs, rng


def _port_args(kargs) -> list[torch.Tensor]:
    return [_t(kargs[name]) for name in ARG_NAMES]


@pytest.mark.parametrize("B,block_b", [(16, 8), (12, 4)])
def test_train_forward_reference_matches_pallas_interpret(jax_model, B, block_b):
    y, h_proj, kargs, _ = _training_args(jax_model, B, seed=1)
    z_ref, ld_ref = jax_fused_flow_train(jnp.asarray(y), h_proj, kargs, block_b=block_b,
                                         precision="highest", interpret=True)
    z, ld, bound = fused_flow_train_reference(_t(y), _t(h_proj), *_port_args(kargs))
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=1e-4, rtol=0)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref), atol=1e-4, rtol=0)
    assert bound.shape == (N_BLOCKS, B, SIZE)
    np.testing.assert_array_equal(bound[0].numpy(), y)  # step 0's input is the batch itself


@pytest.mark.parametrize("B,block_b", [(16, 8), (12, 4)])
def test_train_backward_reference_matches_pallas_vjp(jax_model, B, block_b):
    """Mean NLL through JAX's custom VJP (K2b in interpret mode) against the
    port's explicit backward fed the same cotangents."""
    y, h_proj, kargs, _ = _training_args(jax_model, B, seed=2)

    def loss(y, h_proj, kargs):
        z, ld = jax_fused_flow_train(y, h_proj, kargs, block_b=block_b, precision="highest", interpret=True)
        return jnp.mean(0.5 * jnp.sum(z**2, axis=-1) - ld)

    v_ref, (dy_ref, dhp_ref, dk_ref) = jax.value_and_grad(loss, argnums=(0, 1, 2))(jnp.asarray(y), h_proj, kargs)
    args = _port_args(kargs)
    z, ld, bound = fused_flow_train_reference(_t(y), _t(h_proj), *args)
    v = torch.mean(0.5 * torch.sum(z**2, dim=-1) - ld)
    np.testing.assert_allclose(float(v), float(v_ref), atol=1e-5, rtol=0)
    grads = fused_flow_train_backward_reference(bound, _t(h_proj), z / B, torch.full((B,), -1.0 / B), *args)
    refs = (dy_ref, dhp_ref, *(dk_ref[n] for n in GRAD_NAMES[2:]))
    for name, g, r in zip(GRAD_NAMES, grads, refs):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-4, rtol=1e-3, err_msg=name)
    np.testing.assert_array_equal(np.asarray(dk_ref["ortho"]), 0.0)


def _port_inputs(seed: int, B: int, Hp: int = 32):
    """Stacked kernel arguments at the port's own padded width, drawn from a
    seed (scales away from zero, hidden columns past 24 zero as `pad_hidden`
    leaves them)."""
    g = torch.Generator().manual_seed(seed)
    S, d_a, n_out, nh = N_BLOCKS, (SIZE + 1) // 2, 2 * (SIZE // 2), len(NESTED) - 1
    H = NESTED[0]

    def r(*shape, scale=0.3):
        return scale * torch.randn(shape, generator=g)

    def pad(t):  # zero the padded hidden columns / rows
        t = t.clone()
        t[..., H:] = 0.0
        return t

    wm = pad(r(S, nh, Hp, Hp))
    wm[:, :, H:, :] = 0.0
    wout = r(S, Hp, n_out)
    wout[:, H:, :] = 0.0
    q, _ = torch.linalg.qr(torch.randn((S, SIZE, SIZE), generator=g))
    an_s = 1.0 + r(S, SIZE, scale=0.2)
    an_s[-1], an_b = 1.0, r(S, SIZE, scale=0.2)
    an_b[-1] = 0.0
    q[-1] = torch.eye(SIZE)
    args = [an_s, an_b, q.contiguous(), pad(r(S, d_a, Hp)), pad(r(S, Hp)), wm, pad(r(S, nh, Hp)), wout,
            r(S, n_out)]
    return r(B, SIZE, scale=1.0), pad(r(S, B, Hp)), args, g


def test_train_backward_reference_matches_autograd():
    """The explicit backward, output by output, is autograd of the plain
    forward (the fixed mixes aside: the kernel's VJP gives them no grad)."""
    x, h_proj, args, g = _port_inputs(3, B=10)
    leaves = [t.clone().requires_grad_(True) for t in (x, h_proj, *args)]
    z, ld, bound = fused_flow_train_reference(*leaves)
    dz, dld = torch.randn(z.shape, generator=g), torch.randn(ld.shape, generator=g)
    auto = torch.autograd.grad((z, ld), leaves, grad_outputs=(dz, dld))
    ours = fused_flow_train_backward_reference(bound.detach(), h_proj, dz, dld, *args)
    auto = [a for i, a in enumerate(auto) if i != 4]  # leaves: x, h_proj, an_s, an_b, ortho, ...
    for name, a, o in zip(GRAD_NAMES, auto, ours):
        torch.testing.assert_close(o, a, atol=1e-5, rtol=1e-5, msg=name)
    assert torch.equal(ours[2][-1], torch.zeros(SIZE)) and torch.equal(ours[3][-1], torch.zeros(SIZE))


def test_fused_flow_train_on_cpu_is_its_plain_version_and_launches_nothing():
    x, h_proj, args, g = _port_inputs(4, B=9)
    before = (fused_flow_train_fwd.launches, fused_flow_train_bwd.launches)
    leaves = [t.clone().requires_grad_(True) for t in (x, h_proj, *args)]
    z, ld = fused_flow_train(*leaves)
    z_r, ld_r, bound = fused_flow_train_reference(x, h_proj, *args)
    assert torch.equal(z, z_r) and torch.equal(ld, ld_r)
    dz, dld = torch.randn(z.shape, generator=g), torch.randn(ld.shape, generator=g)
    grads = torch.autograd.grad((z, ld), leaves, grad_outputs=(dz, dld))
    ours = fused_flow_train_backward_reference(bound, h_proj, dz, dld, *args)
    for name, a, o in zip(GRAD_NAMES, [a for i, a in enumerate(grads) if i != 4], ours):
        assert torch.equal(a, o), name
    assert torch.equal(grads[4], torch.zeros_like(args[2]))  # the fixed mixes
    assert (fused_flow_train_fwd.launches, fused_flow_train_bwd.launches) == before


def test_fused_flow_train_takes_one_condition_row_per_row():
    x, h_proj, args, _ = _port_inputs(5, B=8)
    with pytest.raises(ValueError, match="own conditions"):
        fused_flow_train(x, h_proj[:, :4], *args)  # 4 condition rows for 8 rows: the sampling layout
    with pytest.raises(ValueError, match="own conditions"):
        fused_flow_train(x[None], h_proj, *args)
