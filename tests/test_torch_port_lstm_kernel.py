"""Port parity, LSTM recurrence kernels: the plain versions of K3a (one
direction's recurrence) and K3b (its backward) inside the port's
`_FusedLSTMDirection` against the JAX package's `fused_direction` (the Pallas
kernels in interpret mode, differentiated by `jax.grad` through their custom
VJP), on the same seeded numpy inputs. Bars are those of
tests/test_lstm_kernel.py: outputs 1e-5, grads atol 1e-4 / rtol 1e-4. The
kernels themselves are held against these plain versions on the card by the
`gpu` tests of tests/test_torch_port_imports.py (a file without JAX, which
the card's machine lacks) and by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bcnf_tpu.ops import lstm as jax_lstm
from bcnf_tpu.ops.lstm_kernel import fused_direction as jax_fused_direction
from bcnf_tpu_torch.bridge import params_from_numpy
from bcnf_tpu_torch.ops import lstm
from bcnf_tpu_torch.ops.flow_kernel import padded_width
from bcnf_tpu_torch.ops.lstm_kernel import (
    LSTM_KERNEL_TN,
    fused_direction,
    lstm_direction_bwd,
    lstm_direction_bwd_reference,
    lstm_direction_fwd,
    lstm_direction_fwd_reference,
    pad_gates,
)

B, T, F, H = 8, 10, 3, 12
PARAM_NAMES = ("w_ih", "w_hh", "b_ih", "b_hh")


def _cell_params(rng, in_dim: int = F, hidden: int = H) -> dict:
    k = 1.0 / np.sqrt(hidden)
    return {
        "w_ih": rng.uniform(-k, k, size=(in_dim, 4 * hidden)).astype(np.float32),
        "w_hh": rng.uniform(-k, k, size=(hidden, 4 * hidden)).astype(np.float32),
        "b_ih": rng.uniform(-k, k, size=(4 * hidden,)).astype(np.float32),
        "b_hh": rng.uniform(-k, k, size=(4 * hidden,)).astype(np.float32),
    }


def _inputs(seed: int, batch: int = B):
    rng = np.random.default_rng(seed)
    return _cell_params(rng), rng.normal(size=(batch, T, F)).astype(np.float32)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_fused_direction_matches_jax_interpret(reverse):
    params, x = _inputs(0)
    ref = jax_fused_direction(_jax(params), jnp.asarray(x), H, reverse, interpret=True)
    ours = fused_direction(params_from_numpy(params, "cpu"), torch.from_numpy(x), H, reverse)
    assert ours.shape == (B, T, H)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_fused_direction_grads_match_jax_vjp(reverse):
    """The grads of w_ih, w_hh, the biases and x: the port's plain K3b inside
    `_FusedLSTMDirection` (and autograd for the projection) against
    `jax.grad` through the interpret-mode kernels' custom VJP."""
    params, x = _inputs(1)

    def loss(p, xx):
        return jnp.sum(jnp.tanh(jax_fused_direction(p, xx, H, reverse, interpret=True)) ** 2)

    g_p, g_x = jax.grad(loss, argnums=(0, 1))(_jax(params), jnp.asarray(x))
    tp = params_from_numpy(params, "cpu", requires_grad=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    torch.sum(torch.tanh(fused_direction(tp, tx, H, reverse)) ** 2).backward()
    for name in PARAM_NAMES:
        np.testing.assert_allclose(tp[name].grad.numpy(), np.asarray(g_p[name]), atol=1e-4, rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(g_x), atol=1e-4, rtol=1e-4, err_msg="x")


def test_lstm_apply_fused_matches_jax_fused(monkeypatch):
    """BCNF_FUSED_LSTM=1 routes both packages' `lstm_apply` through their
    fused recurrence (JAX in forced interpret mode): 2 layers, bidirectional."""
    rng = np.random.default_rng(2)
    params = {"layers": [{"fwd": _cell_params(rng, F), "bwd": _cell_params(rng, F)},
                         {"fwd": _cell_params(rng, 2 * H), "bwd": _cell_params(rng, 2 * H)}]}
    x = rng.normal(size=(B, T, F)).astype(np.float32)
    monkeypatch.setenv("BCNF_FUSED_LSTM", "1")
    with pltpu.force_tpu_interpret_mode():
        ref = jax_lstm.lstm_apply(_jax(params), jnp.asarray(x), H)
    before = lstm_direction_fwd.launches
    ours = lstm.lstm_apply(params_from_numpy(params, "cpu"), torch.from_numpy(x), H)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    assert lstm_direction_fwd.launches == before  # CPU tensors: the plain versions, no launch


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_ragged_batch_runs_fused_and_matches_jax_scan(reverse):
    """B = 7 does not tile JAX's kernel (it falls back to its scan); the
    port's fused path takes it, values and grads."""
    params, x = _inputs(3, batch=7)
    jp = _jax(params)

    def loss(p, xx):
        return jnp.sum(jnp.sin(jax_lstm._direction_scan(p, xx, H, reverse)))

    ref = jax_lstm._direction_scan(jp, jnp.asarray(x), H, reverse)
    g_p, g_x = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = params_from_numpy(params, "cpu", requires_grad=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    ours = fused_direction(tp, tx, H, reverse)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    torch.sum(torch.sin(ours)).backward()
    for name in PARAM_NAMES:
        np.testing.assert_allclose(tp[name].grad.numpy(), np.asarray(g_p[name]), atol=1e-4, rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(g_x), atol=1e-4, rtol=1e-4, err_msg="x")


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_backward_reference_is_autograd_of_the_forward_reference(reverse):
    """The explicit K3b, output by output, is autograd of the plain K3a."""
    g = torch.Generator().manual_seed(4)
    xp = torch.randn((T, 5, 4 * H), generator=g)
    w_hh = 0.3 * torch.randn((H, 4 * H), generator=g)
    leaves = [xp.clone().requires_grad_(True), w_hh.clone().requires_grad_(True)]
    hs, cs = lstm_direction_fwd_reference(*leaves, reverse)
    dhs = torch.randn(hs.shape, generator=g)
    auto = torch.autograd.grad(hs, leaves, grad_outputs=dhs)
    ours = lstm_direction_bwd_reference(xp, w_hh, hs.detach(), cs.detach(), dhs, reverse)
    for name, a, o in zip(("dxp", "dW_hh"), auto, ours):
        torch.testing.assert_close(o, a, atol=1e-5, rtol=1e-5, msg=name)


def test_gate_routes_directions_and_keeps_the_loop_by_default(monkeypatch):
    params, x = _inputs(5)
    tp = params_from_numpy(params, "cpu")
    calls = []
    monkeypatch.setattr("bcnf_tpu_torch.ops.lstm_kernel.fused_direction",
                        lambda *a: calls.append(a[3]) or lstm._direction_scan(*a))
    monkeypatch.delenv("BCNF_FUSED_LSTM", raising=False)
    loop = lstm._direction(tp, torch.from_numpy(x), H, reverse=True)
    assert calls == []
    monkeypatch.setenv("BCNF_FUSED_LSTM", "1")
    assert torch.equal(lstm._direction(tp, torch.from_numpy(x), H, reverse=True), loop)
    assert calls == [True]


def test_cpu_wrappers_take_the_plain_versions_and_launch_nothing():
    g = torch.Generator().manual_seed(6)
    xp, w_hh = torch.randn((T, 3, 4 * H), generator=g), torch.randn((H, 4 * H), generator=g)
    before = (lstm_direction_fwd.launches, lstm_direction_bwd.launches)
    hs, cs = lstm_direction_fwd(xp, w_hh, False)
    ref = lstm_direction_fwd_reference(xp, w_hh, False)
    assert torch.equal(hs, ref[0]) and torch.equal(cs, ref[1])
    dhs = torch.randn(hs.shape, generator=g)
    for a, b in zip(lstm_direction_bwd(xp, w_hh, hs, cs, dhs, False),
                    lstm_direction_bwd_reference(xp, w_hh, hs, cs, dhs, False)):
        assert torch.equal(a, b)
    assert (lstm_direction_fwd.launches, lstm_direction_bwd.launches) == before
    with pytest.raises(ValueError, match="time-major"):
        lstm_direction_fwd(xp[..., :-1], w_hh, False)


@pytest.mark.parametrize("bad", ["shape", "dtype", "contiguity"])
def test_kernel_arguments_are_checked_before_a_launch(bad):
    """The checks the CUDA path runs before it hands pointers to the kernels."""
    from bcnf_tpu_torch.ops.lstm_kernel import _check

    shapes = {"xp": (T, 3, 4 * H), "w_hh": (H, 4 * H)}
    good = {"xp": torch.zeros(T, 3, 4 * H), "w_hh": torch.zeros(H, 4 * H)}
    _check("K3a", good, shapes)
    broken = {"shape": torch.zeros(H, 4 * H + 4), "dtype": torch.zeros(H, 4 * H, dtype=torch.float64),
              "contiguity": torch.zeros(4 * H, H).T}[bad]
    with pytest.raises((ValueError, TypeError)):
        _check("K3a", {**good, "w_hh": broken}, shapes)


def test_gate_padding_keeps_each_gate_block_in_place():
    assert [padded_width(h, LSTM_KERNEL_TN) for h in (12, 128, 140, 212, 256)] == [32, 128, 160, 224, 256]
    with pytest.raises(ValueError):
        padded_width(257, LSTM_KERNEL_TN)
    w = torch.randn((H, 4 * H), generator=torch.Generator().manual_seed(7))
    wp = pad_gates(w, 32)
    assert wp.shape == (32, 128)
    for g in range(4):
        assert torch.equal(wp[:H, 32 * g: 32 * g + H], w[:, H * g: H * (g + 1)])
    mask = torch.zeros_like(wp, dtype=torch.bool)
    for g in range(4):
        mask[:H, 32 * g: 32 * g + H] = True
    assert torch.count_nonzero(wp[~mask]) == 0



@pytest.mark.parametrize("flag", [None, "0", "1"], ids=["unset", "0", "1"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_fused_lstm_gate_by_variable_and_device(monkeypatch, flag, device):
    """The gate reads the variable and the tensor's device alone: unset, a
    CUDA tensor takes K3a/K3b (the card's measurement) and a CPU tensor the
    time loop; ``0`` keeps the loop and ``1`` takes the kernels everywhere."""
    if flag is None:
        monkeypatch.delenv("BCNF_FUSED_LSTM", raising=False)
    else:
        monkeypatch.setenv("BCNF_FUSED_LSTM", flag)
    expected = {None: device == "cuda", "0": False, "1": True}[flag]
    assert lstm._fused_enabled(torch.device(device)) is expected


def test_unset_gate_keeps_cpu_outputs_equal_to_jax_lstm(monkeypatch):
    """With the variable unset a CPU tensor runs the time loop, as JAX's
    default runs its scan: 2 layers, bidirectional, no launch."""
    rng = np.random.default_rng(8)
    params = {"layers": [{"fwd": _cell_params(rng, F), "bwd": _cell_params(rng, F)},
                         {"fwd": _cell_params(rng, 2 * H), "bwd": _cell_params(rng, 2 * H)}]}
    x = rng.normal(size=(B, T, F)).astype(np.float32)
    monkeypatch.delenv("BCNF_FUSED_LSTM", raising=False)
    ref = jax_lstm.lstm_apply(_jax(params), jnp.asarray(x), H)
    before = lstm_direction_fwd.launches
    ours = lstm.lstm_apply(params_from_numpy(params, "cpu"), torch.from_numpy(x), H)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    assert lstm_direction_fwd.launches == before
