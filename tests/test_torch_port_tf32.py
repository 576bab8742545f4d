"""Port parity, the tensor-core arithmetic of K1, K2a, K2b, K3a, K3b and K4: 3xTF32.

The flow kernels (`csrc/flow_kernel.cu`'s row tiles: K1's forward and wide
inverse, K2a; `csrc/flow_wgmma.cu`: K1's inverse on `wgmma`; K4 as K1 at
one step; `csrc/flow_train_kernel.cu`: K2b), the LSTM kernels
(`csrc/lstm_kernel.cu`) and the AᵀB pass (`csrc/atb.cuh`)
take their large products on Hopper's tensor cores in 3xTF32, the
counterpart of the JAX kernels' "x3" (bf16 x 3) mode that serves their
"highest" contract. `bcnf_tpu_torch/ops/tf32.py` models that arithmetic in
plain PyTorch; here the plain K1, K4, K3a, K3b, K2a and K2b versions, with every
product taken by that model, are held against the JAX package's Pallas
kernels in interpret mode at the existing bars (forwards:
tests/test_lstm_kernel.py:30, hs and cs atol 1e-5; tests/test_flow_kernel.py:89-117,
z and logdet atol 1e-4; grads: tests/test_lstm_kernel.py:48, atol 1e-4,
rtol 1e-4; tests/test_flow_kernel.py:313, atol 5e-4, rtol 1e-3), on seeded
numpy inputs. A single TF32 pass is shown to fall outside the LSTM bars, so
the comparisons can tell the two apart. The kernels themselves are held
against the plain versions on the card (tests/test_torch_port_imports.py,
`gpu`).
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcnf_tpu.models import CondRealNVP as JaxCondRealNVP
from bcnf_tpu.models import ConcatenateCondition as JaxConcat
from bcnf_tpu.models import FeatureNetworkStack as JaxStack
from bcnf_tpu.models import FullyConnectedFeatureNetwork as JaxFC
from bcnf_tpu.models.cnf import AffineCoupling as JaxAffineCoupling
from bcnf_tpu.ops.coupling_kernel import fused_affine_coupling as jax_fused_affine_coupling
from bcnf_tpu.ops.coupling_kernel import mlp_params_to_kernel_args as jax_coupling_args
from bcnf_tpu.ops.flow_kernel import fused_flow as jax_fused_flow
from bcnf_tpu.ops.flow_kernel import fused_flow_train as jax_fused_flow_train
from bcnf_tpu.ops.lstm_kernel import _make_lstm_dir
from bcnf_tpu_torch.bridge import params_from_numpy
from bcnf_tpu_torch.models.cnf import AffineCoupling
from bcnf_tpu_torch.ops import flow_kernel
from bcnf_tpu_torch.ops.atb import atb, atb_reference
from bcnf_tpu_torch.ops.coupling_kernel import (
    coupling_flow_args,
    fused_affine_coupling_reference,
    mlp_params_to_kernel_args,
)
from bcnf_tpu_torch.ops.flow_kernel import (
    ROUTE_FMA,
    ROUTE_FWD_WGMMA,
    ROUTE_ROWS,
    ROUTE_WGMMA,
    ROUTE_WGMMA_TF32,
    ROUTE_WIDE,
    ROUTE_WIDE_FWD,
    flow_route,
    fused_flow_reference,
    fused_flow_train_backward_reference,
    fused_flow_train_reference,
    kernel_limit,
    kernel_smem,
    prepare_weights,
    wgmma_grid,
    wgmma_ring,
)
from bcnf_tpu_torch.ops.lstm_kernel import lstm_direction_bwd_reference, lstm_direction_fwd_reference
from bcnf_tpu_torch.ops.tf32 import matmul_3xtf32, matmul_tf32, round_tf32, split_tf32, truncate_tf32

LSTM_ATOL, LSTM_RTOL = 1e-4, 1e-4  # tests/test_lstm_kernel.py:48
FLOW_ATOL, FLOW_RTOL = 5e-4, 1e-3  # tests/test_flow_kernel.py:313
LSTM_FWD_ATOL = 1e-5  # hs, cs: tests/test_lstm_kernel.py:30
FLOW_FWD_ATOL = 1e-4  # z, logdet: tests/test_flow_kernel.py:89-117


def _cvt_rna_tf32(x: np.ndarray) -> np.ndarray:
    """An independent model of `cvt.rna.tf32.f32`, in float64 arithmetic:
    round |x| to the nearest multiple of the TF32 quantum at its exponent
    (10 mantissa bits; subnormals keep float32's smallest exponent), ties
    away from zero, sign restored; ±inf and ±0 pass through."""
    x = np.asarray(x, dtype=np.float32)
    out = np.empty_like(x)
    for idx, v in np.ndenumerate(x):
        if not np.isfinite(v) or v == 0:
            out[idx] = v
            continue
        a = abs(float(v))
        _, e = np.frexp(a)  # a = m 2^e, 0.5 <= m < 1
        q = 2.0 ** (max(int(e), -125) - 11)
        r = np.floor(a / q + 0.5) * q
        with np.errstate(over="ignore"):
            out[idx] = np.float32(np.copysign(r, float(v)))
    return out


EDGE_CASES = {
    # dropped 13 bits exactly half: ties go away from zero
    "ties": np.array([0x3F801000, 0x3F803000, 0x40A01000, 0x00001000, 0x00803000], dtype=np.uint32),
    # one below and one above half
    "near_ties": np.array([0x3F800FFF, 0x3F801001, 0x3F7FFFFF, 0x7F7FEFFF, 0x7F7FFFFF], dtype=np.uint32),
    "negatives": np.array([0xBF801000, 0xBF800FFF, 0xBF801001, 0xC2F6E979, 0x80001000], dtype=np.uint32),
    "subnormals": np.array([0x00000001, 0x00000FFF, 0x00001001, 0x007FFFFF, 0x807FF000], dtype=np.uint32),
    "inf_and_zero": np.array([0x7F800000, 0xFF800000, 0x00000000, 0x80000000], dtype=np.uint32),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_round_tf32_is_cvt_rna_on_edge_cases(case):
    x = EDGE_CASES[case].view(np.float32)
    got = round_tf32(torch.from_numpy(x.copy())).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), _cvt_rna_tf32(x).view(np.uint32))


def test_round_tf32_is_cvt_rna_on_random_values():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**32, size=4000, dtype=np.uint64).astype(np.uint32)
    x = bits.view(np.float32)
    x = x[np.isfinite(x)]
    got = round_tf32(torch.from_numpy(x.copy())).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), _cvt_rna_tf32(x).view(np.uint32))


def test_split_tf32_keeps_21_bits():
    """hi is rounded, lo = x - hi truncated as the tensor cores read it: both
    TF32 values, together within 2^-21 |x| of x."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.normal(size=10_000) * 10.0 ** rng.integers(-20, 20, size=10_000)).astype(np.float32))
    hi, lo = split_tf32(x)
    for part in (hi, lo):
        assert torch.all(part.view(torch.int32) & 0x1FFF == 0)  # both are TF32 values
    torch.testing.assert_close(hi, round_tf32(x), atol=0, rtol=0)
    err = (x.double() - hi.double() - lo.double()).abs()
    assert torch.all(err <= 2.0**-21 * x.double().abs())


def test_matmul_3xtf32_is_near_float32_and_one_pass_is_not():
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.normal(size=(64, 256)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(256, 48)).astype(np.float32))
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()  # the error bound's scale, element by element
    e3 = ((matmul_3xtf32(a, b).double() - exact).abs() / scale).max().item()
    e32 = ((a @ b).double() - exact).abs().div(scale).max().item()
    e1 = ((matmul_tf32(a, b).double() - exact).abs() / scale).max().item()
    assert e3 <= 2.0**-19 and e32 <= 2.0**-19
    assert e1 >= 2.0**-14  # a single TF32 pass keeps ~11 bits


def _lstm_case(seed: int, H: int, T: int = 8, B: int = 8):
    rng = np.random.default_rng(seed)
    xp = rng.normal(size=(T, B, 4 * H)).astype(np.float32)
    w_hh = (rng.uniform(-1.0, 1.0, size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    dhs = rng.normal(size=(T, B, H)).astype(np.float32)
    return xp, w_hh, dhs


def _jax_lstm_vjp(xp, w_hh, dhs, reverse: bool):
    """dxp and dW_hh through the JAX kernel's custom VJP (K3b in interpret
    mode), at precision "highest"."""
    T, B, G = xp.shape
    fn = _make_lstm_dir(G // 4, reverse, B, "highest", True)
    _, vjp = jax.vjp(fn, jnp.asarray(xp), jnp.asarray(w_hh))
    return [np.asarray(g) for g in vjp(jnp.asarray(dhs))]


def _jax_lstm_fwd(xp, w_hh, reverse: bool):
    """hs and cs from JAX's `_fwd_kernel` in interpret mode at precision
    "highest" (the custom VJP's forward rule, which keeps cs)."""
    T, B, G = xp.shape
    fn = _make_lstm_dir(G // 4, reverse, B, "highest", True)
    _, (_, _, hs, cs) = fn.fwd(jnp.asarray(xp), jnp.asarray(w_hh))
    return np.asarray(hs), np.asarray(cs)


def _port_lstm_fwd(xp, w_hh, reverse: bool, mm):
    hs, cs = lstm_direction_fwd_reference(torch.from_numpy(xp), torch.from_numpy(w_hh), reverse, mm=mm)
    return hs.numpy(), cs.numpy()


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("H", [16, 32])
def test_lstm_forward_in_3xtf32_matches_jax_kernel(reverse, H):
    """K3a's arithmetic (the step products in 3xTF32) against JAX's
    `_fwd_kernel` in interpret mode: hs and cs at the LSTM forward bar."""
    xp, w_hh, _ = _lstm_case(3, H)
    for name, g, r in zip(("hs", "cs"), _port_lstm_fwd(xp, w_hh, reverse, matmul_3xtf32),
                          _jax_lstm_fwd(xp, w_hh, reverse)):
        np.testing.assert_allclose(g, r, atol=LSTM_FWD_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_lstm_forward_in_one_tf32_pass_falls_outside_the_bar(reverse):
    """The control: one TF32 pass for the step products misses the forward
    bar, so the test above can tell 3xTF32 from it."""
    xp, w_hh, _ = _lstm_case(3, 32)
    got = _port_lstm_fwd(xp, w_hh, reverse, matmul_tf32)
    inside = [np.allclose(g, r, atol=LSTM_FWD_ATOL, rtol=0) for g, r in zip(got, _jax_lstm_fwd(xp, w_hh, reverse))]
    assert not all(inside), inside


def _port_lstm_grads(xp, w_hh, dhs, reverse: bool, mm):
    xp_t, w_t = torch.from_numpy(xp), torch.from_numpy(w_hh)
    hs, cs = lstm_direction_fwd_reference(xp_t, w_t, reverse)
    return [g.numpy() for g in lstm_direction_bwd_reference(xp_t, w_t, hs, cs, torch.from_numpy(dhs), reverse, mm=mm)]


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("H", [16, 32])
def test_lstm_backward_in_3xtf32_matches_jax_kernel(reverse, H):
    """K3b's arithmetic (every product in 3xTF32) against JAX's `_bwd_kernel`
    in interpret mode: dxp and dW_hh at the LSTM grad bar."""
    xp, w_hh, dhs = _lstm_case(3, H)
    ref = _jax_lstm_vjp(xp, w_hh, dhs, reverse)
    got = _port_lstm_grads(xp, w_hh, dhs, reverse, matmul_3xtf32)
    for name, g, r in zip(("dxp", "dW_hh"), got, ref):
        np.testing.assert_allclose(g, r, atol=LSTM_ATOL, rtol=LSTM_RTOL, err_msg=name)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_lstm_backward_in_one_tf32_pass_falls_outside_the_bar(reverse):
    """The control: the same comparison with a single TF32 pass for every
    product misses the bar, so the test above can tell 3xTF32 from it."""
    xp, w_hh, dhs = _lstm_case(3, 32)
    ref = _jax_lstm_vjp(xp, w_hh, dhs, reverse)
    got = _port_lstm_grads(xp, w_hh, dhs, reverse, matmul_tf32)
    inside = [np.allclose(g, r, atol=LSTM_ATOL, rtol=LSTM_RTOL) for g, r in zip(got, ref)]
    assert not all(inside), inside


SIZE, N_COND_FEATURES, N_BLOCKS = 7, 16, 4  # 4 flow steps
GRAD_NAMES = ("x", "h_proj", "an_scale", "an_bias", "w1y", "b1", "wm", "bm", "wout", "bout")
ARG_NAMES = ("an_scale", "an_bias", "ortho", "w1y", "b1", "wm", "bm", "wout", "bout")


@pytest.fixture(scope="module", params=[32, 64], ids=["hidden32", "hidden64"])
def jax_flow(request):
    hidden = request.param
    stack = JaxStack([JaxConcat(input_size=None, output_size=6), JaxFC(sizes=[6, 32, N_COND_FEATURES])])
    model = JaxCondRealNVP(size=SIZE, nested_sizes=[hidden] * 3, n_blocks=N_BLOCKS, n_conditions=N_COND_FEATURES,
                           feature_network_stack=stack, act_norm=True, random_state=0)
    params = model.init(jax.random.key(0))
    rng = np.random.default_rng(4)
    blocks = dict(params["blocks"])
    blocks["actnorm"] = {  # off identity, so the ActNorm grads are exercised
        "scale": jnp.asarray((1.0 + 0.2 * rng.normal(size=(N_BLOCKS - 1, SIZE))).astype(np.float32)),
        "bias": jnp.asarray((0.2 * rng.normal(size=(N_BLOCKS - 1, SIZE))).astype(np.float32)),
    }
    return model, dict(params, blocks=blocks)


def _flow_case(model, params, B: int = 16):
    """Seeded kernel arguments (rows with their own conditions) and y."""
    rng = np.random.default_rng(5)
    h = jnp.asarray(rng.normal(size=(B, N_COND_FEATURES)).astype(np.float32))
    kargs, h_proj = model._fused_flow_args(params, h)
    y = jnp.asarray(rng.normal(size=(B, SIZE)).astype(np.float32))
    return kargs, h_proj, y, rng


@pytest.mark.parametrize("precision", ["highest", "x3"])
def test_flow_forward_in_3xtf32_matches_jax_kernel(jax_flow, precision):
    """K2a's arithmetic (every product in 3xTF32) against JAX's training
    forward (`_flow_fwd_train_kernel`) in interpret mode, at "highest" and at
    "x3" (bf16 x 3, what "highest" maps to in the JAX model): z and logdet at
    the flow forward bar. x3's own error at these sizes stays inside it."""
    model, params = jax_flow
    kargs, h_proj, y, _ = _flow_case(model, params)
    z_ref, ld_ref = jax_fused_flow_train(y, h_proj, kargs, block_b=8, precision=precision, interpret=True)
    args = [torch.from_numpy(np.array(kargs[n])) for n in ARG_NAMES]
    z, ld, _ = fused_flow_train_reference(torch.from_numpy(np.array(y)), torch.from_numpy(np.array(h_proj)), *args,
                                          mm=matmul_3xtf32)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=FLOW_FWD_ATOL, rtol=0, err_msg="z")
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref), atol=FLOW_FWD_ATOL, rtol=0, err_msg="logdet")


@pytest.mark.parametrize("precision", ["highest", "x3"])
def test_flow_backward_in_3xtf32_matches_jax_kernel(jax_flow, precision):
    """K2b's arithmetic (every product in 3xTF32) against JAX's training
    kernels in interpret mode (`_flow_bwd_train_kernel` through the custom
    VJP), at "highest" and at "x3" (bf16 x 3, what "highest" maps to in the
    JAX model): all ten grads at the flow grad bar."""
    model, params = jax_flow
    B, block_b = 16, 8
    kargs, h_proj, y, rng = _flow_case(model, params, B)
    dz = rng.normal(size=(B, SIZE)).astype(np.float32)
    dld = rng.normal(size=(B,)).astype(np.float32)

    def f(y, h_proj, kargs):
        return jax_fused_flow_train(y, h_proj, kargs, block_b=block_b, precision=precision, interpret=True)

    _, vjp = jax.vjp(f, y, h_proj, kargs)
    dy_ref, dhp_ref, dk_ref = vjp((jnp.asarray(dz), jnp.asarray(dld)))
    refs = (dy_ref, dhp_ref, *(dk_ref[n] for n in GRAD_NAMES[2:]))

    args = [torch.from_numpy(np.array(kargs[n])) for n in ARG_NAMES]
    hp = torch.from_numpy(np.array(h_proj))
    _, _, bound = fused_flow_train_reference(torch.from_numpy(np.array(y)), hp, *args)
    got = fused_flow_train_backward_reference(bound, hp, torch.from_numpy(dz), torch.from_numpy(dld), *args,
                                              mm=matmul_3xtf32)
    for name, g, r in zip(GRAD_NAMES, got, refs):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=FLOW_ATOL, rtol=FLOW_RTOL, err_msg=name)


# ---------------------------------------------------------------------------
# K1 and K4 in 3xTF32 (the default mode), their weight preparation and routes
# ---------------------------------------------------------------------------

FLOW_ARGS = ("h_proj", *ARG_NAMES)


def _k1_case(model, params, n_cond: int = 4, B: int = 16):
    """Seeded K1 arguments: n_cond conditions for B rows (row r takes r % n_cond)."""
    rng = np.random.default_rng(7)
    h = jnp.asarray(rng.normal(size=(n_cond, N_COND_FEATURES)).astype(np.float32))
    kargs, h_proj = model._fused_flow_args(params, h)
    x = rng.normal(size=(B, SIZE)).astype(np.float32)
    return dict(kargs, h_proj=h_proj), x


@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
@pytest.mark.parametrize("precision", ["highest", "x3"])
def test_k1_in_3xtf32_matches_jax_kernel(jax_flow, precision, inverse):
    """K1's default-mode arithmetic (every product in 3xTF32) against JAX's
    `fused_flow` in interpret mode, at "highest" and at "x3" (what the JAX
    model runs for "highest"), with 4 conditions for 16 rows so that rows
    take r % N: y, or z and logdet, at the flow forward bar."""
    model, params = jax_flow
    args, x = _k1_case(model, params)
    ref = jax_fused_flow(jnp.asarray(x), **args, inverse=inverse, n_cond=4, block_b=8, precision=precision,
                         interpret=True)
    ours = fused_flow_reference(torch.from_numpy(x), **{k: torch.from_numpy(np.array(v)) for k, v in args.items()},
                                inverse=inverse, n_cond=4, mm=matmul_3xtf32)
    for name, g, r in zip(("y",) if inverse else ("z", "logdet"), (ours,) if inverse else ours,
                          (ref,) if inverse else ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=FLOW_FWD_ATOL, rtol=0, err_msg=name)


@pytest.fixture(scope="module")
def coupling_case():
    """A flagship-shaped coupling (size 19) at a small width, with 5
    conditions for 20 rows."""
    layer = JaxAffineCoupling(input_size=19, nested_sizes=[48, 48, 48], n_conditions=12)
    params = jax.tree.map(np.asarray, jax.device_get(layer.init(jax.random.key(2))))
    rng = np.random.default_rng(8)
    y = rng.normal(size=(20, 19)).astype(np.float32)
    h = rng.normal(size=(5, 12)).astype(np.float32)
    port = AffineCoupling(input_size=19, nested_sizes=[48, 48, 48], n_conditions=12)
    tp = params_from_numpy(params, "cpu")
    args = mlp_params_to_kernel_args(tp["a"], port.d_a)
    h_proj = port.cond_proj(tp, torch.from_numpy(h))["a"][0]
    return layer, params, port, args, h_proj, y, h


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_k4_in_3xtf32_matches_jax_kernel(coupling_case, inverse):
    """K4's arithmetic (every product in 3xTF32) against JAX's
    `fused_affine_coupling` in interpret mode on the rows' own projections:
    z_b and logdet, or y_b, at the JAX kernel's bar (atol 1e-4)."""
    layer, params, port, args, h_proj, y, h = coupling_case
    jp = jax.tree.map(jnp.asarray, params)
    rows = np.arange(y.shape[0]) % h.shape[0]
    proj = layer.cond_proj(jp, jnp.asarray(h[rows]))["a"][0]
    with jax.default_matmul_precision("highest"):
        ref = jax_fused_affine_coupling(jnp.asarray(y[:, : layer.d_a]), jnp.asarray(y[:, layer.d_a:]), proj,
                                        inverse=inverse, interpret=True, **jax_coupling_args(jp["a"], layer.d_a))
    ours = fused_affine_coupling_reference(torch.from_numpy(y[:, : port.d_a]), torch.from_numpy(y[:, port.d_a:]),
                                           h_proj, **args, inverse=inverse, n_cond=h.shape[0], mm=matmul_3xtf32)
    for g, r in zip((ours,) if inverse else ours, (ref,) if inverse else ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=FLOW_FWD_ATOL, rtol=0)


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("mm", [torch.matmul, matmul_3xtf32], ids=["float32", "3xtf32"])
def test_k4_is_k1_at_one_step(coupling_case, inverse, mm):
    """K1's plain version on K4's arguments stacked at one step
    (`coupling_flow_args`, the final coupling's slot: no ActNorm, no mix)
    gives K4's plain version, in either arithmetic."""
    _, _, port, args, h_proj, y, h = coupling_case
    x = torch.from_numpy(y)
    flow_args = coupling_flow_args(h_proj, **args)
    assert flow_args["h_proj"].shape == (1, h.shape[0], 64) and flow_args["wm"].shape == (1, 2, 64, 64)
    k1 = fused_flow_reference(x, **flow_args, inverse=inverse, n_cond=h.shape[0], mm=mm)
    k4 = fused_affine_coupling_reference(x[:, : port.d_a], x[:, port.d_a:], h_proj, **args, inverse=inverse,
                                         n_cond=h.shape[0], mm=mm)
    y1 = k1 if inverse else k1[0]
    torch.testing.assert_close(y1[:, : port.d_a], x[:, : port.d_a], atol=0, rtol=0)
    torch.testing.assert_close(y1[:, port.d_a:], k4 if inverse else k4[0], atol=1e-6, rtol=0)
    if not inverse:
        torch.testing.assert_close(k1[1], k4[1], atol=1e-6, rtol=0)


def _unstage(staged: torch.Tensor, Hp: int, rank: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Read `prepare_weights`' layout back as block `rank` of a 3xTF32
    cluster of the `wgmma` inverse reads it: a stage of K k-steps (K =
    `kWgStageK`), one bulk copy of K 8 Hp floats, sits (2 j + rank) K 8 Hp
    floats into the layer for its stage j; its k-step u (input rows
    8 (j K + u) ..) u 8 Hp floats on; there output n' = 8 ng + r of the
    block's columns rank Hp/2 .. and input 8 s + 4 kg + c sit at float
    64 ng + 32 kg + 4 r + c of hi, lo 4 Hp floats on (core matrices of 8 x 4,
    32 floats, the two along the inputs side by side: the descriptor's
    128-byte leading and 256-byte stride offsets; csrc/flow_wgmma.cu).
    Returns (hi, lo) as (S, nh, in, the block's Hp/2 outputs)."""
    S, nh, K = staged.shape[0], staged.shape[1], staged.shape[4]
    flat = staged.reshape(S, nh, -1)
    k, n = np.meshgrid(np.arange(Hp), np.arange(Hp // 2), indexing="ij")
    s, kk = np.divmod(k, 8)
    j, u = np.divmod(s, K)
    kg, c = np.divmod(kk, 4)
    ng, r = np.divmod(n, 8)
    at = torch.from_numpy((2 * j + rank) * K * 8 * Hp + u * 8 * Hp + 64 * ng + 32 * kg + 4 * r + c)
    return flat[:, :, at], flat[:, :, at + 4 * Hp]


@pytest.mark.parametrize("S,nh,Hp,rank", [(2, 3, 32, 0), (1, 2, 64, 1), (2, 0, 32, 0), (1, 2, 32, 0), (1, 2, 32, 1),
                                          (1, 1, 512, 0), (1, 1, 512, 1), (1, 1, 544, 0), (1, 1, 544, 1)],
                         ids=["three_layers", "one_step", "no_hidden", "hp32_rank0", "hp32_rank1", "hp512_rank0",
                              "hp512_rank1", "hp544_rank0", "hp544_rank1"])
@pytest.mark.parametrize("stage_k", [None, 1], ids=["stage_k_source", "stage_k1"])
def test_prepare_weights_splits_and_lays_out_stages(S, nh, Hp, rank, stage_k):
    """The `wgmma` inverse's weights in 3xTF32: hi + lo is w bit for bit; hi
    is the rounded TF32 of `split_tf32`, lo truncated as the tensor cores read
    it is its lo; each block's stages read back to its columns of wm; 8 Hp
    floats a block's part of a k-step, 16 Hp a k-step; a stage of the
    kernel's k-steps (`kWgStageK`, read from the source) or of 1."""
    rng = np.random.default_rng(9)
    wm = torch.from_numpy((rng.normal(size=(S, nh, Hp, Hp)) * 10.0 ** rng.integers(-3, 3, size=(S, nh, Hp, Hp)))
                          .astype(np.float32))
    staged = prepare_weights(wm, stage_k=stage_k)
    K = kernel_limit("kWgStageK") if stage_k is None else stage_k
    assert staged.shape == (S, nh, Hp // 8 // K, 2, K, 2, Hp // 16, 2, 8, 4) and staged.is_contiguous()
    if nh == 0:
        return
    assert staged[0, 0, 0].numel() == 16 * Hp * K and staged[0, 0, 0, rank, 0].numel() == 8 * Hp
    hi, lo = _unstage(staged, Hp, rank)
    cols = slice(rank * Hp // 2, (rank + 1) * Hp // 2)
    assert torch.equal(hi + lo, wm[..., cols])
    ref_hi, ref_lo = split_tf32(wm[..., cols])
    assert torch.equal(hi, ref_hi) and torch.equal(truncate_tf32(lo), ref_lo)


@pytest.mark.parametrize("strict", [False, True], ids=["3xtf32", "strict"])
@pytest.mark.parametrize("H", [16, 100, 526, 700, 1000])
def test_k1_routes_by_mode_and_width(H, strict):
    """Strict runs the float32 FMA kernel both ways; the default mode runs
    the inverse on `wgmma` and the forward on the 3xTF32 `wgmma` forward up
    to the padded width 544, above it the inverse on the wide `wgmma`
    inverse and the forward on the wide `wgmma` forward (flagship shape:
    size 19)."""
    from bcnf_tpu_torch.ops.flow_kernel import padded_width

    Hp = padded_width(H)
    routes = {inv: flow_route(Hp, 19, 10, inv, "fma" if strict else "3xtf32") for inv in (True, False)}
    if strict:
        assert routes == {True: ROUTE_FMA, False: ROUTE_FMA}
    else:
        assert routes == {True: ROUTE_WGMMA if Hp <= 544 else ROUTE_WIDE,
                          False: ROUTE_FWD_WGMMA if Hp <= 544 else ROUTE_WIDE_FWD}


def test_k1_routes_follow_shared_memory():
    """At Hp 544 the `wgmma` inverse holds the rows' state up to size 29; a
    larger size takes the row tiles, which hold up to ~80; past them no
    3xTF32 kernel takes the shape and the model's gate closes, while the
    strict FMA kernel still takes it. The sums are those the launchers check:
    the 3xTF32 `wgmma` inverse's tile, its ring (4 k-steps of 8 Hp floats:
    a block's half of hi and lo), the rows' state, 2 barriers a ring stage
    and 2 hand-off barriers."""
    ring = kernel_limit("kWgRing3xTf32")
    assert ring * kernel_limit("kWgStageK") == 4
    assert kernel_smem(ROUTE_WGMMA, 544, 19, 10) == 4 * (64 * 548 + 4 * 8 * 544 + 64 * (38 + 18)) + 8 * (2 * ring + 2)
    assert flow_route(544, 29, 15, True, "3xtf32") == ROUTE_WGMMA
    assert flow_route(544, 30, 15, True, "3xtf32") == ROUTE_ROWS
    assert flow_route(544, 90, 45, True, "3xtf32") is None and flow_route(544, 90, 45, False, "3xtf32") is None
    assert flow_route(544, 90, 45, True, "fma") == ROUTE_FMA
    assert flow_route(96, 19, 10, True, "3xtf32") is None  # not a compiled width
    from bcnf_tpu_torch.models import CondRealNVP

    kw = dict(n_blocks=3, n_conditions=4, feature_network_stack=None)
    assert CondRealNVP(size=19, nested_sizes=[526, 526], **kw)._fused_flow_takes()
    assert not CondRealNVP(size=90, nested_sizes=[526, 526], **kw)._fused_flow_takes()
    assert CondRealNVP(size=90, nested_sizes=[526, 526], pallas_strict=True, **kw)._fused_flow_takes()
    assert not CondRealNVP(size=19, nested_sizes=[1100, 1100], **kw)._fused_flow_takes()


@pytest.mark.parametrize("Hp", [32 * tn for tn in (1, 2, 4, 8, 12, 16, 17)])
def test_wgmma_ring_and_shared_memory_at_the_cluster_constants(Hp):
    """`wgmma_ring` reads each build's ring and cluster from
    csrc/flow_wgmma.cu: in 3xTF32 clusters of 2 blocks that split the
    columns. A block streams hi and lo of its Hp/2 columns, 8 Hp floats a
    k-step (17,408 bytes at Hp 544), `kWgStageK` k-steps a stage, so the ring
    holds 4 k-steps in the bytes that held 2 whole ones; `kernel_smem` is the
    launcher's sum, within a block's shared memory at every width the kernel
    is built for."""
    stages, k = kernel_limit("kWgRing3xTf32"), kernel_limit("kWgStageK")
    assert wgmma_ring(ROUTE_WGMMA) == (stages, kernel_limit("kWgCluster3xTf32")) and wgmma_ring(ROUTE_WGMMA)[1] == 2
    assert 4 * 8 * 544 == 17_408 and stages * k == 4
    ring = 4 * stages * k * 8 * Hp
    assert ring == 4 * (2 * 16 * Hp)
    assert kernel_smem(ROUTE_WGMMA, Hp, 19, 10) == 4 * 64 * (Hp + 4) + ring + 4 * 64 * (38 + 18) + 8 * (2 * stages + 2)
    assert kernel_smem(ROUTE_WGMMA, Hp, 19, 10) <= kernel_limit("kSmemLimit")
    assert flow_route(Hp, 19, 10, True, "3xtf32") == ROUTE_WGMMA


@pytest.mark.parametrize("B", [1, 63, 64, 65, 128, 257, 4099, 80_000, 100_000])
def test_wgmma_grid_rounds_to_whole_clusters(B):
    """The `wgmma` inverse's grid in whole clusters (csrc/flow_wgmma.cu:
    `launch`): in 3xTF32 a cluster of two blocks a 64-row tile, both on its
    rows, so no block runs on masked rows alone; in one pass a block a tile,
    the tiles rounded up to whole clusters of two (at an odd count of tiles a
    block runs on masked rows only)."""
    import re
    from pathlib import Path

    tiles = -(-B // 64)
    assert wgmma_grid(ROUTE_WGMMA, B) == 2 * tiles
    assert wgmma_grid(ROUTE_WGMMA_TF32, B) == tiles + tiles % 2
    with pytest.raises(ValueError):
        wgmma_grid(ROUTE_ROWS, B)
    source = (Path(flow_kernel.__file__).parent / "csrc" / "flow_wgmma.cu").read_text()
    assert re.search(r"const int clusters = kPasses == 3 \? tiles : \(tiles \+ kWgCluster - 1\) / kWgCluster;", source)
    assert "cfg.gridDim = dim3(static_cast<unsigned>(clusters * kWgCluster));" in source


@pytest.mark.parametrize("strict", [False, True], ids=["3xtf32", "strict"])
def test_model_passes_its_mode_to_k1(strict, monkeypatch):
    """`sample` and the no-grad forward hand `pallas_strict` to K1 (the gate
    opened on CPU tensors, which stand for a CUDA tensor with no grad); on
    the CPU K1's wrapper is the plain version in either mode."""
    from bcnf_tpu_torch.models import CondRealNVP, ConcatenateCondition, FeatureNetworkStack
    from bcnf_tpu_torch.models import FullyConnectedFeatureNetwork

    stack = FeatureNetworkStack([ConcatenateCondition(input_size=None, output_size=6),
                                 FullyConnectedFeatureNetwork(sizes=[6, 32, N_COND_FEATURES])])
    model = CondRealNVP(size=SIZE, nested_sizes=[32] * 3, n_blocks=N_BLOCKS, n_conditions=N_COND_FEATURES,
                        feature_network_stack=stack, act_norm=True, random_state=0, pallas_strict=strict)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    seen = []

    def recording(*a, mode="3xtf32", **k):
        seen.append(mode == "fma")
        return flow_kernel.fused_flow_reference(*a, **k)

    monkeypatch.setattr(flow_kernel, "fused_flow", recording)
    monkeypatch.setattr(CondRealNVP, "_use_fused", lambda self, train, x, *trees: not train)
    cond = torch.from_numpy(np.random.default_rng(10).normal(size=(3, 6)).astype(np.float32))
    y = model.sample(params, torch.Generator().manual_seed(1), 4, cond, device="cpu")
    model.forward(params, y[0], cond)
    assert seen == [strict, strict]


@pytest.mark.parametrize("k,chunk", [(64, 64), (100, 32), (0, 8)], ids=["one_chunk", "ragged_chunks", "no_rows"])
def test_atb_on_cpu_is_its_plain_version_by_chunk(k, chunk):
    """The AᵀB pass's contract, on CPU tensors (its plain version): one
    partial product and column sum a chunk of rows, at least one."""
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.normal(size=(k, 5)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(k, 3)).astype(np.float32))
    before = atb.launches
    c, sums = atb(a, b, chunk)
    assert atb.launches == before
    assert c.shape == (max(1, -(-k // chunk)), 5, 3) and sums.shape == (c.shape[0], 3)
    torch.testing.assert_close(c.sum(0), a.T @ b, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(sums.sum(0), b.sum(0), atol=1e-5, rtol=1e-5)
    for got, ref in zip((c, sums), atb_reference(a, b, chunk)):
        assert torch.equal(got, ref)


def test_main_path_does_not_import_the_tf32_model():
    """`ops/tf32.py` is for the tests: no module of the port's main path
    imports it."""
    code = (
        "import sys\n"
        "import bcnf_tpu_torch, bcnf_tpu_torch.__main__\n"
        "import bcnf_tpu_torch.ops.flow_kernel, bcnf_tpu_torch.ops.lstm_kernel, bcnf_tpu_torch.ops.atb\n"
        "import bcnf_tpu_torch.ops.coupling_kernel, bcnf_tpu_torch.train.trainer\n"
        "assert 'bcnf_tpu_torch.ops.tf32' not in sys.modules\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.fixture(scope="module", params=["x3", "highest"])
def jax_flagship_shape(request):
    """A flow of the flagship's size 19 (d_a 10, n_out 18) and its 4 square
    hidden layers at a narrow width (32), 3 steps, the ActNorm off identity;
    the JAX model's seeded params, one precision per instance."""
    stack = JaxStack([JaxConcat(input_size=None, output_size=6), JaxFC(sizes=[6, 32, N_COND_FEATURES])])
    model = JaxCondRealNVP(size=19, nested_sizes=[32] * 5, n_blocks=3, n_conditions=N_COND_FEATURES,
                           feature_network_stack=stack, act_norm=True, random_state=0)
    params = model.init(jax.random.key(1))
    rng = np.random.default_rng(6)
    blocks = dict(params["blocks"])
    blocks["actnorm"] = {"scale": jnp.asarray((1.0 + 0.2 * rng.normal(size=(2, 19))).astype(np.float32)),
                         "bias": jnp.asarray((0.2 * rng.normal(size=(2, 19))).astype(np.float32))}
    return model, dict(params, blocks=blocks), request.param


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_training_in_3xtf32_at_the_flagship_shape_matches_jax_kernels(jax_flagship_shape, direction):
    """The plain 3xTF32 K2a and K2b (every product `matmul_3xtf32`), which
    the 3xTF32 `wgmma` routes are held against on the card, against JAX's
    training kernels in interpret mode (`_flow_fwd_train_kernel`,
    `_flow_bwd_train_kernel` through the custom VJP) at "highest" and "x3",
    at the flagship's size 19 / d_a 10 with nh 4 at width 32: z and logdet
    at the flow forward bar, all ten grads at the flow grad bar."""
    model, params, precision = jax_flagship_shape
    B = 16
    rng = np.random.default_rng(8)
    h = jnp.asarray(rng.normal(size=(B, N_COND_FEATURES)).astype(np.float32))
    kargs, h_proj = model._fused_flow_args(params, h)
    assert np.asarray(kargs["w1y"]).shape[1] == 10 and np.asarray(kargs["wm"]).shape[1] == 4
    y = jnp.asarray(rng.normal(size=(B, 19)).astype(np.float32))
    args = [torch.from_numpy(np.array(kargs[n])) for n in ARG_NAMES]
    hp = torch.from_numpy(np.array(h_proj))
    yt = torch.from_numpy(np.array(y))

    def f(y, h_proj, kargs):
        return jax_fused_flow_train(y, h_proj, kargs, block_b=8, precision=precision, interpret=True)

    if direction == "forward":
        z_ref, ld_ref = f(y, h_proj, kargs)
        z, ld, _ = fused_flow_train_reference(yt, hp, *args, mm=matmul_3xtf32)
        np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=FLOW_FWD_ATOL, rtol=0, err_msg="z")
        np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref), atol=FLOW_FWD_ATOL, rtol=0, err_msg="logdet")
        return
    dz = rng.normal(size=(B, 19)).astype(np.float32)
    dld = rng.normal(size=(B,)).astype(np.float32)
    _, vjp = jax.vjp(f, y, h_proj, kargs)
    dy_ref, dhp_ref, dk_ref = vjp((jnp.asarray(dz), jnp.asarray(dld)))
    refs = (dy_ref, dhp_ref, *(dk_ref[n] for n in GRAD_NAMES[2:]))
    _, _, bound = fused_flow_train_reference(yt, hp, *args)
    got = fused_flow_train_backward_reference(bound, hp, torch.from_numpy(dz), torch.from_numpy(dld), *args,
                                              mm=matmul_3xtf32)
    for name, g, r in zip(GRAD_NAMES, got, refs):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=FLOW_ATOL, rtol=FLOW_RTOL, err_msg=name)
