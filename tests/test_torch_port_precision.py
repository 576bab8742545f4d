"""Port parity, the reduced matmul precisions: one TF32 pass in K1, K2a, K2b and K4.

The JAX model maps "default", "bfloat16" and "BF16_BF16_F32_X3" to its
kernels' reduced "default" mode (`bcnf_tpu/models/cnf.py:951-973`); the port
runs those kernels in one TF32 pass a product (`csrc/mma_tf32.cuh:
mma_passes<1>`), modelled in plain PyTorch by `ops/tf32.py::matmul_tf32`.
Here the plain one-pass versions of K1 (both directions), K2a, K2b and K4
are held against JAX's Pallas kernels in interpret mode at
precision="default" at JAX's own bar for its reduced mode, 5e-3 max |d|
(tests/test_flow_kernel.py:130-141; on the CPU JAX's "default" is float32),
and shown to differ measurably from float32, so the mode is not a no-op.
Also: the precision table (which strings open which gate, which raise),
`matmul_precision` restoring both TF32 flags, the CPU computing float32 at
every precision, `training.precision` reaching the model and its steps
(forward and backward), and `eval --precision` leaving the test NLL bit for
bit while the sampling stages run at the new precision. The kernels
themselves are held against these plain versions on the card
(`chip_smoke.py` phase 15).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from bcnf_tpu.models import CondRealNVP as JaxCondRealNVP
from bcnf_tpu.models import ConcatenateCondition as JaxConcat
from bcnf_tpu.models import FeatureNetworkStack as JaxStack
from bcnf_tpu.models import FullyConnectedFeatureNetwork as JaxFC
from bcnf_tpu.models.cnf import AffineCoupling as JaxAffineCoupling
from bcnf_tpu.ops.coupling_kernel import fused_affine_coupling as jax_fused_affine_coupling
from bcnf_tpu.ops.coupling_kernel import mlp_params_to_kernel_args as jax_coupling_args
from bcnf_tpu.ops.flow_kernel import fused_flow as jax_fused_flow
from bcnf_tpu.ops.flow_kernel import fused_flow_train as jax_fused_flow_train
from bcnf_tpu_torch.__main__ import main
from bcnf_tpu_torch.bridge import params_from_numpy
from bcnf_tpu_torch.models import CondRealNVP, ConcatenateCondition, FeatureNetworkStack
from bcnf_tpu_torch.models import FullyConnectedFeatureNetwork
from bcnf_tpu_torch.models.cnf import FUSED_PRECISION_MODES, PRECISIONS, AffineCoupling, matmul_precision
from bcnf_tpu_torch.ops import flow_kernel
from bcnf_tpu_torch.ops.coupling_kernel import (
    fused_affine_coupling,
    fused_affine_coupling_reference,
    mlp_params_to_kernel_args,
)
from bcnf_tpu_torch.ops.flow_kernel import (
    MODE_3XTF32,
    MODE_FMA,
    MODE_TF32,
    ROUTE_ROWS_TF32,
    ROUTE_WGMMA,
    ROUTE_WGMMA_TF32,
    flow_route,
    fused_flow,
    fused_flow_reference,
    fused_flow_train,
    fused_flow_train_backward_reference,
    fused_flow_train_reference,
    kernel_smem,
    prepare_weights,
)
from bcnf_tpu_torch.ops.tf32 import matmul_tf32, round_tf32
from bcnf_tpu_torch.train.trainer import Trainer

REDUCED_BAR = 5e-3  # max |d| of JAX's reduced kernel mode against float32 (tests/test_flow_kernel.py:130-141)
# one TF32 pass must move the plain version from float32 by at least this
# much (relative to the output's scale; ~8 float32 ulps) and by at least 10x
# the float32 plain version's own distance from JAX
MIN_TF32_SHIFT = 1e-6
SIZE, N_COND_FEATURES, N_BLOCKS = 7, 16, 4
ARG_NAMES = ("an_scale", "an_bias", "ortho", "w1y", "b1", "wm", "bm", "wout", "bout")
GRAD_NAMES = ("x", "h_proj", "an_scale", "an_bias", "w1y", "b1", "wm", "bm", "wout", "bout")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, dtype=np.float64) - np.asarray(b, dtype=np.float64))))


def _check_reduced(ours_tf32, ours_f32, ref, name: str, scale: float = 1.0) -> None:
    """The one-pass plain version within the reduced bar of JAX's kernel at
    "default" (bar scaled by `scale` for grads), and measurably off float32."""
    err = _max_abs(ours_tf32, ref)
    assert err <= REDUCED_BAR * scale, f"{name}: one pass vs JAX default {err:.3e}"
    shift, base = _max_abs(ours_tf32, ours_f32), _max_abs(ours_f32, ref)
    assert shift >= max(MIN_TF32_SHIFT * scale, 10 * base), f"{name}: one pass moved {shift:.3e} (float32 {base:.3e})"


@pytest.fixture(scope="module", params=[32, 64], ids=["hidden32", "hidden64"])
def jax_flow(request):
    hidden = request.param
    stack = JaxStack([JaxConcat(input_size=None, output_size=6), JaxFC(sizes=[6, 32, N_COND_FEATURES])])
    model = JaxCondRealNVP(size=SIZE, nested_sizes=[hidden] * 3, n_blocks=N_BLOCKS, n_conditions=N_COND_FEATURES,
                           feature_network_stack=stack, act_norm=True, random_state=0)
    params = model.init(jax.random.key(0))
    rng = np.random.default_rng(4)
    blocks = dict(params["blocks"])
    blocks["actnorm"] = {  # off identity, so the ActNorm and its grads are exercised
        "scale": jnp.asarray((1.0 + 0.2 * rng.normal(size=(N_BLOCKS - 1, SIZE))).astype(np.float32)),
        "bias": jnp.asarray((0.2 * rng.normal(size=(N_BLOCKS - 1, SIZE))).astype(np.float32)),
    }
    return model, dict(params, blocks=blocks)


def _case(model, params, n_cond: int, B: int, seed: int):
    rng = np.random.default_rng(seed)
    h = jnp.asarray(rng.normal(size=(n_cond, N_COND_FEATURES)).astype(np.float32))
    kargs, h_proj = model._fused_flow_args(params, h)
    x = rng.normal(size=(B, SIZE)).astype(np.float32)
    return kargs, h_proj, x, rng


@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
def test_k1_one_pass_matches_jax_default_mode(jax_flow, inverse):
    """K1's one-pass arithmetic (every MLP product through `matmul_tf32`)
    against JAX's `fused_flow` at precision="default" in interpret mode, 4
    conditions for 16 rows (row r takes r % N)."""
    model, params = jax_flow
    kargs, h_proj, x, _ = _case(model, params, 4, 16, 7)
    ref = jax_fused_flow(jnp.asarray(x), h_proj, **kargs, inverse=inverse, n_cond=4, block_b=8,
                         precision="default", interpret=True)
    args = {k: _t(v) for k, v in dict(kargs, h_proj=h_proj).items()}
    ours = {mm: fused_flow_reference(_t(x), **args, inverse=inverse, n_cond=4, mm=mm)
            for mm in (matmul_tf32, torch.matmul)}
    names = ("y",) if inverse else ("z", "logdet")
    for i, name in enumerate(names):
        pick = (lambda o: o) if inverse else (lambda o: o[i])
        _check_reduced(pick(ours[matmul_tf32]).numpy(), pick(ours[torch.matmul]).numpy(),
                       ref if inverse else ref[i], name)


def test_k2a_one_pass_matches_jax_default_mode(jax_flow):
    """K2a's one-pass arithmetic against JAX's training forward at
    precision="default" (rows with their own conditions): z and logdet."""
    model, params = jax_flow
    kargs, h_proj, y, _ = _case(model, params, 16, 16, 5)
    z_ref, ld_ref = jax_fused_flow_train(jnp.asarray(y), h_proj, kargs, block_b=8, precision="default",
                                         interpret=True)
    args = [_t(kargs[n]) for n in ARG_NAMES]
    outs = {mm: fused_flow_train_reference(_t(y), _t(h_proj), *args, mm=mm) for mm in (matmul_tf32, torch.matmul)}
    _check_reduced(outs[matmul_tf32][0].numpy(), outs[torch.matmul][0].numpy(), z_ref, "z")
    _check_reduced(outs[matmul_tf32][1].numpy(), outs[torch.matmul][1].numpy(), ld_ref, "logdet")


def test_k2b_one_pass_matches_jax_default_mode(jax_flow):
    """K2b's one-pass arithmetic against JAX's training kernels at
    precision="default" (`_flow_bwd_train_kernel` through the custom VJP):
    all ten grads, each at the reduced bar times its largest magnitude
    (grads are not of unit scale)."""
    model, params = jax_flow
    kargs, h_proj, y, rng = _case(model, params, 16, 16, 5)
    dz = rng.normal(size=(16, SIZE)).astype(np.float32)
    dld = rng.normal(size=(16,)).astype(np.float32)

    def f(y, h_proj, kargs):
        return jax_fused_flow_train(y, h_proj, kargs, block_b=8, precision="default", interpret=True)

    _, vjp = jax.vjp(f, jnp.asarray(y), h_proj, kargs)
    dy_ref, dhp_ref, dk_ref = vjp((jnp.asarray(dz), jnp.asarray(dld)))
    refs = (dy_ref, dhp_ref, *(dk_ref[n] for n in GRAD_NAMES[2:]))
    args = [_t(kargs[n]) for n in ARG_NAMES]
    hp = _t(h_proj)
    _, _, bound = fused_flow_train_reference(_t(y), hp, *args)
    got = {mm: fused_flow_train_backward_reference(bound, hp, _t(dz), _t(dld), *args, mm=mm)
           for mm in (matmul_tf32, torch.matmul)}
    for i, (name, r) in enumerate(zip(GRAD_NAMES, refs)):
        scale = max(1.0, float(np.max(np.abs(np.asarray(r)))))
        if name in ("an_scale", "an_bias"):  # the final step's slot is zero in both; the rest is checked
            r = np.asarray(r)[:-1]
            _check_reduced(got[matmul_tf32][i][:-1].numpy(), got[torch.matmul][i][:-1].numpy(), r, name, scale)
        else:
            _check_reduced(got[matmul_tf32][i].numpy(), got[torch.matmul][i].numpy(), r, name, scale)


@pytest.fixture(scope="module")
def coupling_case():
    """A flagship-shaped coupling (size 19) at a small width, 5 conditions for 20 rows."""
    layer = JaxAffineCoupling(input_size=19, nested_sizes=[48, 48, 48], n_conditions=12)
    params = jax.tree.map(np.asarray, jax.device_get(layer.init(jax.random.key(2))))
    rng = np.random.default_rng(8)
    y = rng.normal(size=(20, 19)).astype(np.float32)
    h = rng.normal(size=(5, 12)).astype(np.float32)
    port = AffineCoupling(input_size=19, nested_sizes=[48, 48, 48], n_conditions=12)
    tp = params_from_numpy(params, "cpu")
    return layer, params, port, mlp_params_to_kernel_args(tp["a"], port.d_a), port.cond_proj(
        tp, torch.from_numpy(h))["a"][0], y, h


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_k4_one_pass_matches_jax_default_mode(coupling_case, inverse):
    """K4's one-pass arithmetic against JAX's `fused_affine_coupling` in
    interpret mode, whose dots take the context's precision: "default"."""
    layer, params, port, args, h_proj, y, h = coupling_case
    jp = jax.tree.map(jnp.asarray, params)
    rows = np.arange(y.shape[0]) % h.shape[0]
    with jax.default_matmul_precision("default"):
        proj = layer.cond_proj(jp, jnp.asarray(h[rows]))["a"][0]
        ref = jax_fused_affine_coupling(jnp.asarray(y[:, : layer.d_a]), jnp.asarray(y[:, layer.d_a:]), proj,
                                        inverse=inverse, interpret=True, **jax_coupling_args(jp["a"], layer.d_a))
    ours = {mm: fused_affine_coupling_reference(_t(y[:, : port.d_a]), _t(y[:, port.d_a:]), h_proj, **args,
                                                inverse=inverse, n_cond=h.shape[0], mm=mm)
            for mm in (matmul_tf32, torch.matmul)}
    if inverse:
        _check_reduced(ours[matmul_tf32].numpy(), ours[torch.matmul].numpy(), ref, "y_b")
    else:
        for i, name in enumerate(("z_b", "logdet")):
            _check_reduced(ours[matmul_tf32][i].numpy(), ours[torch.matmul][i].numpy(), ref[i], name)


# ---------------------------------------------------------------------------
# the mode table, the context manager and the wrappers' modes
# ---------------------------------------------------------------------------


def _model(**kw) -> CondRealNVP:
    stack = FeatureNetworkStack([ConcatenateCondition(input_size=None, output_size=6),
                                 FullyConnectedFeatureNetwork(sizes=[6, 32, N_COND_FEATURES])])
    return CondRealNVP(size=SIZE, nested_sizes=[32] * 3, n_blocks=N_BLOCKS, n_conditions=N_COND_FEATURES,
                       feature_network_stack=stack, act_norm=True, random_state=0, **kw)


TABLE = {  # precision -> (K1's mode, K1's mode with pallas_strict, the mode of K2a/K2b with pallas_strict,
    #                        the mode of K4 (with or without pallas_strict), TF32 allowed)
    "highest": (MODE_3XTF32, MODE_FMA, MODE_FMA, MODE_3XTF32, False),
    "float32": (MODE_3XTF32, MODE_FMA, MODE_FMA, MODE_3XTF32, False),
    "default": (MODE_TF32, MODE_TF32, MODE_TF32, MODE_TF32, True),
    "bfloat16": (MODE_TF32, MODE_TF32, MODE_TF32, MODE_TF32, True),
    "BF16_BF16_F32_X3": (MODE_TF32, MODE_TF32, MODE_TF32, MODE_TF32, True),
    "BF16_BF16_F32_X6": (None, None, None, None, False),  # missing from JAX's table: every gate closes
}


@pytest.mark.parametrize("precision", list(TABLE))
def test_precision_table_opens_the_gates_it_names(precision):
    """Which string opens which kernel gate in which mode (JAX's
    `_FUSED_PRECISION_MODES`; strict changes only highest/float32, and there
    K1, K2a and K2b, as JAX's `forward_fused_flow` and `inverse_fused_flow`
    do, not K4, whose JAX kernel takes no strict flag), with the gates'
    structural guards stood in for by a CPU tensor's."""
    k1, k1_strict, train_strict, k4, tf32 = TABLE[precision]
    assert _model(precision=precision).kernel_mode == k1
    assert _model(precision=precision, pallas_strict=True).kernel_mode == k1_strict
    assert _model(precision=precision).train_kernel_mode == k1
    assert _model(precision=precision, pallas_strict=True).train_kernel_mode == train_strict
    assert _model(precision=precision).coupling_kernel_mode == k4
    assert _model(precision=precision, pallas_strict=True).coupling_kernel_mode == k4
    assert FUSED_PRECISION_MODES.get(precision) == k4 and precision in PRECISIONS
    with matmul_precision(precision):
        assert torch.backends.cuda.matmul.allow_tf32 is tf32 and torch.backends.cudnn.allow_tf32 is tf32
    assert _model(precision=precision)._fused_flow_takes()  # the shape every mode's kernels take


@pytest.mark.parametrize("precision", ["tensorfloat32", "fastest", "F32_F32_F32", "HIGHEST", ""])
def test_unknown_precision_strings_raise(precision):
    """Any other string raises ValueError naming the accepted ones: the port
    cannot mirror an XLA algorithm it does not know."""
    with pytest.raises(ValueError, match="BF16_BF16_F32_X6"):
        _model(precision=precision)
    model = _model()
    with pytest.raises(ValueError, match="highest"):
        model.precision = precision
    assert model.precision == "highest"
    with pytest.raises(ValueError):
        with matmul_precision(precision):
            pass


@pytest.mark.parametrize("outer", [(False, False), (True, True), (True, False)], ids=["off", "on", "mixed"])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_matmul_precision_restores_both_flags_also_on_an_exception(outer, precision):
    cuda_flag, cudnn_flag = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = outer
        with matmul_precision(precision):
            with matmul_precision("highest"):  # nested: the inner one restores the outer one's
                assert not torch.backends.cuda.matmul.allow_tf32
            assert torch.backends.cuda.matmul.allow_tf32 is (precision == "default")
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == outer
        with pytest.raises(RuntimeError, match="inside"):
            with matmul_precision(precision):
                raise RuntimeError("inside")
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == outer
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = cuda_flag, cudnn_flag


def test_cpu_computes_float32_at_every_precision():
    """As JAX on the CPU: the model's forward, inverse and sample on CPU
    tensors give the same bits at every precision the port takes."""
    rng = np.random.default_rng(11)
    cond = torch.from_numpy(rng.normal(size=(3, 6)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(3, SIZE)).astype(np.float32))
    base = _model()
    params = base.init(torch.Generator().manual_seed(0), device="cpu")
    want = (base.forward(params, y, cond), base.sample(params, torch.Generator().manual_seed(1), 4, cond,
                                                       device="cpu"))
    for precision in PRECISIONS:
        m = _model(precision=precision)
        got = (m.forward(params, y, cond), m.sample(params, torch.Generator().manual_seed(1), 4, cond, device="cpu"))
        for a, b in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)):
            assert torch.equal(a, b), precision


def test_prepare_weights_one_pass_stages_hold_hi_alone():
    """The one-pass `wgmma` inverse's weight stages: the 3xTF32 layout's hi
    halves of both cluster ranks side by side, nothing else (half the bytes a
    stage); the one-pass layout is the one it has always been: stage s of
    w^T, output groups in order, in `wgmma`'s core-matrix order."""
    rng = np.random.default_rng(9)
    wm = torch.from_numpy(rng.normal(size=(2, 3, 64, 64)).astype(np.float32))
    three, one = prepare_weights(wm), prepare_weights(wm, passes=1)
    assert one.shape == (2, 3, 8, 1, 8, 2, 8, 4) and one.is_contiguous()
    # three: (S, nh, stage j, rank, k-step u, [hi, lo], ng', kg, r, c); the k-step is K j + u, ng = 4 rank + ng'
    hi3 = three[:, :, :, :, :, 0].transpose(3, 4).reshape(2, 3, 8, 8, 2, 8, 4)
    assert torch.equal(one[:, :, :, 0], hi3)
    # w^T[n, k], n = 8 ng + r, k = 8 s + 4 kg + c, at one[..., s, 0, ng, kg, r, c]
    wt = wm.transpose(-1, -2).reshape(2, 3, 8, 8, 8, 2, 4).permute(0, 1, 4, 2, 5, 3, 6)
    assert torch.equal(one[:, :, :, 0], round_tf32(wt.contiguous()))
    with pytest.raises(ValueError):
        prepare_weights(wm, passes=2)


@pytest.mark.parametrize("H", [16, 526, 700])
def test_one_pass_routes_and_shared_memory(H):
    """The one-pass mode takes the routes of the default mode, built with one
    pass: the inverse on `wgmma` up to Hp 544, the row tiles above; its
    forward the one-pass `wgmma` forward up to Hp 544 and the row tiles
    above; its `wgmma` stages are half as large (hi alone), and its ring
    holds as many in the same bytes as the 3xTF32 ring, whose stages are a
    block's half of hi and lo (`wgmma_ring`)."""
    from bcnf_tpu_torch.ops.flow_kernel import ROUTE_FWD_WGMMA_TF32, padded_width, wgmma_ring

    Hp = padded_width(H)
    assert flow_route(Hp, 19, 10, True, MODE_TF32) == (ROUTE_WGMMA_TF32 if Hp <= 544 else ROUTE_ROWS_TF32)
    assert flow_route(Hp, 19, 10, False, MODE_TF32) == (ROUTE_FWD_WGMMA_TF32 if Hp <= 544 else ROUTE_ROWS_TF32)
    if Hp <= 544:
        (ring3, _), (ring1, _) = wgmma_ring(ROUTE_WGMMA), wgmma_ring(ROUTE_WGMMA_TF32)
        k = flow_kernel.kernel_limit("kWgStageK")
        assert ring1 == ring3 * k
        stages = 4 * 8 * Hp * ring3 * k - 4 * 8 * Hp * ring1  # the rings' bytes: equal
        barriers = 16 * (ring3 - ring1) + 8 * 2  # and the 3xTF32 cluster's two hand-off barriers
        assert kernel_smem(ROUTE_WGMMA, Hp, 19, 10) - kernel_smem(ROUTE_WGMMA_TF32, Hp, 19, 10) == stages + barriers
    with pytest.raises(ValueError, match="kernel mode"):
        flow_route(Hp, 19, 10, True, "x3")


def _wg_smem(Hp: int, size: int, d_a: int, passes: int, stages: int) -> int:
    """`wg_smem` of csrc/flow_wgmma.cu, term for term: the tile, the ring's
    stages (8 Hp floats a k-step: one pass hi of every column, a k-step a
    stage; 3xTF32 hi and lo of a block's half, `kWgStageK` k-steps a stage),
    the rows' state, the mix's output and [t | s'], then two 8-byte barriers
    a stage and, in 3xTF32, the cluster's two hand-off barriers."""
    stage = 8 * Hp * (flow_kernel.kernel_limit("kWgStageK") if passes == 3 else 1)
    return (4 * (64 * (Hp + 4) + stages * stage + 64 * (2 * size + 2 * (size - d_a)))
            + (2 * stages + (2 if passes == 3 else 0)) * 8)


@pytest.mark.parametrize("route,passes", [(ROUTE_WGMMA, 3), (ROUTE_WGMMA_TF32, 1)])
def test_wgmma_smem_is_the_sum_the_kernel_computes(route, passes):
    """`kernel_smem` of a `wgmma` route is `wg_smem`'s sum with the ring's
    stage count read from csrc/flow_wgmma.cu (`kWgStages` is defined from the
    two constants `wgmma_ring` reads, and `wg_smem` and the kernel size the
    ring by it), at every width the kernel is built for; past the block's
    shared memory `flow_route` takes the row tiles, then no kernel."""
    import re
    from pathlib import Path

    from bcnf_tpu_torch.ops.flow_kernel import KERNEL_TN, WGMMA_MAX_TN, kernel_limit, wgmma_ring

    source = (Path(flow_kernel.__file__).parent / "csrc" / "flow_wgmma.cu").read_text()
    assert re.search(r"constexpr int kWgStages = kPasses == 3 \? kWgRing3xTf32 : kWgRingTf32;", source)
    body = source[source.index("size_t wg_smem("):]
    assert "kWgStages) * stage" in body[: body.index("}")]
    assert "(2 * kWgStages + (kPasses == 3 ? kWgXchBarriers : 0)) * sizeof(uint64_t)" in body[: body.index("}")]
    stages, cluster = wgmma_ring(route)
    assert stages == kernel_limit("kWgRing3xTf32" if passes == 3 else "kWgRingTf32")
    assert cluster == kernel_limit("kWgCluster3xTf32" if passes == 3 else "kWgClusterTf32")
    assert kernel_limit("kWgXchBarriers") == 2
    for tn in (t for t in KERNEL_TN if t <= WGMMA_MAX_TN):
        for size, d_a in ((19, 9), (7, 3), (29, 15)):
            assert kernel_smem(route, 32 * tn, size, d_a) == _wg_smem(32 * tn, size, d_a, passes, stages)
    mode = MODE_3XTF32 if passes == 3 else MODE_TF32
    fits = [size for size in range(2, 120) if kernel_smem(route, 544, size, size // 2) <= kernel_limit("kSmemLimit")]
    last = max(fits)
    assert flow_route(544, last, last // 2, True, mode) == route
    assert flow_route(544, last + 1, (last + 1) // 2, True, mode) != route
    assert flow_route(544, 200, 100, True, mode) is None


def test_wrappers_take_the_mode_and_run_float32_on_the_cpu():
    """On CPU tensors every wrapper is its plain version in float32, in any
    mode, the training pair's strict one too; a mode a kernel does not have
    (K4's float32 FMA, any unknown string) raises."""
    rng = np.random.default_rng(12)
    model = _model()
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    h = model.encode(params, (torch.from_numpy(rng.normal(size=(8, 6)).astype(np.float32)),))
    kargs, h_proj = model._fused_flow_args(params, h)
    x = torch.from_numpy(rng.normal(size=(8, SIZE)).astype(np.float32))
    want = fused_flow_reference(x, h_proj, **kargs, inverse=True, n_cond=8)
    for mode in (MODE_3XTF32, MODE_TF32, MODE_FMA):
        assert torch.equal(fused_flow(x, h_proj, **kargs, inverse=True, n_cond=8, mode=mode), want)
    with pytest.raises(ValueError, match="kernel mode"):
        fused_flow(x, h_proj, **kargs, inverse=True, n_cond=8, mode="default")
    z_a, z_b = fused_flow_train(x, h_proj, **kargs, mode=MODE_TF32)
    z_r, ld_r, _ = fused_flow_train_reference(x, h_proj, *[kargs[n] for n in ARG_NAMES])
    assert torch.equal(z_a, z_r) and torch.equal(z_b, ld_r)
    z_a, z_b = fused_flow_train(x, h_proj, **kargs, mode=MODE_FMA)
    assert torch.equal(z_a, z_r) and torch.equal(z_b, ld_r)
    with pytest.raises(ValueError, match="kernel mode"):
        fused_flow_train(x, h_proj, **kargs, mode="default")
    args = mlp_params_to_kernel_args(params["final"]["a"], model.coupling.d_a)
    proj = model.coupling.cond_proj(params["final"], h)["a"][0]
    with pytest.raises(ValueError, match="kernel mode"):
        fused_affine_coupling(x[:, :4], x[:, 4:], proj, **args, mode=MODE_FMA)


@pytest.mark.parametrize("precision", ["default", "highest", "BF16_BF16_F32_X6"])
def test_model_hands_its_precision_mode_to_the_kernels(precision, monkeypatch):
    """`sample` and the no-grad forward hand K1 the mode of the table (the
    gate opened on CPU tensors), the per-coupling path hands it to K4, and
    the gate stays closed for X6."""
    model = _model(precision=precision)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    seen = []

    def recording(*a, mode=MODE_3XTF32, **k):
        seen.append(mode)
        return flow_kernel.fused_flow_reference(*a, **k)

    monkeypatch.setattr(flow_kernel, "fused_flow", recording)
    monkeypatch.setattr(CondRealNVP, "_use_fused",
                        lambda self, train, x, *trees: not train and self.kernel_mode is not None)
    cond = torch.from_numpy(np.random.default_rng(10).normal(size=(3, 6)).astype(np.float32))
    y = model.sample(params, torch.Generator().manual_seed(1), 4, cond, device="cpu")
    model.forward(params, y[0], cond)
    mode = TABLE[precision][0]
    assert seen == ([] if mode is None else [mode, mode])

    from bcnf_tpu_torch.ops import coupling_kernel

    k4 = []
    monkeypatch.setattr(coupling_kernel, "fused_affine_coupling",
                        lambda *a, mode=MODE_3XTF32, **k: k4.append(mode) or fused_affine_coupling(*a, **k))
    model.use_pallas_coupling = True
    model.inverse_given_h(params, y[0], model.encode(params, (cond,)))
    assert k4 == ([] if mode is None else [mode] * N_BLOCKS)


def test_training_precision_reaches_the_model_and_its_steps():
    """`training.precision` sets the model's precision (`bcnf_tpu/train/
    trainer.py:216-220`), and each step's forward AND backward run inside its
    context (JAX traces the grad inside it): the TF32 flag is read during the
    model's forward and during the backward through its output; outside the
    steps the float32 contract holds."""
    model = _model()
    rng = np.random.default_rng(13)
    y = rng.normal(size=(48, SIZE)).astype(np.float32)
    cond = rng.normal(size=(48, 6)).astype(np.float32)
    cfg = {
        "global": {"dtype": "float32"},
        "training": {"validation_split": 0.25, "val_loss_window_size": 1, "val_loss_patience": 100,
                     "val_loss_tolerance": 1e-3, "val_loss_tolerance_mode": "rel", "batch_size": 16,
                     "n_epochs": 1, "timeout": None, "random_state": 0, "precision": "BF16_BF16_F32_X3"},
        "optimizer": {"type": "Adam", "kwargs": {"lr": 1e-3}},
        "lr_scheduler": {"type": "ReduceLROnPlateau", "kwargs": {"patience": 5}},
    }
    flags = {"forward": [], "backward": []}
    forward = CondRealNVP.forward

    def recording_forward(self, *a, **k):
        out = forward(self, *a, **k)
        flags["forward"].append(torch.backends.cuda.matmul.allow_tf32)
        if out[0].requires_grad:
            out[0].register_hook(lambda g: flags["backward"].append(torch.backends.cuda.matmul.allow_tf32))
        return out

    model.forward = recording_forward.__get__(model)
    Trainer(cfg, data=(y, [cond]), device="cpu", verbose=False).train(model)
    assert model.precision == "BF16_BF16_F32_X3"
    assert flags["forward"] and all(flags["forward"]) and flags["backward"] and all(flags["backward"])
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


# ---------------------------------------------------------------------------
# eval --precision: after the test NLL, as in JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("precision")
    cfg = {
        "global": {"cnf_version": 2,
                   "parameter_selection": ["x0_x", "x0_y", "x0_z", "v0_x", "v0_y", "v0_z", "g", "w_x", "w_y",
                                           "w_z", "b", "m", "a_x", "a_y", "a_z", "r", "A", "Cd", "rho"],
                   "conditions": [["trajectories"]], "dtype": "float32"},
        "data": {"path": str(d / "data"), "config_file": "{{BCNF_ROOT}}/configs/data_prior.yaml",
                 "n_samples": 48, "output_type": "trajectories", "dt": 0.1, "T": 0.5, "num_cams": 2,
                 "break_on_impact": False, "do_filter": False, "verbose": False},
        "model": {"kwargs": {"size": 19, "nested_sizes": [16, 16], "n_blocks": 3, "n_conditions": 12,
                             "act_norm": True, "random_state": 0}},
        "feature_networks": [
            {"type": "ConcatenateCondition", "kwargs": {"input_size": None, "output_size": 15}},
            {"type": "FullyConnected", "kwargs": {"sizes": [15, 16, 12]}},
        ],
        "optimizer": {"type": "Adam", "kwargs": {"lr": 2.0e-3}},
        "lr_scheduler": {"type": "ReduceLROnPlateau", "kwargs": {"patience": 50}},
        "training": {"validation_split": 0.25, "val_loss_window_size": 3, "val_loss_patience": 1000,
                     "val_loss_tolerance": 0.01, "val_loss_tolerance_mode": "abs", "batch_size": 16,
                     "n_epochs": 1, "timeout": None, "random_state": 0},
    }
    (d / "tiny.yaml").write_text(yaml.safe_dump(cfg, sort_keys=False))
    main(["train", "-c", str(d / "tiny.yaml"), "-o", str(d / "model"), "--device", "cpu"])
    return d


def test_eval_precision_leaves_the_nll_and_changes_only_sampling(model_dir, monkeypatch):
    """`eval --precision default` sets the model's precision after the test
    NLL pass (`bcnf_tpu/__main__.py:463-467`): the NLL's forwards run at
    float32 and the report's NLL is the float32 run's bit for bit; every
    sampling stage (ranks, diagnostics, resimulation) runs at "default"."""
    seen = []
    forward, sample = CondRealNVP.forward, CondRealNVP.sample
    monkeypatch.setattr(CondRealNVP, "forward", lambda self, *a, **k: seen.append(("forward", self.precision))
                        or forward(self, *a, **k))
    monkeypatch.setattr(CondRealNVP, "sample", lambda self, *a, **k: seen.append(("sample", self.precision))
                        or sample(self, *a, **k))
    base = ["eval", "-m", str(model_dir / "model"), "-d", str(model_dir / "data" / "data.pkl"), "-M", "16",
            "--max-points", "6", "--resim-samples", "4", "--device", "cpu"]
    reports = {}
    for precision in (None, "default"):
        out = model_dir / f"report_{precision}"
        seen.clear()
        main([*base, "-o", str(out), *(["--precision", precision] if precision else [])])
        reports[precision] = json.loads((out / "report.json").read_text())
        nll_calls = [p for kind, p in seen if kind == "forward"]
        sampling = [p for kind, p in seen if kind == "sample"]
        assert nll_calls and set(nll_calls) == {"highest"}
        assert sampling and set(sampling) == {precision or "highest"}
    assert reports[None]["test_nll"] == reports["default"]["test_nll"]
