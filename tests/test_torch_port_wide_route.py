"""K1's 3xTF32 inverse at the padded widths 768 and 1024 on its own route,
the wide `wgmma` inverse (`csrc/flow_wide_wgmma.cu`): clusters of Hp/128
blocks on the same 128 rows, each block's columns of every hidden layer in a
distributed tile, the hidden weights streamed once in float32 and split into
hi and lo in shared memory.

On the CPU: the route (`flow_route`, by mode and shape; `WIDE_WGMMA_MAX_TN`
= 0 forces the row tiles), K4's inverse on it, its shared memory and
constants read from the source, and the wide configuration
(`configs/runs/dev/trajectory_LSTM_xsmall_large_hybrid_dual.yaml`, cut to 2
blocks) against the JAX package: the port's `sample` (its plain path) and
the plain version of K1 (float32, and in the kernel's 3xTF32 arithmetic)
against JAX's inverse and its Pallas kernel in interpret mode. The `gpu`
tests hold the kernel against its plain version on a card:
`python -m pytest tests/test_torch_port_wide_route.py -m gpu --noconftest`
(JAX is imported only inside the tests that compare with it)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from bcnf_tpu_torch.ops import coupling_kernel as ck
from bcnf_tpu_torch.ops import flow_kernel as fk

CSRC = Path(fk.__file__).resolve().parent / "csrc"
WIDE_CONFIG = "{{BCNF_ROOT}}/configs/runs/dev/trajectory_LSTM_xsmall_large_hybrid_dual.yaml"


def _source_constant(name: str) -> int:
    return int(re.search(rf"constexpr\s+int\s+{name}\s*=\s*(\d+)\s*;", (CSRC / "flow_wide_wgmma.cu").read_text())
               .group(1))


@pytest.mark.parametrize("Hp", [768, 1024])
def test_wide_route_takes_the_3xtf32_inverse_at_hp_768_and_1024(Hp):
    """The 3xTF32 inverse at Hp 768 and 1024 takes the wide route, its own
    library; the forward the wide forward of the same library, the one-pass
    inverse its row tiles, strict the FMA kernel; below 768 nothing moves."""
    assert fk.flow_route(Hp, 19, 10, True, fk.MODE_3XTF32) == fk.ROUTE_WIDE
    assert fk.ROUTE_LIBRARY[fk.ROUTE_WIDE] == "flow_wide_wgmma"
    assert fk.flow_route(Hp, 19, 10, False, fk.MODE_3XTF32) == fk.ROUTE_WIDE_FWD
    assert fk.ROUTE_LIBRARY[fk.ROUTE_WIDE_FWD] == "flow_wide_wgmma"
    assert fk.flow_route(Hp, 19, 10, True, fk.MODE_TF32) == fk.ROUTE_ROWS_TF32
    assert fk.flow_route(Hp, 19, 10, True, fk.MODE_FMA) == fk.ROUTE_FMA
    for narrow in (32, 256, 512, 544):
        assert fk.flow_route(narrow, 19, 10, True, fk.MODE_3XTF32) == fk.ROUTE_WGMMA


@pytest.mark.parametrize("limit,routes", [(0, (fk.ROUTE_ROWS, fk.ROUTE_ROWS)), (24, (fk.ROUTE_WIDE, fk.ROUTE_ROWS)),
                                          (32, (fk.ROUTE_WIDE, fk.ROUTE_WIDE))])
def test_wide_route_limit_forces_the_row_tiles(monkeypatch, limit, routes):
    """`WIDE_WGMMA_MAX_TN` bounds the widths the wide route takes: 0 forces
    the row tiles at both (as the tools and the smoke time them), 24 keeps
    the row tiles at 1024; the other modes and the forward (on the wide
    forward, which its own limit bounds) do not move."""
    monkeypatch.setattr(fk, "WIDE_WGMMA_MAX_TN", limit)
    assert (fk.flow_route(768, 19, 10, True, fk.MODE_3XTF32), fk.flow_route(1024, 19, 10, True, fk.MODE_3XTF32)) == routes
    for Hp in (768, 1024):
        assert fk.flow_route(Hp, 19, 10, True, fk.MODE_TF32) == fk.ROUTE_ROWS_TF32
        assert fk.flow_route(Hp, 19, 10, True, fk.MODE_FMA) == fk.ROUTE_FMA
        assert fk.flow_route(Hp, 19, 10, False, fk.MODE_3XTF32) == fk.ROUTE_WIDE_FWD


@pytest.mark.parametrize("H", [700, 1000, 1024])
def test_k4_inverse_takes_the_wide_route(H):
    """K4 is K1 at one step (`coupling_flow_args`): its 3xTF32 inverse at
    those widths takes the wide route, on the layout `route_weights` gives
    it (which K4 keeps per coupling: `prepare_wide_weights`); its forward
    takes the wide forward, on the same layout."""
    rng = np.random.default_rng(H)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    args = ck.coupling_flow_args(t(8, H), t(10, H), t(H), [t(H, H) for _ in range(4)], [t(H) for _ in range(4)],
                                 t(H, 18), t(18))
    Hp = args["b1"].shape[-1]
    assert Hp in (768, 1024) and args["wm"].shape == (1, 4, Hp, Hp)
    assert fk.flow_route(Hp, 19, 10, True, fk.MODE_3XTF32) == fk.ROUTE_WIDE
    assert fk.flow_route(Hp, 19, 10, False, fk.MODE_3XTF32) == fk.ROUTE_WIDE_FWD
    assert torch.equal(fk.route_weights(fk.ROUTE_WIDE, args["wm"]), fk.prepare_wide_weights(args["wm"]))
    assert torch.equal(fk.route_weights(fk.ROUTE_WIDE_FWD, args["wm"]), fk.prepare_wide_weights(args["wm"]))
    with pytest.raises(ValueError, match="laid out for its route"):
        fk.route_weights(fk.ROUTE_WIDE, args["wm"], fk.prepare_weights(args["wm"]))


@pytest.mark.parametrize("Hp", [768, 1024])
def test_wide_weight_layout_is_its_index_formula(Hp):
    """`prepare_wide_weights`' layout against its index formula: entry [s,
    l, j, c, u, ng, kg, r, i] is wm[s, l, 8 (kWwStageK j + u) + 4 kg + i, 128
    c + 8 ng + r] with 128 columns a block, float32 as stored (no rounding);
    a block's stage, one bulk copy, is contiguous and K-major in `wgmma`'s
    core matrices (8 outputs x 4 inputs, 128 bytes; the two input halves
    128 bytes apart, the output groups 256)."""
    S, nh = 2, 1
    rng = np.random.default_rng(Hp)
    wm = torch.from_numpy(rng.normal(size=(S, nh, Hp, Hp)).astype(np.float32))
    out = fk.prepare_wide_weights(wm)
    K, C = fk.kernel_limit("kWwStageK"), Hp // 128
    assert tuple(out.shape) == (S, nh, Hp // 8 // K, C, K, 16, 2, 8, 4) and out.dtype == torch.float32
    idx = np.stack(np.meshgrid(*(np.arange(n) for n in out.shape), indexing="ij"), -1).reshape(-1, 9)
    pick = idx[rng.choice(len(idx), 20_000, replace=False)]
    s, l, j, c, u, ng, kg, r, i = pick.T
    expect = wm.numpy()[s, l, 8 * (K * j + u) + 4 * kg + i, 128 * c + 8 * ng + r]
    np.testing.assert_array_equal(out.numpy()[tuple(pick.T)], expect)
    flat = out.reshape(-1)  # a block's stage: output n of input k at 1024 u + 64 (n // 8) + 32 (k // 4) + 4 (n % 8) + k % 4
    stage = flat[(Hp // 8 // K + 1) * C * 1024 * K + 1024 * K:][:1024 * K].reshape(K, 1024)  # step 1, layer 0,
    for u in range(K):  # the layer's second stage, block 1's part
        for n, k in ((0, 0), (5, 3), (9, 4), (127, 7)):
            assert stage[u, 64 * (n // 8) + 32 * (k // 4) + 4 * (n % 8) + k % 4] == wm[1, 0, 8 * (K + u) + k, 128 + n]


def test_wide_constants_are_read_from_the_kernel_source():
    """The host reads the kernel's rows, columns a block, k-steps a stage and
    rings from the source, and the cluster of a width is Hp/128 blocks: 6 at
    768, 8 at 1024; the grid is a cluster a 128-row tile."""
    for name in ("kWwRows", "kWwCols", "kWwStageK", "kWwHiStages", "kWwLoStages"):
        assert fk.kernel_limit(name) == _source_constant(name)
    assert (fk.kernel_limit("kWwRows"), fk.kernel_limit("kWwCols")) == (128, 128)
    assert fk.wide_grid(80_000, 768) == 625 * 6 and fk.wide_grid(80_000, 1024) == 625 * 8
    assert fk.wide_grid(128 * 7 + 1, 1024) == 8 * 8


@pytest.mark.parametrize("Hp", [768, 1024])
@pytest.mark.parametrize("size", [19, 21])
@pytest.mark.parametrize("d_a", [9, 10, 11])
def test_wide_shared_memory_is_the_source_sum_and_fits(Hp, size, d_a):
    """`kernel_smem` of the wide route is the launcher's `ww_smem`: the tile
    of the block's 128 x 132 floats, the hi and lo rings (kWwStageK k-steps
    of 8 x 128 floats a stage), x and x Q^T of the 128 rows, the partial [t
    | s'] of the ceil(128 / C) rows a block reduces from each of the C =
    Hp/128 blocks and [t | s'] of every row, two barriers a ring stage and
    three hand-off barriers a block; it lies within a block's shared memory
    at the wide configuration's size 19 and at 21, d_a 9-11, and the route
    takes those shapes."""
    K, hi, lo = (_source_constant(n) for n in ("kWwStageK", "kWwHiStages", "kWwLoStages"))
    C, n_out = Hp // 128, 2 * (size - d_a)
    expected = 4 * (128 * 132 + (hi + lo) * K * 1024 + 128 * 2 * size + (C * -(-128 // C) + 128) * n_out) + 8 * (
        2 * (hi + lo) + 3 * C)
    assert fk.kernel_smem(fk.ROUTE_WIDE, Hp, size, d_a) == expected
    assert expected <= fk.kernel_limit("kSmemLimit")
    assert fk.wide_takes(Hp, size, d_a)
    assert fk.flow_route(Hp, size, d_a, True, fk.MODE_3XTF32) == fk.ROUTE_WIDE


def test_wide_route_refuses_what_its_shared_memory_cannot_hold():
    """The rows' state and the cluster's partial outputs grow with size and
    d_b: past a block's shared memory the wide route refuses the shape and
    the row tiles take it (by shape, not by a failed launch)."""
    limit = fk.kernel_limit("kSmemLimit")
    for Hp in (768, 1024):
        fits = [size for size in range(12, 80) if fk.kernel_smem(fk.ROUTE_WIDE, Hp, size, 8) <= limit]
        last = max(fits)
        assert fits == list(range(12, last + 1)) and last < 79
        assert fk.wide_takes(Hp, last, 8) and not fk.wide_takes(Hp, last + 1, 8)
        assert fk.flow_route(Hp, last + 1, 8, True, fk.MODE_3XTF32) == fk.ROUTE_ROWS
    assert not fk.wide_takes(544, 19, 10) and not fk.wide_takes(800, 19, 10)


def test_wide_parts_tool_patches_apply_to_the_kernel_source():
    """Each variant of `tools/k1_wide_parts.py` patches text that the
    kernel's source holds once, and changes it."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "k1_wide_parts", Path(__file__).resolve().parent.parent / "tools" / "k1_wide_parts.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    text = (CSRC / "flow_wide_wgmma.cu").read_text()
    assert set(tool.PATCHES) >= {"as built", "trunc_hi", "hi4"}
    for name, pairs in tool.PATCHES.items():
        for old, new in pairs:
            assert text.count(old) == 1 and old != new, name


# ---------------------------------------------------------------------------
# the wide configuration against the JAX package (CPU)
# ---------------------------------------------------------------------------


def _wide_pair(n_blocks: int = 2):
    """The wide run config at its published widths (5 x 1024, size 19,
    `n_conditions` 32, hybrid, the DualDomainLSTM encoder), cut to
    `n_blocks` blocks, in both packages on the same weights (JAX's init,
    bridged); ActNorm moved off identity so it is exercised."""
    import jax
    import jax.numpy as jnp

    from bcnf_tpu.config import load_config as jax_load_config
    from bcnf_tpu.models import CondRealNVP as JaxCondRealNVP
    from bcnf_tpu_torch.bridge import params_from_numpy
    from bcnf_tpu_torch.config import load_config
    from bcnf_tpu_torch.models import CondRealNVP

    jcfg, tcfg = jax_load_config(WIDE_CONFIG).to_dict(), load_config(WIDE_CONFIG).to_dict()
    for cfg in (jcfg, tcfg):
        cfg["model"]["kwargs"]["n_blocks"] = n_blocks
    jm, tm = JaxCondRealNVP.from_config(jcfg), CondRealNVP.from_config(tcfg)
    params = jm.init(jax.random.key(3))
    rng = np.random.default_rng(4)
    an = params["blocks"]["actnorm"]
    params = dict(params, blocks=dict(params["blocks"], actnorm={
        "scale": an["scale"] + jnp.asarray(0.1 * rng.normal(size=an["scale"].shape).astype(np.float32)),
        "bias": jnp.asarray(0.1 * rng.normal(size=an["bias"].shape).astype(np.float32)),
    }))
    jp = jax.tree.map(np.asarray, jax.device_get(params))
    return jm, tm, jax.tree.map(jnp.asarray, jp), params_from_numpy(jp, "cpu"), rng


def test_wide_config_sample_matches_jax():
    """The port's `sample` of the wide configuration (the plain path on the
    CPU) against JAX's inverse on the same draws and weights, draw by draw
    (JAX's `sample` maps `inverse_given_h` over the draws): atol 1e-4, the
    JAX package's flow bar (tests/test_flow_kernel.py:89-117)."""
    import jax.numpy as jnp

    jm, tm, jp, tp, rng = _wide_pair()
    assert (tm.nested_sizes, tm.size, tm.n_conditions, tm.hybrid) == ([1024] * 5, 19, 32, True)
    traj = rng.normal(size=(4, 30, 3)).astype(np.float32)
    gen = torch.Generator().manual_seed(5)
    z = tm.draw_z(torch.Generator().manual_seed(5), 3, 4)
    with torch.no_grad():
        out = tm.sample(tp, gen, 3, torch.from_numpy(traj), device="cpu")
    h = jm.encode(jp, (jnp.asarray(traj),))
    for d in range(3):
        ref = np.asarray(jm.inverse_given_h(jp, jnp.asarray(z[d].numpy()), h))
        np.testing.assert_allclose(out[d].numpy(), ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("arith", ["float32", "3xtf32"])
def test_wide_config_kernel_plain_version_matches_pallas_interpret(arith):
    """K1's plain version at the wide configuration's stacked, padded
    arguments (Hp 1024, 2 steps of 4 hidden layers), float32 and in the wide
    kernel's 3xTF32 arithmetic (`tf32.matmul_3xtf32` for every MLP
    product), against JAX's `fused_flow` inverse run through its Pallas
    kernel in interpret mode at "highest", as the JAX package's own tests
    run it on the CPU: atol 1e-4; the route the card takes at this shape is
    the wide inverse."""
    import jax.numpy as jnp

    from bcnf_tpu.ops.flow_kernel import fused_flow as jax_fused_flow
    from bcnf_tpu_torch.ops.tf32 import matmul_3xtf32

    jm, tm, jp, tp, rng = _wide_pair()
    N, B = 4, 16
    traj = rng.normal(size=(N, 30, 3)).astype(np.float32)
    kargs, h_proj = jm._fused_flow_args(jp, jm.encode(jp, (jnp.asarray(traj),)))
    x = rng.normal(size=(B, tm.size)).astype(np.float32)
    ref = jax_fused_flow(jnp.asarray(x), h_proj, **kargs, inverse=True, n_cond=N, block_b=2 * N,
                         precision="highest", interpret=True)
    with torch.no_grad():
        tk, th = tm._fused_flow_args(tp, tm.encode(tp, (torch.from_numpy(traj),)))
        assert th.shape[-1] == 1024 and fk.flow_route(1024, tm.size, tm.coupling.d_a, True) == fk.ROUTE_WIDE
        ours = fk.fused_flow_reference(torch.from_numpy(x), th, **tk, inverse=True, n_cond=N,
                                       mm=matmul_3xtf32 if arith == "3xtf32" else torch.matmul)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_weights(cuda, H: int, S: int, nh: int, size: int, d_a: int, N: int, seed: int):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=cuda)

    n_out = 2 * (size - d_a)
    w = {"an_scale": 1 + 0.1 * randn(S, size), "an_bias": 0.1 * randn(S, size),
         "ortho": torch.linalg.qr(randn(S, size, size))[0].contiguous(),
         "w1y": randn(S, d_a, H, scale=d_a ** -0.5), "b1": randn(S, H, scale=0.1),
         "wm": randn(S, nh, H, H, scale=H ** -0.5), "bm": randn(S, nh, H, scale=0.1),
         "wout": randn(S, H, n_out, scale=0.3 * H ** -0.5), "bout": randn(S, n_out, scale=0.1)}
    return fk.pad_hidden(w, randn(S, N, H, scale=0.5))


@pytest.mark.gpu
@pytest.mark.parametrize("H,B,nh,size,d_a", [(700, 257, 4, 19, 10), (1000, 4097, 4, 19, 10), (1024, 65, 1, 21, 9),
                                             (1024, 64 * 5 + 3, 0, 19, 10)])
def test_wide_inverse_matches_plain_version_on_card(cuda, H, B, nh, size, d_a):
    """The wide inverse within 1e-4 of the float32 plain version, no further
    from the float64 plain version than twice the float32 one (plus 4
    float32 steps), equal to the bit between two calls, counted on its
    route; ragged rows over odd tile counts, N not dividing B, no hidden
    layer."""
    S, N = 3, 7
    kargs, h_proj = _card_weights(cuda, H, S, nh, size, d_a, N, seed=H + B)
    x = torch.randn((B, size), generator=torch.Generator(device=cuda).manual_seed(B), device=cuda)
    before = fk.fused_flow.route_launches[fk.ROUTE_WIDE]
    with torch.no_grad():
        one = fk.fused_flow(x, h_proj, **kargs, inverse=True, n_cond=N)
        two = fk.fused_flow(x, h_proj, **kargs, inverse=True, n_cond=N)
        p32 = fk.fused_flow_reference(x, h_proj, **kargs, inverse=True, n_cond=N)
        p64 = fk.fused_flow_reference(x.double(), h_proj.double(), **{k: v.double() for k, v in kargs.items()},
                                      inverse=True, n_cond=N)
        torch.cuda.synchronize()
    assert fk.fused_flow.route_launches[fk.ROUTE_WIDE] == before + 2
    torch.testing.assert_close(one, p32, atol=1e-4, rtol=0)
    assert torch.equal(one, two)
    d32, dk = (p32.double() - p64).abs().max().item(), (one.double() - p64).abs().max().item()
    assert dk <= 2 * d32 + 4 * float(torch.finfo(torch.float32).eps) * max(1.0, p64.abs().max().item())


@pytest.mark.gpu
def test_wide_k4_inverse_on_card(cuda):
    """K4's 3xTF32 inverse at Hp 1024 runs K1's wide inverse at one step:
    within 1e-4 of its plain version, counted once; the coupling's wide
    layout (`prepare_wide_weights`) is prepared once and kept for the next
    call."""
    rng = np.random.default_rng(0)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32)).to(cuda)

    H = 1000
    x_a, x_b, hp = t(1001, 10), t(1001, 9), t(8, H, scale=0.5)
    weights = dict(w1y=t(10, H, scale=0.3), b1=t(H, scale=0.1), wm=[t(H, H, scale=H ** -0.5) for _ in range(4)],
                   bm=[t(H, scale=0.1) for _ in range(4)], wout=t(H, 18, scale=0.01), bout=t(18, scale=0.1))
    before = (ck.fused_affine_coupling.launches, ck.fused_affine_coupling.stage_preparations,
              fk.fused_flow.route_launches[fk.ROUTE_WIDE])
    with torch.no_grad():
        y = ck.fused_affine_coupling(x_a, x_b, hp, **weights, inverse=True, n_cond=8)
        again = ck.fused_affine_coupling(x_a, x_b, hp, **weights, inverse=True, n_cond=8)
        ref = ck.fused_affine_coupling_reference(x_a, x_b, hp, **weights, inverse=True, n_cond=8)
        torch.cuda.synchronize()
    assert (ck.fused_affine_coupling.launches, ck.fused_affine_coupling.stage_preparations) == (
        before[0] + 2, before[1] + 1)
    assert torch.equal(y, again)
    assert fk.fused_flow.route_launches[fk.ROUTE_WIDE] == before[2]  # K4 counts in its own launches only
    torch.testing.assert_close(y, ref, atol=1e-4, rtol=0)
