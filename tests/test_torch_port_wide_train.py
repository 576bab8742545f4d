"""K2b in 3xTF32 at the padded widths 768 and 1024 on its own route, the wide
backward (`csrc/flow_wide_train_wgmma.cu`): the wide forward's clusters of
Hp/128 blocks on a distributed tile recomputing each step's MLP and running
its backward on `wgmma`, a weight-grad pass on `wgmma`, one reduction of the
partials.

On the CPU: the route (`train_bwd_route`, by mode and shape;
`WIDE_TRAIN_MAX_TN` = 0 forces the row tiles; the other modes and the
narrower widths keep theirs), the step's two weight layouts against their
index model and their preparation once a step, the rows kernel's shared
memory against the source's sum, the plain version on a CPU tensor (no
launch), and the plain backward at the wide configuration's arguments
against JAX's custom VJP through its Pallas kernels in interpret mode. The
`gpu` tests hold the kernel against its plain version on a card:
`python -m pytest tests/test_torch_port_wide_train.py -m gpu --noconftest`
(JAX is imported only inside the tests that compare with it)."""

import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from bcnf_tpu_torch.ops import flow_kernel as fk

CSRC = Path(fk.__file__).resolve().parent / "csrc"
ARG_NAMES = ("an_scale", "an_bias", "ortho", "w1y", "b1", "wm", "bm", "wout", "bout")
GRAD_NAMES = ("dx", "dh_proj", "dan_scale", "dan_bias", "dw1y", "db1", "dwm", "dbm", "dwout", "dbout")


def _source_constant(name: str, source: str = "flow_wide_wgmma.cu") -> int:
    return int(re.search(rf"constexpr\s+int\s+{name}\s*=\s*(\d+)\s*;", (CSRC / source).read_text()).group(1))


@pytest.mark.parametrize("limit,routes", [(0, (fk.ROUTE_ROWS, fk.ROUTE_ROWS)),
                                          (24, (fk.ROUTE_WIDE_TRAIN, fk.ROUTE_ROWS)),
                                          (32, (fk.ROUTE_WIDE_TRAIN, fk.ROUTE_WIDE_TRAIN))])
def test_wide_train_limit_forces_the_row_tiles(monkeypatch, limit, routes):
    """`WIDE_TRAIN_MAX_TN` bounds the widths the wide K2b takes: 0 forces the
    row tiles at both (as the tools and the smoke time them), 24 keeps them at
    1024; the forward routes and the other modes do not move."""
    monkeypatch.setattr(fk, "WIDE_TRAIN_MAX_TN", limit)
    assert (fk.train_bwd_route(768, 19, 10, 4), fk.train_bwd_route(1024, 19, 10, 4)) == routes
    for Hp in (768, 1024):
        assert fk.flow_route(Hp, 19, 10, False) == fk.ROUTE_WIDE_FWD
        assert fk.train_bwd_route(Hp, 19, 10, 4, fk.MODE_TF32) == fk.ROUTE_ROWS_TF32
        assert fk.train_bwd_route(Hp, 19, 10, 4, fk.MODE_FMA) == fk.ROUTE_FMA


def _index_model(wm: np.ndarray, k: int, cols: int) -> np.ndarray:
    """`prepare_wide_train_weights` element by element: entry [d, s, l, j,
    c, u, ng, kg, r, i] is X_d[s, l, 8 (k j + u) + 4 kg + i, cols c + 8 ng +
    r], X_0 = Wm (the products h Wm), X_1 = Wm^T (da Wm^T)."""
    S, nh, Hp, _ = wm.shape
    out = np.empty((2, S, nh, Hp // 8 // k, Hp // cols, k, cols // 8, 2, 8, 4), np.float32)
    for d, x in enumerate((wm, wm.transpose(0, 1, 3, 2))):
        for j in range(Hp // 8 // k):
            for u in range(k):
                for kg in range(2):
                    for i in range(4):
                        row = 8 * (k * j + u) + 4 * kg + i
                        # columns cols c + 8 ng + r, as (c, ng, r)
                        out[d, :, :, j, :, u, :, kg, :, i] = x[:, :, row, :].reshape(S, nh, Hp // cols, cols // 8, 8)
    return out


def test_wide_train_weights_match_their_index_model():
    """The step's layout at the wide widths (`prepare_wide_train_weights`):
    `prepare_wide_weights` of Wm, then of Wm^T, stacked, against the index
    model, bit for bit, with kWwStageK and kWwCols read from the source; the
    first direction is the wide forward's own layout."""
    k, cols = _source_constant("kWwStageK"), _source_constant("kWwCols")
    wm = np.random.default_rng(5).normal(size=(2, 3, 256, 256)).astype(np.float32)
    got = fk.prepare_wide_train_weights(torch.from_numpy(wm))
    assert got.shape == (2, 2, 3, 256 // 8 // k, 256 // cols, k, cols // 8, 2, 8, 4)
    np.testing.assert_array_equal(got.numpy(), _index_model(wm, k, cols))
    assert torch.equal(got[0], fk.prepare_wide_weights(torch.from_numpy(wm)))


@pytest.mark.parametrize("H,mode,expected", [
    (1000, "3xtf32", "wide"), (700, "3xtf32", "wide"), (526, "3xtf32", 3), (1000, "tf32", None), (1000, "fma", None),
], ids=["3xtf32_1024", "3xtf32_768", "3xtf32_544", "one_pass_1024", "strict_1024"])
def test_train_weights_prepares_both_layouts_once_a_step(monkeypatch, H, mode, expected):
    """A training step's hidden weights (`train_weights`, which
    `_FusedFlowTrain.forward` calls once and hands to K2a and K2b): in 3xTF32
    at Hp 768 and 1024 one preparation of both directions
    (`prepare_wide_train_weights`); at 544 the `wgmma` routes' hi/lo layout;
    none for the one-pass row tiles or strict there, nor on a CPU tensor.
    With the row tiles forced K2a's wide forward lays out its own again."""
    calls = []
    monkeypatch.setattr(fk, "prepare_wide_train_weights", lambda wm: calls.append("wide") or "both")
    monkeypatch.setattr(fk, "prepare_train_weights", lambda wm, passes=1: calls.append(passes) or "hi/lo")
    Hp, B, S, nh = fk.padded_width(H), 64, 3, 4
    x = types.SimpleNamespace(device=torch.device("cuda"), shape=(B, 19))
    h_proj, wm = types.SimpleNamespace(shape=(S, B, Hp)), types.SimpleNamespace(shape=(S, nh, Hp, Hp))
    got = fk.train_weights(x, h_proj, wm, 10, mode)
    want = {"wide": "both", 3: "hi/lo", None: None}[expected]
    assert (got, calls) == (want, [] if expected is None else [expected])
    cpu = types.SimpleNamespace(device=torch.device("cpu"), shape=(B, 19))
    assert fk.train_weights(cpu, h_proj, wm, 10, mode) is None and len(calls) == (0 if expected is None else 1)
    if expected == "wide":
        monkeypatch.setattr(fk, "WIDE_TRAIN_MAX_TN", 0)
        assert fk.train_weights(x, h_proj, wm, 10, mode) is None


@pytest.mark.parametrize("Hp", [768, 1024])
@pytest.mark.parametrize("size,d_a", [(19, 10), (21, 9), (19, 15)])
@pytest.mark.parametrize("rows", [64, 128])
def test_wide_train_shared_memory_is_the_source_sum_and_fits(Hp, size, d_a, rows):
    """The rows kernel's shared memory (`wide_train_smem`, the launcher's
    `wt_smem`): the tile of the block's rows x 128 floats (two on 64-row
    tiles), the hi and lo rings (kWwStageK k-steps of 8 x 128 floats a
    stage), the step's W1y, b1 and Wout of the block's 128 columns, per row
    x1, dx2, [t | s'], dx_a and dld, the partials of the ceil(rows / C) rows
    a block reduces from each of the C = Hp/128 blocks (max(n_out, d_a)
    floats a row), to even floats; then two barriers a ring stage, three
    hand-off barriers a block and one for the step's weights. It lies within
    a block's at the wide configuration's size 19 and at 21, on both tiles,
    and the route takes those shapes."""
    K, hi, lo = (_source_constant(n) for n in ("kWwStageK", "kWwHiStages", "kWwLoStages"))
    C, n_out = Hp // 128, 2 * (size - d_a)
    floats = ((2 if rows == 64 else 1) * rows * 128 + (hi + lo) * K * 1024 + (d_a + 1 + n_out) * 128
              + rows * (2 * size + n_out + d_a + 1) + C * -(-rows // C) * max(n_out, d_a))
    expected = 4 * (floats + floats % 2) + 8 * (2 * (hi + lo) + 3 * C + 1)
    assert fk.wide_train_smem(Hp, size, d_a, rows) == expected <= fk.kernel_limit("kSmemLimit")
    assert fk.wide_train_smem(Hp, size, d_a) == fk.wide_train_smem(Hp, size, d_a, 128)
    assert fk.wide_train_takes(Hp, size, d_a)
    assert fk.train_bwd_route(Hp, size, d_a, 4) == fk.ROUTE_WIDE_TRAIN
    text = (CSRC / "flow_wide_train_wgmma.cu").read_text()
    for term in ("(rows == kWwHalfRows ? 2 : 1) * rows * kWwCols", "(kWwHiStages + kWwLoStages) * kWwStage",
                 "ww_narrow_floats(d_a, n_out)", "(2 * size + n_out + d_a + 1)", "ww_reduce_rows(C, rows) * xw",
                 "(2 * (kWwHiStages + kWwLoStages) + 3 * static_cast<size_t>(Hp / kWwCols) + 1)"):
        assert term in text, term


def test_wide_train_refuses_what_its_shared_memory_cannot_hold():
    """The rows' state, the step's weights and the cluster's partials grow
    with size: past a block's shared memory the wide K2b refuses the shape
    and the row tiles take it (by shape, not by a failed launch); the wide
    configuration's size 19 fits, and neither width it is not built for."""
    limit = fk.kernel_limit("kSmemLimit")
    for Hp in (768, 1024):
        fits = [size for size in range(12, 80) if fk.wide_train_smem(Hp, size, 8) <= limit]
        last = max(fits)
        assert fits == list(range(12, last + 1)) and 19 < last < 79
        assert fk.wide_train_takes(Hp, last, 8) and not fk.wide_train_takes(Hp, last + 1, 8)
        assert fk.train_bwd_route(Hp, last + 1, 8, 4) == fk.ROUTE_ROWS
    assert not fk.wide_train_takes(544, 19, 10) and not fk.wide_train_takes(800, 19, 10)


def test_wide_k2b_cpu_call_takes_the_plain_version():
    """On a CPU tensor at Hp 1024 `fused_flow_train_bwd` returns the plain
    version's grads and launches nothing (no count moves), as the autograd
    Function's backward does."""
    S, B, size, d_a, nh, H = 2, 5, 19, 10, 1, 1000
    g = np.random.default_rng(6)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * g.normal(size=shape)).astype(np.float32))

    w = dict(an_scale=1 + 0.1 * t(S, size), an_bias=0.1 * t(S, size), ortho=torch.linalg.qr(t(S, size, size))[0],
             w1y=t(S, d_a, H, scale=0.3), b1=t(S, H, scale=0.1), wm=t(S, nh, H, H, scale=H ** -0.5),
             bm=t(S, nh, H, scale=0.1), wout=t(S, H, 18, scale=0.01), bout=t(S, 18, scale=0.1))
    kargs, h_proj = fk.pad_hidden(w, t(S, B, H, scale=0.5))
    assert fk.train_bwd_route(h_proj.shape[-1], size, d_a, nh) == fk.ROUTE_WIDE_TRAIN
    args = [kargs[n] for n in ARG_NAMES]
    bound = fk.fused_flow_train_reference(t(B, size), h_proj, *args)[2]
    dz, dld = t(B, size), t(B)
    before = (fk.fused_flow_train_bwd.launches, dict(fk.fused_flow_train_bwd.route_launches))
    got = fk.fused_flow_train_bwd(bound, h_proj, dz, dld, *args)
    ref = fk.fused_flow_train_backward_reference(bound, h_proj, dz, dld, *args)
    assert (fk.fused_flow_train_bwd.launches, dict(fk.fused_flow_train_bwd.route_launches)) == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arith", ["float32", "3xtf32"])
def test_wide_k2b_plain_version_matches_pallas_vjp(arith):
    """K2b's plain version at the wide configuration's arguments (Hp 1024, 2
    steps of 4 hidden layers, 8 rows with their own conditions), float32 and
    in the kernel's 3xTF32 arithmetic, from the step inputs of K2a's plain
    version, against JAX's custom VJP of `_make_fused_flow_train` (K2b: its
    `bwd_call`, `_flow_bwd_train_kernel`) in interpret mode at "highest", on
    the same cotangents: every grad within the JAX package's grad bar, atol
    5e-4 and rtol 1e-3 (tests/test_flow_kernel.py:313); the mixes get none."""
    import jax
    import jax.numpy as jnp

    from bcnf_tpu.ops.flow_kernel import _make_fused_flow_train
    from bcnf_tpu_torch.ops.tf32 import matmul_3xtf32
    from tests.test_torch_port_wide_fwd import _wide_kernel_args, _wide_pair

    jm, tm, jp, tp, rng, _ = _wide_pair()
    B = 8
    kargs, h_proj, x = _wide_kernel_args(jm, jp, rng, B)
    S, _, Hp = h_proj.shape
    d_a, nh = kargs["w1y"].shape[1], kargs["wm"].shape[1]
    assert Hp == 1024 and fk.train_bwd_route(Hp, 19, d_a, nh) == fk.ROUTE_WIDE_TRAIN
    dz = rng.normal(size=(B, 19)).astype(np.float32)
    dld = rng.normal(size=(B,)).astype(np.float32)
    f = _make_fused_flow_train(S, nh, d_a, 19 - d_a, Hp, B, "highest", True)
    jargs = (jnp.asarray(x), h_proj, kargs["an_scale"][:, None, :], kargs["an_bias"][:, None, :], kargs["ortho"],
             kargs["w1y"], kargs["b1"][:, None, :], kargs["wm"], kargs["bm"], kargs["wout"], kargs["bout"][:, None, :])
    _, vjp = jax.vjp(f, *jargs)
    ref = [np.asarray(r) for r in vjp((jnp.asarray(dz), jnp.asarray(dld)))]
    assert not np.any(ref.pop(4))  # the mixes' grad
    mm = matmul_3xtf32 if arith == "3xtf32" else torch.matmul
    targs = [torch.from_numpy(np.asarray(kargs[n])) for n in ARG_NAMES]
    hp = torch.from_numpy(np.asarray(h_proj))
    bound = fk.fused_flow_train_reference(torch.from_numpy(x), hp, *targs, mm=mm)[2]
    got = fk.fused_flow_train_backward_reference(bound, hp, torch.from_numpy(dz), torch.from_numpy(dld), *targs, mm=mm)
    for name, a, b in zip(GRAD_NAMES, got, ref):
        np.testing.assert_allclose(a.numpy().reshape(b.shape), b, atol=5e-4, rtol=1e-3, err_msg=name)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_case(cuda, H: int, B: int, S: int, nh: int, size: int, d_a: int, seed: int):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=cuda)

    n_out = 2 * (size - d_a)
    w = {"an_scale": 1 + 0.1 * randn(S, size), "an_bias": 0.1 * randn(S, size),
         "ortho": torch.linalg.qr(randn(S, size, size))[0].contiguous(),
         "w1y": randn(S, d_a, H, scale=d_a ** -0.5), "b1": randn(S, H, scale=0.1),
         "wm": randn(S, nh, H, H, scale=H ** -0.5), "bm": randn(S, nh, H, scale=0.1),
         "wout": randn(S, H, n_out, scale=0.3 * H ** -0.5), "bout": randn(S, n_out, scale=0.1)}
    kargs, h_proj = fk.pad_hidden(w, randn(S, B, H, scale=0.5))
    args = [kargs[n] for n in ARG_NAMES]
    with torch.no_grad():
        bound = fk.fused_flow_train_reference(randn(B, size), h_proj, *args)[2]
    return bound, h_proj, randn(B, size), randn(B), args


@pytest.mark.gpu
@pytest.mark.parametrize("H,B,nh", [(700, 32, 1), (1000, 256, 4), (1024, 4099, 2), (700, 4099, 3), (1000, 257, 4)])
def test_wide_k2b_matches_plain_version_on_card(cuda, H, B, nh):
    """K2b on the wide route (64-row tiles up to 960 rows, 128 above): every
    grad within the JAX grad bar of the float32 plain version (atol
    min(5e-4, 1e-4 max |plain|), rtol 1e-3), no further from the float64
    plain version than the larger of the row tiles' distance (forced) and
    twice the float32 plain version's, equal to the bit between two calls,
    counted on its route; ragged batches, nh 1-4, both widths."""
    bound, h_proj, dz, dld, args = _card_case(cuda, H, B, 3, nh, 19, 10, seed=H + B + nh)
    before = fk.fused_flow_train_bwd.route_launches[fk.ROUTE_WIDE_TRAIN]
    one = fk.fused_flow_train_bwd(bound, h_proj, dz, dld, *args)
    two = fk.fused_flow_train_bwd(bound, h_proj, dz, dld, *args)
    old, fk.WIDE_TRAIN_MAX_TN = fk.WIDE_TRAIN_MAX_TN, 0
    try:
        rows = fk.fused_flow_train_bwd(bound, h_proj, dz, dld, *args)
    finally:
        fk.WIDE_TRAIN_MAX_TN = old
    p32 = fk.fused_flow_train_backward_reference(bound, h_proj, dz, dld, *args)
    p64 = fk.fused_flow_train_backward_reference(bound.double(), h_proj.double(), dz.double(), dld.double(),
                                                 *[a.double() for a in args])
    torch.cuda.synchronize()
    assert fk.fused_flow_train_bwd.route_launches[fk.ROUTE_WIDE_TRAIN] == before + 2
    for name, a, b, r, p, d in zip(GRAD_NAMES, one, two, rows, p32, p64):
        atol = min(5e-4, 1e-4 * p.abs().max().item())
        torch.testing.assert_close(a, p, atol=atol, rtol=1e-3, msg=name)
        assert torch.equal(a, b), name
        dk, dr, dp = ((t.double() - d).abs().max().item() for t in (a, r, p))
        assert dk <= max(dr, 2 * dp), (name, dk, dr, dp)


@pytest.mark.gpu
def test_wide_train_step_prepares_once_and_counts_its_routes(cuda):
    """`fused_flow_train` at Hp 1024 in 3xTF32: K2a on the wide forward and
    K2b on the wide route, one launch each, on one preparation of both
    layouts; its grads equal `fused_flow_train_bwd`'s on the same step
    inputs, to the bit."""
    bound, h_proj, dz, dld, args = _card_case(cuda, 1000, 300, 2, 4, 19, 10, seed=9)
    x = bound[0].clone().requires_grad_(True)
    before = (fk.fused_flow_train_fwd.route_launches[fk.ROUTE_WIDE_FWD],
              fk.fused_flow_train_bwd.route_launches[fk.ROUTE_WIDE_TRAIN])
    z, ld = fk.fused_flow_train(x, h_proj, *args)
    torch.autograd.backward((z, ld), (dz, dld))
    torch.cuda.synchronize()
    assert (fk.fused_flow_train_fwd.route_launches[fk.ROUTE_WIDE_FWD],
            fk.fused_flow_train_bwd.route_launches[fk.ROUTE_WIDE_TRAIN]) == (before[0] + 1, before[1] + 1)
    with torch.no_grad():
        bound_k = fk.fused_flow_train_fwd(bound[0], h_proj, *args)[2]
        direct = fk.fused_flow_train_bwd(bound_k, h_proj, dz, dld, *args)
    assert torch.equal(x.grad, direct[0])
