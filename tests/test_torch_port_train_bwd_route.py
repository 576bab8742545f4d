"""K2b's routes (bcnf_tpu_torch/ops/flow_kernel.py: `train_bwd_route`) and
the weight layout of its one-pass `wgmma` route (`prepare_train_weights`),
on the CPU: which kernel each mode and width takes, the limits the
route and the training gate read from the kernel's source, and the prepared
weights against an index model, bit for bit. The kernels themselves run only
on a card (tests/test_torch_port_imports.py, `-m gpu`)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from bcnf_tpu_torch.models import CondRealNVP, ConcatenateCondition, FeatureNetworkStack, LSTMFeatureNetwork
from bcnf_tpu_torch.ops import flow_kernel as fk
from bcnf_tpu_torch.ops.tf32 import round_tf32

CSRC = Path(fk.__file__).resolve().parent / "csrc"


def _constant(name: str) -> int:
    text = (CSRC / "flow_train_wgmma.cu").read_text()
    return int(re.search(rf"constexpr\s+int\s+{name}\s*=\s*(\d+)\s*;", text).group(1))


@pytest.mark.parametrize("nh", [1, 4])
@pytest.mark.parametrize("H,wgmma", [(16, True), (100, True), (526, True), (700, False), (1000, False)])
def test_one_pass_takes_wgmma_up_to_hp_544_and_3xtf32_never(H, wgmma, nh):
    """The one-pass mode takes the `wgmma` route at every padded width up to
    544 (the flagship's), whatever the batch (the route takes none), and the
    wide route's one-pass build at 768 and 1024; the 3xTF32 mode (the
    default) takes its own build of the `wgmma` route at the same widths,
    and the wide route (csrc/flow_wide_train_wgmma.cu) at 768 and 1024."""
    Hp = fk.padded_width(H)
    assert fk.train_bwd_route(Hp, 19, 10, nh, fk.MODE_TF32) == (fk.ROUTE_WGMMA_TF32 if wgmma
                                                                else fk.ROUTE_WIDE_TRAIN_TF32)
    assert fk.train_bwd_route(Hp, 19, 10, nh, fk.MODE_3XTF32) == (fk.ROUTE_WGMMA if wgmma else fk.ROUTE_WIDE_TRAIN)
    assert fk.train_bwd_route(Hp, 19, 10, nh) == (fk.ROUTE_WGMMA if wgmma else fk.ROUTE_WIDE_TRAIN)
    assert fk.TRAIN_BWD_LIBRARY[fk.ROUTE_WGMMA] == "flow_train_wgmma"
    assert fk.TRAIN_BWD_LIBRARY[fk.ROUTE_WIDE_TRAIN] == "flow_wide_train_wgmma"
    assert fk.TRAIN_BWD_LIBRARY[fk.ROUTE_WIDE_TRAIN_TF32] == "flow_wide_train_wgmma_tf32"


def test_forced_row_tiles(monkeypatch):
    """`TRAIN_WGMMA_MAX_TN = 0` forces the row tiles of either mode at every
    width the `wgmma` route would take."""
    monkeypatch.setattr(fk, "TRAIN_WGMMA_MAX_TN", 0)
    for Hp in (32, 128, 544):
        assert fk.train_bwd_route(Hp, 19, 10, 4, fk.MODE_TF32) == fk.ROUTE_ROWS_TF32
        assert fk.train_bwd_route(Hp, 19, 10, 4, fk.MODE_3XTF32) == fk.ROUTE_ROWS


@pytest.mark.parametrize("size,d_a,nh,one_pass,three", [
    (19, 10, 4, "wgmma_tf32", "wgmma"),    # the flagship
    (38, 19, 4, "rows_tf32", "rows"),      # d_a 19 > the 16 rows of Hp/2 floats a wgmma ring stage holds
    (39, 19, 4, None, None),               # past the row tiles' shared memory, and d_a 19
    (19, 10, 13, "wgmma_tf32", "wgmma"),   # nh 13: 16 weight-grad jobs, the row tiles' most
    (19, 10, 14, "wgmma_tf32", "wgmma"),   # the wgmma route has no job limit
    (33, 8, 4, "rows_tf32", "rows"),       # n_out 50: past the wgmma rows kernel's shared memory
    (20, 17, 4, "rows_tf32", "rows"),      # d_a 17
    (20, 16, 4, "wgmma_tf32", "wgmma"),    # d_a 16: W1y fills a stage's floats (one k-step's hi and lo in 3xTF32)
], ids=["flagship", "d_a19", "size39", "nh13", "nh14", "n_out50", "d_a17", "d_a16"])
def test_route_falls_back_where_the_wgmma_kernel_refuses_the_shape(size, d_a, nh, one_pass, three):
    """Past what the `wgmma` rows kernel holds (its shared memory; Wout's
    n_out rows and W1y's d_a rows through its weight ring, `tw_takes`,
    reckoned in a stage's floats in either mode) each mode takes its row
    tiles, and None where those refuse too."""
    assert fk.train_bwd_route(544, size, d_a, nh, fk.MODE_TF32) == one_pass
    assert fk.train_bwd_route(544, size, d_a, nh, fk.MODE_3XTF32) == three


def test_route_rejects_other_modes_and_widths():
    with pytest.raises(ValueError, match="kernel mode"):
        fk.train_bwd_route(544, 19, 10, 4, "default")
    assert fk.train_bwd_route(544, 19, 10, 4, fk.MODE_FMA) == fk.ROUTE_FMA  # strict: the float32 FMA kernels
    assert fk.train_bwd_route(560, 19, 10, 4, fk.MODE_FMA) is None
    assert fk.train_bwd_route(560, 19, 10, 4, fk.MODE_TF32) is None  # not a compiled width
    assert fk.train_bwd_route(544, 19, 0, 4, fk.MODE_TF32) is None


def test_wgmma_rows_kernel_shared_memory_is_the_source_sum():
    """`kernel_smem` of K2b's `wgmma` rows kernel is `tw_smem` term for term,
    from the constants of csrc/flow_train_wgmma.cu: 16 floats of barriers, the
    64-row tile, kTwRing stages of kTwStageK weight rows of half the columns,
    and the rows' state."""
    rows, ring, stage_k = _constant("kTwRows"), _constant("kTwRing"), _constant("kTwStageK")
    assert (rows, _constant("kTwCluster")) == (fk.kernel_limit("kTwRows"), fk.kernel_limit("kTwCluster")) == (64, 2)
    assert (ring, stage_k) == (fk.kernel_limit("kTwRing"), fk.kernel_limit("kTwStageK"))
    for tn in (1, 2, 4, 8, 12, 16, 17):
        Hp = 32 * tn
        for size, d_a in ((19, 10), (5, 3), (21, 11)):
            n_out = 2 * (size - d_a)
            state = rows * (2 * size + 2 * n_out + d_a + 2 * max(n_out, d_a) + 1)
            want = 4 * (16 + rows * (Hp + 4) + ring * stage_k * Hp // 2 + state)
            assert fk.kernel_smem(fk.ROUTE_TRAIN_BWD_WGMMA, Hp, size, d_a) == want
    assert fk.kernel_smem(fk.ROUTE_TRAIN_BWD_WGMMA, 544, 19, 10) <= fk.kernel_limit("kSmemLimit")


def _model(size: int, nested: list[int], precision: str) -> CondRealNVP:
    stack = FeatureNetworkStack([ConcatenateCondition(None, 3), LSTMFeatureNetwork(3, 6, 8, 1)])
    return CondRealNVP(size=size, nested_sizes=nested, n_blocks=3, n_conditions=8, feature_network_stack=stack,
                       act_norm=True, precision=precision)


@pytest.mark.parametrize("nested,default,highest", [
    ([526] * 5, True, True),     # the flagship's MLP
    ([526] * 15, True, True),    # nh 14: both modes' wgmma routes take it (the row tiles would not)
    ([1100] * 5, False, False),  # past the widest compiled width
], ids=["flagship", "nh14", "width1100"])
def test_training_gate_reads_the_route_of_its_mode(nested, default, highest):
    """`CondRealNVP._fused_train_takes` asks `train_kernels_take` for the
    model's kernel mode: at `precision: default` (one pass) the one-pass
    `wgmma` route's limits hold, at `highest` (3xTF32) its 3xTF32 build's (at
    Hp 768 and 1024, the wide route's)."""
    assert _model(19, nested, "default")._fused_train_takes() is default
    assert _model(19, nested, "highest")._fused_train_takes() is highest
    Hp = fk.padded_width(nested[0]) if nested[0] <= 1024 else 1056
    assert fk.train_kernels_take(Hp, 19, 10, len(nested) - 1, fk.MODE_TF32) is default
    assert fk.train_kernels_take(Hp, 19, 10, len(nested) - 1, fk.MODE_3XTF32) is highest


def _index_model(wm: np.ndarray) -> np.ndarray:
    """`prepare_train_weights` element by element: B(k, n) of direction d
    (0: Wm^T, B(k, n) = Wm[k, n]; 1: Wm, B(k, n) = Wm[n, k]) at [rank = n //
    (Hp/2)][k // 8][(n % (Hp/2)) // 8][(k % 8) // 4][n % 8][k % 4]."""
    S, nh, Hp, _ = wm.shape
    out = np.empty((S, nh, 2, 2, Hp // 8, Hp // 16, 2, 8, 4), np.float32)
    for d in range(2):
        for k in range(Hp):
            for n in range(Hp):
                b = wm[:, :, k, n] if d == 0 else wm[:, :, n, k]
                out[:, :, d, n // (Hp // 2), k // 8, (n % (Hp // 2)) // 8, (k % 8) // 4, n % 8, k % 4] = b
    return out


@pytest.mark.parametrize("Hp", [32, 64, 96])
def test_prepare_train_weights_matches_its_index_model(Hp):
    """The prepared weights are the index model's layout of Wm rounded to
    TF32 (round to nearest, ties away: `tf32_rna`), bit for bit; a CPU
    tensor takes the plain version and launches nothing."""
    rng = np.random.default_rng(Hp)
    wm = torch.from_numpy(rng.normal(size=(2, 3, Hp, Hp)).astype(np.float32))
    before = fk.prepare_train_weights.launches
    got = fk.prepare_train_weights(wm)  # a CPU tensor: the plain version, no launch
    want = torch.from_numpy(_index_model(round_tf32(wm).numpy()))
    assert got.shape == (2, 3, 2, 2, Hp // 8, Hp // 16, 2, 8, 4) and got.is_contiguous()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got, fk.prepare_train_weights_reference(wm))
    assert fk.prepare_train_weights.launches == before


def test_prepare_train_weights_stages_are_whole_ring_stages():
    """A rank's part of a layer's direction is contiguous, and a ring stage
    (kTwStageK weight rows of the rank's Hp/2 columns) is a contiguous run of
    it: the kernel moves each with one bulk copy."""
    Hp, stage_k = 544, _constant("kTwStageK")
    n, k = Hp // 2 + 37, 3 * stage_k + 5  # Wm[n, k]: the backward's B(k, n), the recompute's B(n, k)
    wm = torch.zeros(1, 1, Hp, Hp)
    wm[0, 0, n, k] = 3.0
    got = fk.prepare_train_weights(wm)
    for d, rank, stage in ((1, 1, k // stage_k), (0, 0, n // stage_k)):
        part = got[0, 0, d, rank]
        assert part.is_contiguous() and part.numel() == Hp * Hp // 2
        stages = part.reshape(Hp // stage_k, -1)
        assert (stages[stage] == 3.0).sum() == 1 and (part == 3.0).sum() == 1
    assert (got == 3.0).sum() == 2
    with pytest.raises(ValueError, match="multiple of 32"):
        fk.prepare_train_weights(torch.zeros(1, 1, 48, 48))


def test_train_backward_on_cpu_takes_the_plain_version_and_counts_nothing():
    """A CPU tensor takes `fused_flow_train_backward_reference` in the
    one-pass mode as in 3xTF32, whatever the route at its shape, and counts
    no launch."""
    rng = np.random.default_rng(2)
    S, B, size, d_a, H, nh = 2, 40, 5, 3, 32, 1

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32))

    args = [1 + 0.1 * t(S, size), 0.1 * t(S, size), torch.linalg.qr(t(S, size, size))[0].contiguous(),
            t(S, d_a, H, scale=0.5), t(S, H, scale=0.1), t(S, nh, H, H, scale=0.2), t(S, nh, H, scale=0.1),
            t(S, H, 2 * (size - d_a), scale=0.1), t(S, 2 * (size - d_a), scale=0.1)]
    h_proj, bound, dz, dld = t(S, B, H), t(S, B, size), t(B, size), t(B)
    assert fk.train_bwd_route(H, size, d_a, nh, fk.MODE_TF32) == fk.ROUTE_WGMMA_TF32
    before = (fk.fused_flow_train_bwd.launches, dict(fk.fused_flow_train_bwd.route_launches))
    got = fk.fused_flow_train_bwd(bound, h_proj, dz, dld, *args, mode=fk.MODE_TF32)
    want = fk.fused_flow_train_backward_reference(bound, h_proj, dz, dld, *args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (fk.fused_flow_train_bwd.launches, dict(fk.fused_flow_train_bwd.route_launches)) == before


def test_train_bwd_wgmma_parts_patches_apply_to_the_kernel_source():
    """tools/train_bwd_wgmma_parts.py's variants are text patches of
    csrc/flow_train_wgmma.cu: each finds its text exactly once, and changes
    it."""
    import importlib.util

    path = Path(__file__).resolve().parent.parent / "tools" / "train_bwd_wgmma_parts.py"
    spec = importlib.util.spec_from_file_location("train_bwd_wgmma_parts", path)
    parts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parts)
    src = (CSRC / "flow_train_wgmma.cu").read_text()
    for name, pairs in parts.PATCHES.items():
        for old, new in pairs:
            assert src.count(old) == 1 and old != new, name


# ---------------------------------------------------------------------------
# the 3xTF32 routes on `wgmma` (K2a: csrc/flow_fwd_wgmma.cu, K2b: this file's
# kernel, both built as they are into `flow_fwd_wgmma` / `flow_train_wgmma`)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nh", [1, 4])
@pytest.mark.parametrize("H,wgmma", [(16, True), (100, True), (526, True), (700, False), (1000, False)])
def test_3xtf32_training_takes_the_wgmma_routes_up_to_hp_544(H, wgmma, nh):
    """In 3xTF32 (the default mode) K2a takes the 3xTF32 `wgmma` forward and
    K2b the 3xTF32 `wgmma` route at every padded width up to 544; at 768
    and 1024 K2a the wide forward and K2b the wide route; the one-pass
    routes (at 768 and 1024 the wide routes' one-pass builds) and the strict
    ones are their own; the training gate opens wherever it did."""
    Hp = fk.padded_width(H)
    assert fk.flow_route(Hp, 19, 10, False, fk.MODE_3XTF32) == (fk.ROUTE_FWD_WGMMA if wgmma else fk.ROUTE_WIDE_FWD)
    assert fk.train_bwd_route(Hp, 19, 10, nh, fk.MODE_3XTF32) == (fk.ROUTE_WGMMA if wgmma else fk.ROUTE_WIDE_TRAIN)
    assert fk.flow_route(Hp, 19, 10, False, fk.MODE_TF32) == (fk.ROUTE_FWD_WGMMA_TF32 if wgmma
                                                              else fk.ROUTE_WIDE_FWD_TF32)
    assert fk.train_bwd_route(Hp, 19, 10, nh, fk.MODE_TF32) == (fk.ROUTE_WGMMA_TF32 if wgmma
                                                                else fk.ROUTE_WIDE_TRAIN_TF32)
    assert fk.flow_route(Hp, 19, 10, False, fk.MODE_FMA) == fk.ROUTE_FMA
    assert fk.train_bwd_route(Hp, 19, 10, nh, fk.MODE_FMA) == fk.ROUTE_FMA
    assert fk.train_kernels_take(Hp, 19, 10, nh, fk.MODE_3XTF32)
    assert (fk.ROUTE_LIBRARY[fk.ROUTE_FWD_WGMMA], fk.TRAIN_BWD_LIBRARY[fk.ROUTE_WGMMA]) == (
        "flow_fwd_wgmma", "flow_train_wgmma")


def test_3xtf32_stages_hold_one_k_step_of_hi_and_lo_in_the_one_pass_floats():
    """The 3xTF32 builds keep every shared-memory sum of the one-pass ones:
    a ring stage is kTwStageK (kFwStageK) rows of Hp/2 floats in either mode,
    two k-steps of hi in one pass and one k-step of hi and lo in 3xTF32 (the
    sources' kTwParts / kTwSteps, kFwParts / kFwSteps), so `kernel_smem` of
    both routes of each kernel is one sum, and the narrow weights' limits
    (n_out <= kTwRing kTwStageK, d_a <= kTwStageK) are in floats a stage."""
    for name, prefix in (("flow_train_wgmma.cu", "kTw"), ("flow_fwd_wgmma.cu", "kFw")):
        text = (CSRC / name).read_text()
        assert f"constexpr int {prefix}Parts = kPasses == 3 ? 2 : 1;" in text
        assert f"constexpr int {prefix}Steps = {prefix}StageK / 8 / {prefix}Parts;" in text
        assert re.search(rf"constexpr int {prefix}StageK = 16;", text)
        assert "static_assert(bcnf::kPasses == 1" not in text  # built in both modes
    assert 16 // 8 // 1 == 2 and 16 // 8 // 2 == 1  # k-steps a stage: one pass, 3xTF32
    for tn in (1, 2, 4, 8, 12, 16, 17):
        Hp = 32 * tn
        for size, d_a in ((19, 10), (5, 3), (21, 11), (29, 14)):
            assert (fk.kernel_smem(fk.ROUTE_FWD_WGMMA, Hp, size, d_a)
                    == fk.kernel_smem(fk.ROUTE_FWD_WGMMA_TF32, Hp, size, d_a)
                    == fk.fwd_wgmma_smem(Hp, size, d_a, fk.kernel_limit("kFwRingMin")))
    assert fk.kernel_smem(fk.ROUTE_TRAIN_BWD_WGMMA, 544, 19, 10) == 223_552  # one sum for both builds
    assert fk.fwd_wgmma_ring(544, 19, 10) == 4


def _index_model_3xtf32(wm: np.ndarray) -> np.ndarray:
    """`prepare_train_weights(passes=3)` element by element: B(k, n) of
    direction d split into hi = tf32(B) and lo = B - hi, at [rank][k // 8]
    [part: hi 0, lo 1][(n % (Hp/2)) // 8][(k % 8) // 4][n % 8][k % 4]."""
    S, nh, Hp, _ = wm.shape
    hi = round_tf32(torch.from_numpy(wm)).numpy()
    lo = wm - hi
    out = np.empty((S, nh, 2, 2, Hp // 8, 2, Hp // 16, 2, 8, 4), np.float32)
    for d in range(2):
        for k in range(Hp):
            for n in range(Hp):
                for part, v in enumerate((hi, lo)):
                    b = v[:, :, k, n] if d == 0 else v[:, :, n, k]
                    out[:, :, d, n // (Hp // 2), k // 8, part, (n % (Hp // 2)) // 8, (k % 8) // 4, n % 8, k % 4] = b
    return out


@pytest.mark.parametrize("Hp", [32, 64, 96])
def test_prepare_train_weights_3xtf32_matches_its_index_model(Hp):
    """The 3xTF32 layout is the index model's, bit for bit: each k-group's hi
    (Wm rounded to TF32, `tf32_rna`) and then its lo (Wm - hi), so hi + lo is
    Wm exactly; its hi is the one-pass layout. A CPU tensor takes the plain
    version and launches nothing."""
    rng = np.random.default_rng(Hp + 1)
    wm = torch.from_numpy(rng.normal(size=(2, 3, Hp, Hp)).astype(np.float32))
    before = (fk.prepare_train_weights.launches, dict(fk.prepare_train_weights.pass_launches))
    got = fk.prepare_train_weights(wm, passes=3)
    want = torch.from_numpy(_index_model_3xtf32(wm.numpy()))
    assert got.shape == (2, 3, 2, 2, Hp // 8, 2, Hp // 16, 2, 8, 4) and got.is_contiguous()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got, fk.prepare_train_weights_reference(wm, passes=3))
    hi, lo = got[:, :, :, :, :, 0], got[:, :, :, :, :, 1]
    assert torch.equal(hi, fk.prepare_train_weights(wm))
    back = torch.from_numpy(_index_model(wm.numpy()))  # Wm laid out unrounded
    assert torch.equal(hi + lo, back) and torch.equal(lo, back - hi)
    assert (fk.prepare_train_weights.launches, dict(fk.prepare_train_weights.pass_launches)) == before
    with pytest.raises(ValueError, match="1 or 3 passes"):
        fk.prepare_train_weights(wm, passes=2)


def _read_b(part: torch.Tensor, Hp: int, kstep: int, wg: int, which: int) -> torch.Tensor:
    """B (8 x NW) of one warpgroup's product at one k-step, read from a
    rank's prepared part (flat) as the kernels' `wgmma` descriptor reads it
    (wgmma_tf32.cuh): the stage of the k-step (kTwStageK x Hp/2 floats), hi
    (which 0) or lo (which 1, 2 TN x 64 floats on), the warpgroup's n-groups
    from wg TN x 64 floats on; element (k, n) at (n / 8) x sbo 256 B + (k / 4)
    x lbo 128 B + (n % 8) x 16 B + (k % 4) x 4 B."""
    TN = Hp // 32
    NB, NW = Hp // 2, Hp // 4
    stage = 16 * NB
    base = kstep * stage + which * 2 * TN * 64 + wg * TN * 64
    k = torch.arange(8)[:, None]
    n = torch.arange(NW)[None, :]
    return part[base + (n // 8) * 64 + (k // 4) * 32 + (n % 8) * 4 + k % 4]


@pytest.mark.parametrize("Hp", [32, 64, 128])
@pytest.mark.parametrize("direction", [0, 1], ids=["recompute", "backward"])
def test_3xtf32_b_operand_as_the_descriptor_reads_it_gives_matmul_3xtf32(Hp, direction):
    """Read back through the descriptor's addressing, stage by stage, rank by
    rank and warpgroup by warpgroup, the 3xTF32 layout gives B = Wm
    (direction 0: the recompute's h Wm and the forward's) or Wm^T (direction
    1: the backward's da Wm^T) as hi and lo; the three passes on them, a_lo
    b_hi + a_hi b_lo + a_hi b_hi with lo truncated as the tensor cores read
    it, are `matmul_3xtf32` on the raw weights, to the bit."""
    from bcnf_tpu_torch.ops.tf32 import matmul_3xtf32, split_tf32, truncate_tf32

    rng = np.random.default_rng(Hp + direction)
    wm = torch.from_numpy(rng.normal(size=(1, 1, Hp, Hp)).astype(np.float32))
    got = fk.prepare_train_weights(wm, passes=3)
    NB, NW = Hp // 2, Hp // 4
    b_hi, b_lo = torch.empty(Hp, Hp), torch.empty(Hp, Hp)
    for rank in range(2):
        part = got[0, 0, direction, rank].reshape(-1)
        for kstep in range(Hp // 8):
            for wg in range(2):
                cols = slice(rank * NB + wg * NW, rank * NB + (wg + 1) * NW)
                b_hi[8 * kstep: 8 * kstep + 8, cols] = _read_b(part, Hp, kstep, wg, 0)
                b_lo[8 * kstep: 8 * kstep + 8, cols] = _read_b(part, Hp, kstep, wg, 1)
    w = wm[0, 0] if direction == 0 else wm[0, 0].T
    assert torch.equal(b_hi, round_tf32(w)) and torch.equal(b_hi + b_lo, w)
    a = torch.from_numpy(rng.normal(size=(64, Hp)).astype(np.float32))
    a_hi, a_lo = split_tf32(a)
    three = (a_lo @ b_hi + a_hi @ truncate_tf32(b_lo)) + a_hi @ b_hi
    assert torch.equal(three, matmul_3xtf32(a, w))


@pytest.mark.parametrize("mode,H,passes", [
    ("3xtf32", 526, 3), ("3xtf32", 16, 3), ("tf32", 526, 1), ("3xtf32", 1000, "wide"), ("fma", 526, None),
], ids=["3xtf32_544", "3xtf32_32", "one_pass_544", "3xtf32_1024", "strict"])
def test_train_weights_prepares_once_a_step_for_the_mode(monkeypatch, mode, H, passes):
    """A training step's hidden weights (`train_weights`, which
    `_FusedFlowTrain.forward` calls once and hands to K2a and K2b): on a CUDA
    tensor at the widths the `wgmma` routes hold, one preparation in the
    mode's layout (3 passes in 3xTF32, 1 in one pass); in 3xTF32 at 1024,
    where K2b takes the wide route, one of both wide layouts
    (`prepare_wide_train_weights`, 3 passes); none where no route reads them (the
    strict kernels) or on a CPU tensor."""
    import types

    calls = []
    monkeypatch.setattr(fk, "prepare_train_weights", lambda wm, passes=1: calls.append(passes) or "prepared")
    monkeypatch.setattr(fk, "prepare_wide_train_weights",
                        lambda wm, passes=3: calls.append("wide" if passes == 3 else "wide one-pass") or "prepared")
    Hp, B, S, nh = fk.padded_width(H), 64, 3, 4
    x = types.SimpleNamespace(device=torch.device("cuda"), shape=(B, 19))
    h_proj = types.SimpleNamespace(shape=(S, B, Hp))
    wm = types.SimpleNamespace(shape=(S, nh, Hp, Hp))
    got = fk.train_weights(x, h_proj, wm, 10, mode)
    assert (got, calls) == (("prepared", [passes]) if passes else (None, []))
    cpu = types.SimpleNamespace(device=torch.device("cpu"), shape=(B, 19))
    assert fk.train_weights(cpu, h_proj, wm, 10, mode) is None and len(calls) == (1 if passes else 0)


@pytest.mark.parametrize("route,passes,other", [
    (fk.ROUTE_FWD_WGMMA, 3, 1), (fk.ROUTE_FWD_WGMMA_TF32, 1, 3), (fk.ROUTE_WGMMA, 3, 1), (fk.ROUTE_WGMMA_TF32, 1, 3),
], ids=["fwd_3xtf32", "fwd_one_pass", "inverse_3xtf32", "inverse_one_pass"])
def test_wgmma_forward_and_inverse_refuse_weights_laid_out_for_the_other_mode(route, passes, other):
    """A caller's `wstages` reaches a `wgmma` forward or inverse only in the
    layout of the route's own mode (`route_weights`): the other mode's holds
    half or twice the floats the kernel's bulk copies read, so it raises;
    the route's own is handed on as it is."""
    wm = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 3, 64, 64)).astype(np.float32))
    prepare = fk.prepare_weights if route in (fk.ROUTE_WGMMA, fk.ROUTE_WGMMA_TF32) else fk.prepare_train_weights
    own = prepare(wm, passes)
    assert fk.route_weights(route, wm, own) is own
    assert torch.equal(fk.route_weights(route, wm), own)
    for wrong in (prepare(wm, other), own[:1].contiguous(), own.double(), own.transpose(0, 1)):
        with pytest.raises(ValueError, match="wstages"):
            fk.route_weights(route, wm, wrong)


@pytest.mark.parametrize("mode,passes,other", [("3xtf32", 3, 1), ("tf32", 1, 3)])
def test_train_backward_refuses_weights_laid_out_for_the_other_mode(mode, passes, other):
    """K2b's `wgmma` route of either mode takes a caller's `wstages` only in
    its own mode's layout (`prepare_train_weights(wm, passes)`): the other
    mode's raises before any library is loaded or kernel launched."""
    S, B, size, d_a, Hp, nh = 2, 4, 19, 10, 32, 1
    assert fk.train_bwd_route(Hp, size, d_a, nh, mode) in (fk.ROUTE_WGMMA, fk.ROUTE_WGMMA_TF32)
    g = np.random.default_rng(4)

    def t(*shape):
        return torch.from_numpy(g.normal(size=shape).astype(np.float32))

    args = dict(an_scale=t(S, size), an_bias=t(S, size), ortho=t(S, size, size), w1y=t(S, d_a, Hp), b1=t(S, Hp),
                wm=t(S, nh, Hp, Hp), bm=t(S, nh, Hp), wout=t(S, Hp, 2 * (size - d_a)), bout=t(S, 2 * (size - d_a)))
    bound, h_proj, dz, dld = t(S, B, size), t(S, B, Hp), t(B, size), t(B)
    grads = tuple(torch.empty_like(v) for v in (dz, h_proj, *args.values()) if v is not args["ortho"])
    wrong = fk.prepare_train_weights(args["wm"], other)
    with pytest.raises(ValueError, match="wstages"):
        fk._train_bwd_parts(bound, h_proj, dz, dld, args, grads, fk.BWD_ROWS, mode, wrong)
