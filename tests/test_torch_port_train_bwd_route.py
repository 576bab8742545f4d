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
    one-pass row tiles at 768 and 1024; the 3xTF32 mode always takes its row
    tiles."""
    Hp = fk.padded_width(H)
    assert fk.train_bwd_route(Hp, 19, 10, nh, fk.MODE_TF32) == (fk.ROUTE_WGMMA_TF32 if wgmma else fk.ROUTE_ROWS_TF32)
    assert fk.train_bwd_route(Hp, 19, 10, nh, fk.MODE_3XTF32) == fk.ROUTE_ROWS
    assert fk.train_bwd_route(Hp, 19, 10, nh) == fk.ROUTE_ROWS


def test_forced_row_tiles(monkeypatch):
    """`TRAIN_WGMMA_MAX_TN = 0` forces the one-pass row tiles at every width
    the `wgmma` route would take; the 3xTF32 route does not move."""
    monkeypatch.setattr(fk, "TRAIN_WGMMA_MAX_TN", 0)
    for Hp in (32, 128, 544):
        assert fk.train_bwd_route(Hp, 19, 10, 4, fk.MODE_TF32) == fk.ROUTE_ROWS_TF32
        assert fk.train_bwd_route(Hp, 19, 10, 4, fk.MODE_3XTF32) == fk.ROUTE_ROWS


@pytest.mark.parametrize("size,d_a,nh,one_pass,three", [
    (19, 10, 4, "wgmma_tf32", "rows"),     # the flagship
    (38, 19, 4, "rows_tf32", "rows"),      # d_a 19 > the wgmma ring's 16 rows a stage
    (39, 19, 4, None, None),               # past the row tiles' shared memory, and d_a 19
    (19, 10, 13, "wgmma_tf32", "rows"),    # nh 13: 16 weight-grad jobs, the row tiles' most
    (19, 10, 14, "wgmma_tf32", None),      # the wgmma route has no job limit
    (33, 8, 4, "rows_tf32", "rows"),       # n_out 50: past the wgmma rows kernel's shared memory
    (20, 17, 4, "rows_tf32", "rows"),      # d_a 17
    (20, 16, 4, "wgmma_tf32", "rows"),     # d_a 16
], ids=["flagship", "d_a19", "size39", "nh13", "nh14", "n_out50", "d_a17", "d_a16"])
def test_route_falls_back_where_the_wgmma_kernel_refuses_the_shape(size, d_a, nh, one_pass, three):
    """Past what the `wgmma` rows kernel holds (its shared memory; Wout's
    n_out rows and W1y's d_a rows through its weight ring, `tw_takes`) the
    one-pass mode takes the row tiles, and None where those refuse too."""
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
    ([526] * 15, True, False),   # nh 14: the one-pass mode's wgmma route takes it, the 3xTF32 row tiles do not
    ([1100] * 5, False, False),  # past the widest compiled width
], ids=["flagship", "nh14", "width1100"])
def test_training_gate_reads_the_route_of_its_mode(nested, default, highest):
    """`CondRealNVP._fused_train_takes` asks `train_kernels_take` for the
    model's kernel mode: at `precision: default` (one pass) the `wgmma`
    route's limits hold, at `highest` (3xTF32) the row tiles'."""
    assert _model(19, nested, "default")._fused_train_takes() is default
    assert _model(19, nested, "highest")._fused_train_takes() is highest
    Hp = fk.padded_width(nested[0]) if nested[0] <= 1024 else 1056
    assert fk.train_kernels_take(Hp, 19, 10, len(nested) - 1, fk.MODE_TF32) is default


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
