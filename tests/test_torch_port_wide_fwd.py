"""K1's forward, K2a and K4's forward at the padded widths 768 and 1024 on
their own route, the wide forward (`csrc/flow_wide_wgmma.cu`, the wide
inverse's source): clusters of Hp/128 blocks on a distributed tile, on
tiles of 128 or (up to `WIDE_FWD_HALF_MAX_ROWS` rows) 64 rows; in 3xTF32
the hidden weights streamed once in float32 and split in shared memory,
each 16 k-steps' passes folded into float32 sums; in one pass (the
source's one-pass build) streamed as rounded once a call, one `wgmma` a
k-step into the running sums.

On the CPU: the route (`flow_route`, by mode and shape, for K1, K2a and K4;
`WIDE_FWD_MAX_TN` = 0 forces the row tiles; the other modes and the
narrower widths keep theirs), its shared memory and constants read from the
source, its grid and tile rule, and the wide configuration
(`configs/runs/dev/trajectory_LSTM_xsmall_large_hybrid_dual.yaml`, cut to 2
blocks) against the JAX package: the port's `log_prob` and a
`Trainer.val_step` (their plain path on the CPU), and the plain versions of
K1's forward and K2a (float32, and in the kernels' 3xTF32 and one-pass
arithmetic) against JAX's Pallas kernels in interpret mode. The `gpu` tests hold the
kernel against its plain version on a card:
`python -m pytest tests/test_torch_port_wide_fwd.py -m gpu --noconftest`
(JAX is imported only inside the tests that compare with it)."""

import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from bcnf_tpu_torch.ops import coupling_kernel as ck
from bcnf_tpu_torch.ops import flow_kernel as fk

CSRC = Path(fk.__file__).resolve().parent / "csrc"
WIDE_CONFIG = "{{BCNF_ROOT}}/configs/runs/dev/trajectory_LSTM_xsmall_large_hybrid_dual.yaml"
ARG_NAMES = ("an_scale", "an_bias", "ortho", "w1y", "b1", "wm", "bm", "wout", "bout")


def _source_constant(name: str) -> int:
    return int(re.search(rf"constexpr\s+int\s+{name}\s*=\s*(\d+)\s*;", (CSRC / "flow_wide_wgmma.cu").read_text())
               .group(1))


@pytest.mark.parametrize("Hp", [768, 1024])
def test_wide_forward_takes_the_3xtf32_forward_and_k2a_at_hp_768_and_1024(Hp):
    """The 3xTF32 forward at Hp 768 and 1024 (K1's, K2a's, K4's: one route)
    takes the wide forward, in the wide inverse's library; the one-pass
    forward the same source's one-pass build, strict the FMA kernel, the inverse the wide
    inverse; K2b takes its own wide route (csrc/flow_wide_train_wgmma.cu), so
    the training gate opens as before, and a training step prepares no
    `prepare_train_weights` layout there but the two wide layouts that the
    wide forward (the first) and the wide K2b read
    (`prepare_wide_train_weights`)."""
    assert fk.flow_route(Hp, 19, 10, False, fk.MODE_3XTF32) == fk.ROUTE_WIDE_FWD
    assert fk.flow_route(Hp, 19, 10, False) == fk.ROUTE_WIDE_FWD  # the default mode
    assert fk.ROUTE_LIBRARY[fk.ROUTE_WIDE_FWD] == fk.ROUTE_LIBRARY[fk.ROUTE_WIDE] == "flow_wide_wgmma"
    assert fk.flow_route(Hp, 19, 10, False, fk.MODE_TF32) == fk.ROUTE_WIDE_FWD_TF32
    assert fk.ROUTE_LIBRARY[fk.ROUTE_WIDE_FWD_TF32] == fk.ROUTE_LIBRARY[fk.ROUTE_WIDE_TF32] == "flow_wide_wgmma_tf32"
    assert fk.flow_route(Hp, 19, 10, False, fk.MODE_FMA) == fk.ROUTE_FMA
    assert fk.flow_route(Hp, 19, 10, True, fk.MODE_3XTF32) == fk.ROUTE_WIDE
    assert fk.train_bwd_route(Hp, 19, 10, 4, fk.MODE_3XTF32) == fk.ROUTE_WIDE_TRAIN
    assert fk.train_kernels_take(Hp, 19, 10, 4, fk.MODE_3XTF32)
    cuda_like = types.SimpleNamespace(device=torch.device("cuda"), shape=(64, 19))
    wm = types.SimpleNamespace(shape=(3, 4, Hp, Hp))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fk, "prepare_train_weights", lambda *a, **k: pytest.fail("prepared a wgmma layout"))
        mp.setattr(fk, "prepare_wide_train_weights", lambda w, passes=3: ("wide", w, passes))
        assert fk.train_weights(cuda_like, types.SimpleNamespace(shape=(3, 64, Hp)), wm, 10,
                                fk.MODE_3XTF32) == ("wide", wm, 3)
        assert fk.train_weights(cuda_like, types.SimpleNamespace(shape=(3, 64, Hp)), wm, 10,
                                fk.MODE_TF32) == ("wide", wm, 1)


@pytest.mark.parametrize("Hp", [32, 128, 544])
def test_forward_routes_below_768_do_not_move(Hp):
    """Below Hp 768 every mode's forward keeps its route: the `wgmma` forward
    of the mode, strict the FMA kernel; the inverses theirs."""
    assert fk.flow_route(Hp, 19, 10, False, fk.MODE_3XTF32) == fk.ROUTE_FWD_WGMMA
    assert fk.flow_route(Hp, 19, 10, False, fk.MODE_TF32) == fk.ROUTE_FWD_WGMMA_TF32
    assert fk.flow_route(Hp, 19, 10, False, fk.MODE_FMA) == fk.ROUTE_FMA
    assert fk.flow_route(Hp, 19, 10, True, fk.MODE_3XTF32) == fk.ROUTE_WGMMA
    assert fk.flow_route(Hp, 19, 10, True, fk.MODE_TF32) == fk.ROUTE_WGMMA_TF32


@pytest.mark.parametrize("limit,routes", [(0, (fk.ROUTE_ROWS, fk.ROUTE_ROWS)),
                                          (24, (fk.ROUTE_WIDE_FWD, fk.ROUTE_ROWS)),
                                          (32, (fk.ROUTE_WIDE_FWD, fk.ROUTE_WIDE_FWD))])
def test_wide_forward_limit_forces_the_row_tiles(monkeypatch, limit, routes):
    """`WIDE_FWD_MAX_TN` bounds the widths the wide forward takes in both
    modes: 0 forces the row tiles of the mode at both (as the tools and the
    smoke time them), 24 keeps them at 1024; the inverse (its own limit),
    strict and K2b (the wide route, its own limit) do not move."""
    monkeypatch.setattr(fk, "WIDE_FWD_MAX_TN", limit)
    assert (fk.flow_route(768, 19, 10, False), fk.flow_route(1024, 19, 10, False)) == routes
    one_pass = {fk.ROUTE_ROWS: fk.ROUTE_ROWS_TF32, fk.ROUTE_WIDE_FWD: fk.ROUTE_WIDE_FWD_TF32}
    assert (fk.flow_route(768, 19, 10, False, fk.MODE_TF32),
            fk.flow_route(1024, 19, 10, False, fk.MODE_TF32)) == tuple(one_pass[r] for r in routes)
    for Hp in (768, 1024):
        assert fk.flow_route(Hp, 19, 10, True) == fk.ROUTE_WIDE
        assert fk.flow_route(Hp, 19, 10, False, fk.MODE_FMA) == fk.ROUTE_FMA
        assert fk.train_bwd_route(Hp, 19, 10, 4) == fk.ROUTE_WIDE_TRAIN


@pytest.mark.parametrize("H", [700, 1000])
def test_k4_forward_takes_the_wide_forward(H):
    """K4 is K1 at one step (`coupling_flow_args`): its 3xTF32 forward at
    those widths takes the wide forward, on the layout the wide inverse
    reads too (`prepare_wide_weights`, which K4 keeps once a coupling for
    both directions); a layout of another route is refused; its one-pass
    forward takes the one-pass wide forward, on the one-pass layout, which
    the 3xTF32 route refuses."""
    rng = np.random.default_rng(H)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    args = ck.coupling_flow_args(t(8, H), t(10, H), t(H), [t(H, H) for _ in range(4)], [t(H) for _ in range(4)],
                                 t(H, 18), t(18))
    Hp = args["b1"].shape[-1]
    assert fk.flow_route(Hp, 19, 10, False, fk.MODE_3XTF32) == fk.ROUTE_WIDE_FWD
    assert fk.flow_route(Hp, 19, 10, False, fk.MODE_TF32) == fk.ROUTE_WIDE_FWD_TF32
    one_pass = fk.prepare_wide_weights(args["wm"], passes=1)
    assert torch.equal(fk.route_weights(fk.ROUTE_WIDE_FWD_TF32, args["wm"]), one_pass)
    staged = fk.prepare_wide_weights(args["wm"])
    assert torch.equal(fk.route_weights(fk.ROUTE_WIDE_FWD, args["wm"]), staged)
    assert fk.route_weights(fk.ROUTE_WIDE_FWD, args["wm"], staged) is staged
    for wrong in (fk.prepare_weights(args["wm"]), staged[:, :2].contiguous(), staged.double(), one_pass):
        with pytest.raises(ValueError, match="laid out for its route"):
            fk.route_weights(fk.ROUTE_WIDE_FWD, args["wm"], wrong)


def test_wide_forward_constants_and_grid():
    """The host reads the forward's smaller tile from the source (64 rows:
    one `wgmma` M, the two consumer warpgroups splitting a block's 128
    columns); the grid is a cluster of Hp/128 blocks a tile of the rows
    `wide_fwd_rows` gives, 128 by default and 64 up to
    `WIDE_FWD_HALF_MAX_ROWS`."""
    assert fk.kernel_limit("kWwHalfRows") == _source_constant("kWwHalfRows") == 64
    assert fk.kernel_limit("kWwRows") == 128
    assert fk.wide_grid(4096, 1024, 128) == 32 * 8 and fk.wide_grid(4096, 1024, 64) == 64 * 8
    assert fk.wide_grid(256, 768, 64) == 4 * 6 and fk.wide_grid(257, 768, 128) == 3 * 6
    assert fk.wide_grid(4096, 1024) == fk.wide_grid(4096, 1024, 128)


@pytest.mark.parametrize("half_max", [0, 960, 4096])
def test_wide_forward_tile_rule(monkeypatch, half_max):
    """`wide_fwd_rows`: 64-row tiles up to `WIDE_FWD_HALF_MAX_ROWS` rows,
    128 above (0: always 128)."""
    monkeypatch.setattr(fk, "WIDE_FWD_HALF_MAX_ROWS", half_max)
    for B in (1, 255, 256, 257, 960, 961, 4096, 4097, 80_000):
        assert fk.wide_fwd_rows(B) == (64 if B <= half_max else 128)


@pytest.mark.parametrize("Hp", [768, 1024])
@pytest.mark.parametrize("size,d_a", [(19, 10), (21, 9)])
@pytest.mark.parametrize("rows", [64, 128])
def test_wide_forward_shared_memory_is_the_source_sum_and_fits(Hp, size, d_a, rows):
    """The forward's shared memory (`wide_smem`, the launcher's `ww_smem`):
    the tile of the block's rows x 128 floats (fragment-major, unpadded),
    the hi and lo rings
    (kWwStageK k-steps of 8 x 128 floats a stage), x and the mix's output of
    the rows, the partial [t | s'] of the ceil(rows / C) rows a block
    reduces from each of the C = Hp/128 blocks and [t | s'] of every row,
    the step's W1y, b1 and Wout of the block's 128 columns, the logdet of
    every row, the step's Q, ActNorm scale and bias (to even floats), a
    layer's bias of the block's columns, two barriers a ring stage, three
    hand-off barriers a block and two for the step's weights, and on
    64-row tiles a second tile (two layers' in turn); it lies
    within a block's at the wide
    configuration's size 19 and at 21 on both tiles, `kernel_smem` of the
    route is the 128-row tile's, and the route takes those shapes."""
    K, hi, lo = (_source_constant(n) for n in ("kWwStageK", "kWwHiStages", "kWwLoStages"))
    C, n_out = Hp // 128, 2 * (size - d_a)
    step = (d_a + 1 + n_out) * 128 + rows + (size * size + 2 * size + 1) // 2 * 2 + 128 + (rows * 128 if rows == 64 else 0)
    expected = 4 * (rows * 128 + (hi + lo) * K * 1024 + rows * 2 * size + (C * -(-rows // C) + rows) * n_out
                    + step) + 8 * (2 * (hi + lo) + 3 * C + 2)
    assert fk.wide_smem(Hp, size, d_a, rows, forward=True) == expected <= fk.kernel_limit("kSmemLimit")
    assert fk.kernel_smem(fk.ROUTE_WIDE_FWD, Hp, size, d_a) == fk.wide_smem(Hp, size, d_a, 128, forward=True)
    assert fk.wide_smem(Hp, size, d_a, 128) == fk.kernel_smem(fk.ROUTE_WIDE, Hp, size, d_a)
    assert fk.wide_takes(Hp, size, d_a, forward=True)
    assert fk.flow_route(Hp, size, d_a, False, fk.MODE_3XTF32) == fk.ROUTE_WIDE_FWD


def test_wide_forward_refuses_what_its_shared_memory_cannot_hold():
    """The rows' state, the step's weights and the cluster's partial outputs
    grow with size and d_b: past a block's shared memory the wide forward
    refuses the shape and the row tiles take it (by shape, not by a failed
    launch); the forward's step weights move that edge below the wide
    inverse's by a few sizes, and the wide configuration's size 19 fits."""
    limit = fk.kernel_limit("kSmemLimit")
    for Hp in (768, 1024):
        fits = [size for size in range(12, 80) if fk.kernel_smem(fk.ROUTE_WIDE_FWD, Hp, size, 8) <= limit]
        last = max(fits)
        assert fits == list(range(12, last + 1)) and last < 79
        assert fk.wide_takes(Hp, last, 8, forward=True) and not fk.wide_takes(Hp, last + 1, 8, forward=True)
        assert fk.flow_route(Hp, last + 1, 8, False, fk.MODE_3XTF32) == fk.ROUTE_ROWS
        inverse_last = max(s for s in range(12, 80) if fk.wide_takes(Hp, s, 8))
        assert 19 < last <= inverse_last
    assert not fk.wide_takes(544, 19, 10, forward=True) and not fk.wide_takes(800, 19, 10, forward=True)


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
    params = jm.init(jax.random.key(7))
    rng = np.random.default_rng(8)
    an = params["blocks"]["actnorm"]
    params = dict(params, blocks=dict(params["blocks"], actnorm={
        "scale": an["scale"] + jnp.asarray(0.1 * rng.normal(size=an["scale"].shape).astype(np.float32)),
        "bias": jnp.asarray(0.1 * rng.normal(size=an["bias"].shape).astype(np.float32)),
    }))
    jp = jax.tree.map(np.asarray, jax.device_get(params))
    return jm, tm, jax.tree.map(jnp.asarray, jp), params_from_numpy(jp, "cpu"), rng, (jcfg, tcfg)


def test_wide_config_log_prob_matches_jax():
    """The port's `log_prob` of the wide configuration (the plain path on the
    CPU; on a card, K1's forward on the wide forward) against JAX's on the
    same rows, conditions and weights: atol 1e-4, the JAX package's flow bar
    (tests/test_flow_kernel.py:89-117)."""
    import jax.numpy as jnp

    jm, tm, jp, tp, rng, _ = _wide_pair()
    assert (tm.nested_sizes, tm.size, tm.hybrid) == ([1024] * 5, 19, True)
    assert fk.flow_route(fk.padded_width(1024), tm.size, tm.coupling.d_a, False) == fk.ROUTE_WIDE_FWD
    y = rng.normal(size=(6, 19)).astype(np.float32)
    traj = rng.normal(size=(6, 30, 3)).astype(np.float32)
    with torch.no_grad():
        ours = tm.log_prob(tp, torch.from_numpy(y), torch.from_numpy(traj))
    ref = np.asarray(jm.log_prob(jp, jnp.asarray(y), jnp.asarray(traj)))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4, rtol=0)


def test_wide_config_val_step_matches_jax():
    """One `Trainer.val_step` of the wide configuration (its hybrid weight 1;
    a padded batch, the last row's weight 0), the port's plain path on the
    CPU against the JAX trainer's `val_step` on the same weights and rows:
    the metrics, the weight sum, and z's weighted mean and spread, atol 1e-4
    (the flow bar; the metrics are means of flow outputs)."""
    import jax.numpy as jnp
    import optax

    from bcnf_tpu.train import Trainer as JaxTrainer
    from bcnf_tpu_torch.train import Trainer

    jm, tm, jp, tp, rng, (jcfg, tcfg) = _wide_pair()
    y = rng.normal(size=(6, 19)).astype(np.float32)
    traj = rng.normal(size=(6, 30, 3)).astype(np.float32)
    w = np.array([1, 1, 1, 1, 1, 0], np.float32)
    jax_val = JaxTrainer(jcfg, hybrid_weight=1.0, data=(y, [traj]))._build_steps(jm, optax.adam(1e-3))[1]
    ref = jax_val(jp, jnp.asarray(y), (jnp.asarray(traj),), jnp.asarray(w))
    ours = Trainer(tcfg, hybrid_weight=1.0, data=(y, [traj]), device="cpu").val_step(
        tm, [tp], torch.from_numpy(y), [torch.from_numpy(traj)], torch.from_numpy(w))
    assert len(ours) == len(ref) == 4
    for name, a, b in zip(("metrics", "weight sum", "z mean", "z std"), ours, ref):
        np.testing.assert_allclose(np.asarray(a.numpy(), np.float32), np.asarray(b), atol=1e-4, rtol=0, err_msg=name)


def _wide_kernel_args(jm, jp, rng, rows: int):
    """The wide configuration's stacked, padded kernel arguments (Hp 1024, 2
    steps of 4 hidden layers) for `rows` rows with their own conditions
    (the training layout: h_proj (S, rows, Hp)), and the rows."""
    import jax.numpy as jnp

    traj = rng.normal(size=(rows, 30, 3)).astype(np.float32)
    kargs, h_proj = jm._fused_flow_args(jp, jm.encode(jp, (jnp.asarray(traj),)))
    return kargs, h_proj, rng.normal(size=(rows, 19)).astype(np.float32)


@pytest.mark.parametrize("arith", ["float32", "3xtf32", "tf32"])
def test_wide_config_k1_forward_plain_version_matches_pallas_interpret(arith):
    """K1's forward plain version at the wide configuration's arguments,
    float32 and in the kernel's 3xTF32 arithmetic (`tf32.matmul_3xtf32` for
    every MLP product), against JAX's `fused_flow` forward through its
    Pallas kernel in interpret mode at "highest": z and logdet within atol
    1e-4; the route the card takes at this shape is the wide forward. In the
    one-pass arithmetic (`tf32.matmul_tf32`), against JAX's kernel at
    "default" at its reduced bar, and off float32 (`_check_reduced`); the
    card takes the one-pass wide forward there."""
    import jax.numpy as jnp

    from bcnf_tpu.ops.flow_kernel import fused_flow as jax_fused_flow
    from bcnf_tpu_torch.ops.tf32 import matmul_3xtf32, matmul_tf32
    from tests.test_torch_port_precision import _check_reduced

    jm, tm, jp, tp, rng, _ = _wide_pair()
    kargs, h_proj, x = _wide_kernel_args(jm, jp, rng, 8)
    one = arith == "tf32"
    z_ref, ld_ref = jax_fused_flow(jnp.asarray(x), h_proj, **kargs, inverse=False, n_cond=8, block_b=8,
                                   precision="default" if one else "highest", interpret=True)
    args = {k: torch.from_numpy(np.array(v)) for k, v in kargs.items()}
    mode, route = (fk.MODE_TF32, fk.ROUTE_WIDE_FWD_TF32) if one else (fk.MODE_3XTF32, fk.ROUTE_WIDE_FWD)
    assert h_proj.shape[-1] == 1024 and fk.flow_route(1024, 19, tm.coupling.d_a, False, mode) == route
    mm = {"float32": torch.matmul, "3xtf32": matmul_3xtf32, "tf32": matmul_tf32}[arith]
    hp = torch.from_numpy(np.asarray(h_proj))
    z, ld = fk.fused_flow_reference(torch.from_numpy(x), hp, **args, inverse=False, n_cond=8, mm=mm)
    if one:
        z32, ld32 = fk.fused_flow_reference(torch.from_numpy(x), hp, **args, inverse=False, n_cond=8)
        _check_reduced(z.numpy(), z32.numpy(), np.asarray(z_ref), "z")
        _check_reduced(ld.numpy(), ld32.numpy(), np.asarray(ld_ref).reshape(-1), "logdet")
        return
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=1e-4, rtol=0)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref).reshape(-1), atol=1e-4, rtol=0)


@pytest.mark.parametrize("arith", ["float32", "3xtf32", "tf32"])
def test_wide_k2a_plain_version_matches_pallas_interpret(arith):
    """K2a's plain version at the wide configuration's arguments (Hp 1024, 2
    steps of 4 hidden layers, 8 rows with their own conditions), float32
    and in the kernel's 3xTF32 arithmetic, against JAX's `fwd_call` (the
    forward of `_make_fused_flow_train`'s custom VJP, `_flow_fwd_train_kernel`)
    in interpret mode at "highest": z, logdet and every step's input rows
    (`bound`) within atol 1e-4; step 0's input is the batch itself. In the
    one-pass arithmetic against JAX's at "default", at its reduced bar and
    off float32 (`_check_reduced`)."""
    import jax.numpy as jnp

    from bcnf_tpu.ops.flow_kernel import _make_fused_flow_train
    from bcnf_tpu_torch.ops.tf32 import matmul_3xtf32, matmul_tf32
    from tests.test_torch_port_precision import _check_reduced

    jm, tm, jp, tp, rng, _ = _wide_pair()
    B = 8
    kargs, h_proj, x = _wide_kernel_args(jm, jp, rng, B)
    S, _, Hp = h_proj.shape
    d_a, nh = kargs["w1y"].shape[1], kargs["wm"].shape[1]
    one = arith == "tf32"
    f = _make_fused_flow_train(S, nh, d_a, 19 - d_a, Hp, B, "default" if one else "highest", True)
    (z_ref, ld_ref), res = f.fwd(jnp.asarray(x), h_proj, kargs["an_scale"][:, None, :], kargs["an_bias"][:, None, :],
                                 kargs["ortho"], kargs["w1y"], kargs["b1"][:, None, :], kargs["wm"], kargs["bm"],
                                 kargs["wout"], kargs["bout"][:, None, :])
    assert Hp == 1024 and fk.flow_route(Hp, 19, d_a, False) == fk.ROUTE_WIDE_FWD
    assert fk.flow_route(Hp, 19, d_a, False, fk.MODE_TF32) == fk.ROUTE_WIDE_FWD_TF32
    targs = [torch.from_numpy(np.asarray(kargs[n])) for n in ARG_NAMES]
    hp = torch.from_numpy(np.asarray(h_proj))
    mm = {"float32": torch.matmul, "3xtf32": matmul_3xtf32, "tf32": matmul_tf32}[arith]
    z, ld, bound = fk.fused_flow_train_reference(torch.from_numpy(x), hp, *targs, mm=mm)
    if one:
        f32 = fk.fused_flow_train_reference(torch.from_numpy(x), hp, *targs)
        for name, a, a32, r in zip(("z", "logdet"), (z, ld), f32, (z_ref, ld_ref)):
            _check_reduced(a.numpy(), a32.numpy(), np.asarray(r), name)
        _check_reduced(bound[1:].numpy(), f32[2][1:].numpy(), np.asarray(res[0])[1:], "bound")
        np.testing.assert_array_equal(bound[0].numpy(), x)
        return
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=1e-4, rtol=0)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref), atol=1e-4, rtol=0)
    np.testing.assert_allclose(bound.numpy(), np.asarray(res[0]), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(bound[0].numpy(), x)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_args(cuda, H: int, S: int, nh: int, size: int, d_a: int, N: int, seed: int):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=cuda)

    n_out = 2 * (size - d_a)
    w = {"an_scale": 1 + 0.1 * randn(S, size), "an_bias": 0.1 * randn(S, size),
         "ortho": torch.linalg.qr(randn(S, size, size))[0].contiguous(),
         "w1y": randn(S, d_a, H, scale=d_a ** -0.5), "b1": randn(S, H, scale=0.1),
         "wm": randn(S, nh, H, H, scale=H ** -0.5), "bm": randn(S, nh, H, scale=0.1),
         "wout": randn(S, H, n_out, scale=0.3 * H ** -0.5), "bout": randn(S, n_out, scale=0.1)}
    kargs, h_proj = fk.pad_hidden(w, randn(S, N, H, scale=0.5))
    return kargs, h_proj, randn(4099, size)


def _from64(outs, p64) -> list[float]:
    return [(a.double() - b).abs().max().item() for a, b in zip(outs, p64)]


@pytest.mark.gpu
@pytest.mark.parametrize("half_max", [0, 1 << 30], ids=["128-row tiles", "64-row tiles"])
@pytest.mark.parametrize("H,B,nh,size,d_a", [(700, 257, 4, 19, 10), (1000, 4099, 4, 19, 10), (1024, 65, 1, 21, 9),
                                             (1024, 323, 0, 19, 10)])
def test_wide_forward_matches_plain_version_on_card(cuda, monkeypatch, half_max, H, B, nh, size, d_a):
    """K1's forward on the wide forward, each tile: within 1e-4 of the
    float32 plain version, z and logdet no further from the float64 plain
    version than the larger of the row tiles' distance (forced) and twice
    the float32 plain version's, equal to the bit between two calls, counted
    on its route; ragged rows, N = 7 not dividing B, no hidden layer."""
    monkeypatch.setattr(fk, "WIDE_FWD_HALF_MAX_ROWS", half_max)
    S, N = 3, 7
    kargs, h_proj, x = _card_args(cuda, H, S, nh, size, d_a, N, seed=H + B)
    x = x[:B].contiguous()
    before = fk.fused_flow.route_launches[fk.ROUTE_WIDE_FWD]
    with torch.no_grad():
        one = fk.fused_flow(x, h_proj, **kargs, inverse=False, n_cond=N)
        two = fk.fused_flow(x, h_proj, **kargs, inverse=False, n_cond=N)
        monkeypatch.setattr(fk, "WIDE_FWD_MAX_TN", 0)
        rows = fk.fused_flow(x, h_proj, **kargs, inverse=False, n_cond=N)
        p32 = fk.fused_flow_reference(x, h_proj, **kargs, inverse=False, n_cond=N)
        p64 = fk.fused_flow_reference(x.double(), h_proj.double(), **{k: v.double() for k, v in kargs.items()},
                                      inverse=False, n_cond=N)
        torch.cuda.synchronize()
    assert fk.fused_flow.route_launches[fk.ROUTE_WIDE_FWD] == before + 2
    for a, b, c in zip(one, two, p32):
        torch.testing.assert_close(a, c, atol=1e-4, rtol=0)
        assert torch.equal(a, b)
    for dk, dr, dp in zip(_from64(one, p64), _from64(rows, p64), _from64(p32, p64)):
        assert dk <= max(dr, 2 * dp)


@pytest.mark.gpu
@pytest.mark.parametrize("H,B", [(700, 257), (1000, 4099)])
def test_wide_k2a_matches_plain_version_on_card(cuda, H, B):
    """K2a on the wide forward with its step-input store: z, logdet and every
    step's input rows within 1e-4 of the float32 plain version and no
    further from the float64 one than max(row tiles, twice the float32 plain
    version), equal to the bit between calls, counted on its route."""
    S, nh, size, d_a = 3, 4, 19, 10
    kargs, h_proj, x = _card_args(cuda, H, S, nh, size, d_a, B, seed=H)
    x = x[:B].contiguous()
    args = [kargs[n] for n in ARG_NAMES]
    before = fk.fused_flow_train_fwd.route_launches[fk.ROUTE_WIDE_FWD]
    with torch.no_grad():
        one = fk.fused_flow_train_fwd(x, h_proj, *args)
        two = fk.fused_flow_train_fwd(x, h_proj, *args)
        old, fk.WIDE_FWD_MAX_TN = fk.WIDE_FWD_MAX_TN, 0
        try:
            rows = fk.fused_flow_train_fwd(x, h_proj, *args)
        finally:
            fk.WIDE_FWD_MAX_TN = old
        p32 = fk.fused_flow_train_reference(x, h_proj, *args)
        p64 = fk.fused_flow_train_reference(x.double(), h_proj.double(), *[a.double() for a in args])
        torch.cuda.synchronize()
    assert fk.fused_flow_train_fwd.route_launches[fk.ROUTE_WIDE_FWD] == before + 2
    for a, b, c in zip(one, two, p32):
        torch.testing.assert_close(a, c, atol=1e-4, rtol=0)
        assert torch.equal(a, b)
    for dk, dr, dp in zip(_from64(one, p64), _from64(rows, p64), _from64(p32, p64)):
        assert dk <= max(dr, 2 * dp)


@pytest.mark.gpu
def test_wide_k4_forward_on_card(cuda):
    """K4's 3xTF32 forward at Hp 1024 runs K1's wide forward at one step:
    within 1e-4 of its plain version, counted in K4's launches; the
    coupling's wide layout is prepared once and serves both directions."""
    rng = np.random.default_rng(1)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32)).to(cuda)

    H = 1000
    x_a, x_b, hp = t(4099, 10), t(4099, 9), t(8, H, scale=0.5)
    weights = dict(w1y=t(10, H, scale=0.3), b1=t(H, scale=0.1), wm=[t(H, H, scale=H ** -0.5) for _ in range(4)],
                   bm=[t(H, scale=0.1) for _ in range(4)], wout=t(H, 18, scale=0.01), bout=t(18, scale=0.1))
    before = ck.fused_affine_coupling.launches, ck.fused_affine_coupling.stage_preparations
    with torch.no_grad():
        zb, ld = ck.fused_affine_coupling(x_a, x_b, hp, **weights, n_cond=8)
        ck.fused_affine_coupling(x_a, x_b, hp, **weights, inverse=True, n_cond=8)
        ref = ck.fused_affine_coupling_reference(x_a, x_b, hp, **weights, inverse=False, n_cond=8)
        torch.cuda.synchronize()
    assert (ck.fused_affine_coupling.launches, ck.fused_affine_coupling.stage_preparations) == (
        before[0] + 2, before[1] + 1)
    torch.testing.assert_close(zb, ref[0], atol=1e-4, rtol=0)
    torch.testing.assert_close(ld, ref[1], atol=1e-4, rtol=0)


ONE_PASS_BAR = 5e-3  # JAX's reduced-mode bar (tests/test_flow_kernel.py:130-141)


def _one_pass_check(one, two, rows, p1) -> None:
    """The one-pass route's outputs `one` against the plain one-pass version
    `p1`: within the reduced bar, no further than twice the one-pass row
    tiles' (forced) distance (plus 4 float32 steps), and equal to the bit to
    a second call's `two`."""
    for a, b, r, p in zip(one, two, rows, p1):
        dk, dr = (a - p).abs().max().item(), (r - p).abs().max().item()
        eps = 4 * float(torch.finfo(torch.float32).eps) * max(1.0, p.abs().max().item())
        assert dk <= ONE_PASS_BAR and dk <= 2 * dr + eps, (dk, dr)
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("half_max", [0, 1 << 30], ids=["128-row tiles", "64-row tiles"])
@pytest.mark.parametrize("H,B,nh,size,d_a", [(700, 257, 4, 19, 10), (1000, 4099, 4, 19, 10), (1024, 65, 1, 21, 9),
                                             (1024, 323, 0, 19, 10)])
def test_wide_one_pass_forward_matches_plain_version_on_card(cuda, monkeypatch, half_max, H, B, nh, size, d_a):
    """K1's forward on the one-pass wide forward, each tile: z and logdet
    within the reduced bar of the plain one-pass version, no further from it
    than twice the one-pass row tiles (forced), equal to the bit between two
    calls, counted on its route; ragged rows, N = 7, no hidden layer."""
    from bcnf_tpu_torch.ops.tf32 import matmul_tf32

    monkeypatch.setattr(fk, "WIDE_FWD_HALF_MAX_ROWS", half_max)
    S, N = 3, 7
    kargs, h_proj, x = _card_args(cuda, H, S, nh, size, d_a, N, seed=H + B + 2)
    x = x[:B].contiguous()
    before = fk.fused_flow.route_launches[fk.ROUTE_WIDE_FWD_TF32]
    with torch.no_grad():
        one = fk.fused_flow(x, h_proj, **kargs, inverse=False, n_cond=N, mode=fk.MODE_TF32)
        two = fk.fused_flow(x, h_proj, **kargs, inverse=False, n_cond=N, mode=fk.MODE_TF32)
        monkeypatch.setattr(fk, "WIDE_FWD_MAX_TN", 0)
        rows = fk.fused_flow(x, h_proj, **kargs, inverse=False, n_cond=N, mode=fk.MODE_TF32)
        p1 = fk.fused_flow_reference(x, h_proj, **kargs, inverse=False, n_cond=N, mm=matmul_tf32)
        torch.cuda.synchronize()
    assert fk.fused_flow.route_launches[fk.ROUTE_WIDE_FWD_TF32] == before + 2
    _one_pass_check(one, two, rows, p1)


@pytest.mark.gpu
@pytest.mark.parametrize("H,B", [(700, 257), (1000, 4099)])
def test_wide_one_pass_k2a_matches_plain_version_on_card(cuda, H, B):
    """K2a on the one-pass wide forward with its step-input store: z, logdet
    and every step's input rows within the reduced bar of the plain one-pass
    version and no further than twice the one-pass row tiles, equal to the
    bit between calls, counted on its route and mode; on the step's one-pass
    layout (`train_weights`) or its own, the same bits."""
    from bcnf_tpu_torch.ops.tf32 import matmul_tf32

    S, nh, size, d_a = 3, 4, 19, 10
    kargs, h_proj, x = _card_args(cuda, H, S, nh, size, d_a, B, seed=H + 3)
    x = x[:B].contiguous()
    args = [kargs[n] for n in ARG_NAMES]
    before = (fk.fused_flow_train_fwd.route_launches[fk.ROUTE_WIDE_FWD_TF32],
              fk.fused_flow_train_fwd.mode_launches[fk.MODE_TF32])
    with torch.no_grad():
        ws = fk.train_weights(x, h_proj, kargs["wm"], d_a, fk.MODE_TF32)
        one = fk.fused_flow_train_fwd(x, h_proj, *args, mode=fk.MODE_TF32, wstages=ws)
        two = fk.fused_flow_train_fwd(x, h_proj, *args, mode=fk.MODE_TF32)
        old, fk.WIDE_FWD_MAX_TN = fk.WIDE_FWD_MAX_TN, 0
        try:
            rows = fk.fused_flow_train_fwd(x, h_proj, *args, mode=fk.MODE_TF32)
        finally:
            fk.WIDE_FWD_MAX_TN = old
        p1 = fk.fused_flow_train_reference(x, h_proj, *args, mm=matmul_tf32)
        torch.cuda.synchronize()
    assert (fk.fused_flow_train_fwd.route_launches[fk.ROUTE_WIDE_FWD_TF32],
            fk.fused_flow_train_fwd.mode_launches[fk.MODE_TF32]) == (before[0] + 2, before[1] + 3)
    _one_pass_check(one, two, rows, p1)


@pytest.mark.gpu
def test_wide_one_pass_k4_forward_on_card(cuda):
    """K4's one-pass forward at Hp 1024 runs the one-pass wide forward at one
    step: within the reduced bar of its plain one-pass version, counted in
    K4's launches; the coupling's one-pass layout, prepared once, serves
    both directions."""
    from bcnf_tpu_torch.ops.tf32 import matmul_tf32

    rng = np.random.default_rng(4)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32)).to(cuda)

    H = 1000
    x_a, x_b, hp = t(4099, 10), t(4099, 9), t(8, H, scale=0.5)
    weights = dict(w1y=t(10, H, scale=0.3), b1=t(H, scale=0.1), wm=[t(H, H, scale=H ** -0.5) for _ in range(4)],
                   bm=[t(H, scale=0.1) for _ in range(4)], wout=t(H, 18, scale=0.01), bout=t(18, scale=0.1))
    before = ck.fused_affine_coupling.launches, ck.fused_affine_coupling.stage_preparations
    with torch.no_grad():
        zb, ld = ck.fused_affine_coupling(x_a, x_b, hp, **weights, n_cond=8, mode=fk.MODE_TF32)
        ck.fused_affine_coupling(x_a, x_b, hp, **weights, inverse=True, n_cond=8, mode=fk.MODE_TF32)
        ref = ck.fused_affine_coupling_reference(x_a, x_b, hp, **weights, inverse=False, n_cond=8, mm=matmul_tf32)
        torch.cuda.synchronize()
    assert (ck.fused_affine_coupling.launches, ck.fused_affine_coupling.stage_preparations) == (
        before[0] + 2, before[1] + 1)
    assert (zb - ref[0]).abs().max().item() <= ONE_PASS_BAR and (ld - ref[1]).abs().max().item() <= ONE_PASS_BAR
