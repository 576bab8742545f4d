"""Strict training (`CondRealNVP(pallas_strict=True)` at "highest"/"float32"):
K2a and K2b in exact float32, the counterparts of JAX's training kernels at
`precision="highest"` (bcnf_tpu/ops/flow_kernel.py: `fwd_call`, `bwd_call`
of `_make_fused_flow_train`), on the float32 FMA kernels
(csrc/flow_fma.cu's `fma_flow_train_kernel`, csrc/flow_train_fma.cu).

On the CPU: the strict model's loss and grads through `forward_fused_flow`
against JAX's strict model trained through its Pallas kernels in interpret
mode (the JAX grad bars, tests/test_flow_kernel.py:307, 313); the modes (K2a
and K2b float32 FMA, K4 unchanged); the routes, which take every shape the
3xTF32 K2b takes, and the limits they read from the kernel's source. The
`gpu` tests hold the kernels against their plain versions on a card:
`python -m pytest tests/test_torch_port_strict_train.py -m gpu --noconftest`
(JAX is imported only inside the tests that compare with it, so the file
also runs where JAX is not installed)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from bcnf_tpu_torch.models import (
    CondRealNVP,
    ConcatenateCondition,
    FeatureNetworkStack,
    FullyConnectedFeatureNetwork,
    LSTMFeatureNetwork,
)
from bcnf_tpu_torch.ops import flow_kernel as fk

CSRC = Path(fk.__file__).resolve().parent / "csrc"
SIZE, N_COND_FEATURES, NESTED, N_BLOCKS, B = 7, 16, [32, 32, 32], 4, 16
ARG_NAMES = ("an_scale", "an_bias", "ortho", "w1y", "b1", "wm", "bm", "wout", "bout")
GRAD_NAMES = ("x", "h_proj", "an_scale", "an_bias", "w1y", "b1", "wm", "bm", "wout", "bout")


def _port_model(precision: str = "highest", strict: bool = True) -> CondRealNVP:
    stack = FeatureNetworkStack([ConcatenateCondition(input_size=None, output_size=6),
                                 FullyConnectedFeatureNetwork(sizes=[6, 32, N_COND_FEATURES])])
    return CondRealNVP(size=SIZE, nested_sizes=NESTED, n_blocks=N_BLOCKS, n_conditions=N_COND_FEATURES,
                       feature_network_stack=stack, act_norm=True, random_state=0, precision=precision,
                       pallas_strict=strict)


# ---------------------------------------------------------------------------
# (a) the strict model against JAX's, trained through its kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["highest", "float32"])
def test_strict_training_matches_jax_strict_kernels(precision, monkeypatch):
    """The NLL and every param's grad of a strict model through
    `forward_fused_flow` on CPU tensors (K2a, K2b: their float32 plain
    versions) against JAX's strict model through its training kernels at
    "highest" in interpret mode, on weights bridged from JAX's."""
    _strict_against_jax(precision, monkeypatch, B, None)


def test_strict_chunked_training_matches_jax_strict_kernels(monkeypatch):
    """The same with the strict backward forced into uneven row chunks (100
    rows in chunks of 32, 32 and 36: `fused_flow_train(chunk_rows=32)`, the
    plain backward a chunk and the grads summed over the chunks), against
    JAX's strict training on the whole batch, at the JAX grad bars."""
    _strict_against_jax("highest", monkeypatch, 100, 32)


def _strict_against_jax(precision: str, monkeypatch, rows: int, chunk_rows: int | None) -> None:
    import jax
    import jax.numpy as jnp

    from bcnf_tpu.models import CondRealNVP as JaxCondRealNVP
    from bcnf_tpu.models import ConcatenateCondition as JaxConcat
    from bcnf_tpu.models import FeatureNetworkStack as JaxStack
    from bcnf_tpu.models import FullyConnectedFeatureNetwork as JaxFC
    from bcnf_tpu.models.cnf import spmd_local
    from bcnf_tpu.ops import flow_kernel as jax_fk
    from bcnf_tpu.utils.misc import inn_nll_loss as jax_nll
    from bcnf_tpu_torch.bridge import map_tree, params_from_numpy, tree_leaves
    from bcnf_tpu_torch.utils.misc import inn_nll_loss

    stack = JaxStack([JaxConcat(input_size=None, output_size=6), JaxFC(sizes=[6, 32, N_COND_FEATURES])])
    jm = JaxCondRealNVP(size=SIZE, nested_sizes=NESTED, n_blocks=N_BLOCKS, n_conditions=N_COND_FEATURES,
                        feature_network_stack=stack, act_norm=True, random_state=0, precision=precision,
                        pallas_strict=True)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    rng = np.random.default_rng(0)
    an = jp["blocks"]["actnorm"]  # off identity, so the ActNorm grads are exercised
    an["scale"] = (1.0 + 0.2 * rng.normal(size=(N_BLOCKS - 1, SIZE))).astype(np.float32)
    an["bias"] = (0.2 * rng.normal(size=(N_BLOCKS - 1, SIZE))).astype(np.float32)
    y = rng.normal(size=(rows, SIZE)).astype(np.float32)
    cond = rng.normal(size=(rows, 6)).astype(np.float32)

    seen = []
    real = jax_fk.fused_flow_train
    monkeypatch.setattr(jax_fk, "fused_flow_train",
                        lambda *a, **kw: seen.append((kw["precision"], kw["interpret"])) or real(*a, **kw))
    monkeypatch.setenv("BCNF_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("BCNF_FUSED_TRAIN_MIN_BATCH", "1")

    def jax_loss(p):
        z, ld = jm.forward(p, jnp.asarray(y), jnp.asarray(cond), train=True)
        return jax_nll(z, ld)

    with spmd_local():
        v_ref, g_ref = jax.value_and_grad(jax_loss)(jax.tree.map(jnp.asarray, jp))
    assert seen and set(seen) == {("highest", True)}  # JAX's exact-float32 training kernels ran

    tm = _port_model(precision)
    assert tm.train_kernel_mode == fk.MODE_FMA
    modes, chunked = [], []
    real_train, real_chunks = fk.fused_flow_train, fk._strict_train_bwd_chunks
    monkeypatch.setattr(fk, "fused_flow_train",
                        lambda *a, **kw: modes.append(kw["mode"]) or real_train(*a, **kw, chunk_rows=chunk_rows))
    monkeypatch.setattr(fk, "_strict_train_bwd_chunks",
                        lambda *a: chunked.append(a[-1]) or real_chunks(*a))
    tp = params_from_numpy(jp, "cpu", requires_grad=True)
    h = tm.encode(tp, (torch.from_numpy(cond),))
    z, ld = tm.forward_fused_flow(tp, torch.from_numpy(y), h)
    loss = inn_nll_loss(z, ld)
    loss.backward()
    assert modes == [fk.MODE_FMA]
    assert chunked == ([] if chunk_rows is None else [fk.row_chunks(rows, chunk_rows)])
    np.testing.assert_allclose(loss.item(), float(v_ref), atol=1e-5, rtol=0)
    flat_ref = jax.tree.leaves_with_path(jax.tree.map(np.asarray, g_ref))
    ours = list(tree_leaves(map_tree(lambda t: t.grad, tp)))
    assert len(ours) == len(flat_ref)
    for (path, ref), g in zip(flat_ref, ours):
        if "ortho" in jax.tree_util.keystr(path):
            assert (g is None or not g.any()) and not np.any(ref)  # the fixed mixes: zero grads in both packages
            continue
        np.testing.assert_allclose(g.numpy(), ref, atol=5e-4, rtol=1e-3, err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# (b) the modes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision,strict,train,coupling", [
    ("highest", True, fk.MODE_FMA, fk.MODE_3XTF32),
    ("float32", True, fk.MODE_FMA, fk.MODE_3XTF32),
    ("highest", False, fk.MODE_3XTF32, fk.MODE_3XTF32),
    ("default", True, fk.MODE_TF32, fk.MODE_TF32),
    ("BF16_BF16_F32_X6", True, None, None),
])
def test_strict_sets_the_training_kernels_mode_and_not_k4s(precision, strict, train, coupling):
    """Strict at "highest"/"float32" runs K2a/K2b in float32 FMA, as JAX's
    `forward_fused_flow` takes its "highest" kernel mode; K4 keeps the
    precision's mode (JAX's K4 takes no strict flag); the training gate
    opens wherever its shape is taken, in that mode."""
    model = _port_model(precision, strict)
    assert model.train_kernel_mode == train and model.coupling_kernel_mode == coupling
    assert model.train_kernel_mode == model.kernel_mode
    if train is not None:
        assert model._fused_train_takes()


def test_strict_per_coupling_path_hands_k4_its_tensor_core_mode(monkeypatch):
    """With `use_pallas_coupling`, a strict model's per-coupling inverse and
    forward hand K4 the 3xTF32 mode (the gate opened on CPU tensors)."""
    model = _port_model()
    model.use_pallas_coupling = True
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    seen = []
    for name in ("forward_fused", "inverse_fused"):
        real = getattr(model.coupling, name)
        monkeypatch.setattr(model.coupling, name,
                            lambda p, x, proj, mode, real=real: seen.append(mode) or real(p, x, proj, mode))
    monkeypatch.setattr(CondRealNVP, "_use_fused", lambda self, train, x, *trees: True)
    cond = torch.randn((5, 6), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        z = torch.randn((5, SIZE), generator=torch.Generator().manual_seed(2))
        model.inverse(params, z, cond)
        model.forward(params, z, cond)
    assert seen and set(seen) == {fk.MODE_3XTF32}


def test_fused_flow_train_takes_the_strict_mode_on_the_cpu():
    """On CPU tensors `fused_flow_train(mode=MODE_FMA)` is its float32 plain
    version, forward and backward, and counts nothing."""
    model = _port_model()
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(3)
    h = model.encode(params, (torch.from_numpy(rng.normal(size=(B, 6)).astype(np.float32)),))
    kargs, h_proj = model._fused_flow_args(params, h.detach())
    args = [kargs[n] for n in ARG_NAMES]
    x = torch.from_numpy(rng.normal(size=(B, SIZE)).astype(np.float32))
    before = (fk.fused_flow_train_fwd.launches, fk.fused_flow_train_bwd.launches)
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, h_proj, *args)]
    z, ld = fk.fused_flow_train(*leaves, mode=fk.MODE_FMA)
    z_r, ld_r, bound = fk.fused_flow_train_reference(x, h_proj.detach(), *[a.detach() for a in args])
    assert torch.equal(z, z_r) and torch.equal(ld, ld_r)
    dz, dld = torch.randn_like(z), torch.randn_like(ld)
    grads = torch.autograd.grad((z, ld), leaves, grad_outputs=(dz, dld))
    refs = fk.fused_flow_train_backward_reference(bound, h_proj.detach(), dz, dld, *[a.detach() for a in args])
    for name, g, r in zip(GRAD_NAMES, [g for i, g in enumerate(grads) if i != 4], refs):
        assert torch.equal(g, r), name
    assert (fk.fused_flow_train_fwd.launches, fk.fused_flow_train_bwd.launches) == before


# ---------------------------------------------------------------------------
# (c) the routes and the limits they read from the kernel's source
# ---------------------------------------------------------------------------


def _source_constant(name: str, source: str = "flow_train_fma.cu") -> int:
    text = (CSRC / source).read_text()
    return int(re.search(rf"constexpr\s+int\s+{name}\s*=\s*(\d+)\s*;", text).group(1))


def test_strict_training_constants_are_read_from_the_kernel_source():
    """The route's job limit (a step's nh + 3 weight-grad jobs) is the
    source's `kFtMaxJobs`, the weight-grad pass's output tile and rows a stage
    its `kFtTile` and `kFtK`; the rows kernel's ring bounds are the strict
    K1's (`kFmaRingMin`, `kFmaRingMax`), whose device parts it includes."""
    assert fk.kernel_limit("kFtMaxJobs") == _source_constant("kFtMaxJobs") == 32
    assert fk.kernel_limit("kFtTile") == _source_constant("kFtTile") == 128
    assert fk.kernel_limit("kFtK") == _source_constant("kFtK") == 32
    for name in ("kFmaRingMin", "kFmaRingMax", "kFmaStageRows", "kFmaLaneRows", "kFmaWideTN"):
        assert fk.kernel_limit(name) == _source_constant(name, "flow_fma.cu")
    assert '#include "flow_fma.cu"' in (CSRC / "flow_train_fma.cu").read_text()


@pytest.mark.parametrize("tn", fk.KERNEL_TN)
def test_strict_training_routes_take_every_shape_the_3xtf32_k2b_takes(tn):
    """At every compiled width, size, split and depth where the 3xTF32 K2b
    has a route, the strict K2b and the strict K2a have theirs (the FMA
    kernels); nh 0 and splits outside (0, size) have none."""
    Hp, taken = 32 * tn, 0
    for size in range(2, 40, 3):
        for d_a in sorted({1, size // 2, (size + 1) // 2, size - 1}):
            for nh in (1, 2, 4, 13):
                if fk.train_bwd_route(Hp, size, d_a, nh, fk.MODE_3XTF32) is None:
                    continue
                taken += 1
                assert fk.train_bwd_route(Hp, size, d_a, nh, fk.MODE_FMA) == fk.ROUTE_FMA, (Hp, size, d_a, nh)
                assert fk.flow_route(Hp, size, d_a, False, fk.MODE_FMA) == fk.ROUTE_FMA
                assert fk.train_kernels_take(Hp, size, d_a, nh, fk.MODE_FMA)
    assert taken > 50
    assert fk.train_bwd_route(Hp, 19, 10, 0, fk.MODE_FMA) is None
    assert fk.train_bwd_route(Hp, 19, 19, 4, fk.MODE_FMA) is None
    assert fk.train_bwd_route(Hp, 19, 10, fk.kernel_limit("kFtMaxJobs") - 2, fk.MODE_FMA) is None
    assert fk.TRAIN_BWD_LIBRARY[fk.ROUTE_FMA] == "flow_train_fma" and fk.ROUTE_LIBRARY[fk.ROUTE_FMA] == "flow_fma"


@pytest.mark.parametrize("tn", fk.KERNEL_TN)
def test_strict_training_shared_memory_is_the_source_sum(tn):
    """`fma_train_smem` is `ft_smem`: the ring's barriers, the strict K1's
    transposed tile, the ring of `ft_stage` floats a stage (the strict K1's
    stage, and at least 4 rows of W1y^T, d_a rounded up to even), and the
    round's rows of the backward's state; the layout takes as many stages as
    fit, and the route closes where even the shortest ring does not."""
    Hp, limit = 32 * tn, fk.kernel_limit("kSmemLimit")
    R = fk.fma_lane_rows(Hp)
    for size, d_a in ((19, 10), (7, 4), (38, 19), (120, 60), (200, 100)):
        d_ap = d_a + d_a % 2
        stage = max(fk.fma_stage(Hp, size, d_a), 4 * d_ap)
        assert fk.fma_train_stage(Hp, size, d_a) == stage

        def smem(stages):
            return 16 * stages + 4 * (Hp * (8 * R + 4) + stages * stage
                                      + 8 * R * (4 * size + 3 * (size - d_a) + d_ap + 1))

        assert fk.kernel_smem(fk.ROUTE_TRAIN_BWD_FMA, Hp, size, d_a) == smem(fk.kernel_limit("kFmaRingMin"))
        if smem(fk.kernel_limit("kFmaRingMin")) > limit:
            assert fk.train_bwd_route(Hp, size, d_a, 4, fk.MODE_FMA) is None
            with pytest.raises(ValueError):
                fk.fma_train_layout(4096, Hp, size, d_a, 132)
            continue
        rows, blocks, stages, floats, nbytes = fk.fma_train_layout(4096, Hp, size, d_a, 132)
        assert (rows, floats, nbytes) == (R, stage, smem(stages)) and nbytes <= limit
        assert stages == fk.kernel_limit("kFmaRingMax") or smem(stages + 1) > limit
        assert blocks == min(-(-4096 // (4 * R)), 132)
    # the weight-grad pass: kFtRing stages of kFtK rows of A's and B's tile columns
    atb = 4 * _source_constant("kFtRing") * 2 * fk.kernel_limit("kFtK") * fk.kernel_limit("kFtTile")
    assert atb <= limit and "kFtRing * 2 * kFtK * kFtTile" in (CSRC / "flow_train_fma.cu").read_text()


def test_strict_training_layout_at_the_flagship_shape():
    """At the flagship's shape (Hp 544, size 19, d_a 10, 4 hidden layers, 26
    steps) the rows kernel takes 4 rows a lane, a 4-stage ring of 16-row
    stages (232,256 of the 232,448 bytes a block may use) and one block an
    SM at 4096 rows (37 blocks at 37 groups), for all 26 steps; the
    weight-grad pass 111 tiles a step (5 x 5 for each dWm_l, 5 for dWout, 5
    for dW1y, 1 for the ActNorm sums), 2886 blocks; the strict K2a keeps 2.32
    GB for it and its scratch is 1.08 GB."""
    assert fk.fma_train_layout(4096, 544, 19, 10, 132) == (4, 132, 4, 8704, 232_256)
    assert fk.fma_train_layout(4096 + 3, 544, 19, 10, 132)[1] == 132
    assert fk.fma_train_layout(37 * 16, 544, 19, 10, 132)[1] == 37
    tiles = fk.fma_atb_tiles(19, 10, 4, 544)
    assert len(tiles) == 111 and 26 * len(tiles) == 2886
    assert [sum(t[0] == j for t in tiles) for j in range(7)] == [25, 25, 25, 25, 5, 5, 1]
    # half-tiles run: a dWm_l's 16 inner tiles 4 each, its 8 edge tiles 2, its corner 1; dWout's and dW1y's 9
    assert sum(t[3] * t[4] for t in tiles) == 4 * (16 * 4 + 8 * 2 + 1) + 9 + 9 + 1
    assert 4 * fk.fma_keep_floats(4096, 26, 19, 10, 4, 544) == 2_317_352_960 + 3_833_856
    assert 4 * fk.fma_train_scratch_floats(4096, 26, 19, 10, 4, 544) == 1_084_013_536


@pytest.mark.parametrize("Hp,size,d_a,nh", [(544, 19, 10, 4), (32, 7, 4, 1), (1024, 19, 10, 14), (384, 38, 19, 2),
                                           (128, 200, 100, 3)])
def test_strict_weight_grad_tiles_cover_every_output_once(Hp, size, d_a, nh):
    """The weight-grad pass's blocks of a step (`fma_atb_tiles`, the
    kernel's job list and tiling): every output of every job, its column
    sums' row included, lies in exactly one block's halves, and a half a
    block skips holds none (an index model of the blocks' 8 x 8 outputs a
    thread: rows 4 ty + i and 64 + 4 ty + i, columns likewise); nor does a
    warp (16 rows x 32 columns of each half) whose first row or column lies
    past the job's, which skips its products."""
    tile = fk.kernel_limit("kFtTile")
    jobs = fk.fma_atb_jobs(size, d_a, nh, Hp)
    assert len(jobs) == nh + 3 <= fk.kernel_limit("kFtMaxJobs")
    covered = [np.zeros((m + int(sums), n), dtype=int) for _, m, n, sums in jobs]
    for j, m0, n0, mi, nj in fk.fma_atb_tiles(size, d_a, nh, Hp):
        rows = np.concatenate([m0 + h * tile // 2 + np.arange(tile // 2) for h in range(mi)])
        cols = np.concatenate([n0 + h * tile // 2 + np.arange(tile // 2) for h in range(nj)])
        mt, n = covered[j].shape
        for h in range(mi, 2):  # a skipped half holds no output
            assert m0 + h * tile // 2 >= mt
        for h in range(nj, 2):
            assert n0 + h * tile // 2 >= n
        r, c = rows[rows < mt], cols[cols < n]
        covered[j][np.ix_(r, c)] += 1
        for w in range(8):  # csrc: `busy`
            w_rows = m0 + (w // 2) * 16 + np.concatenate([np.arange(16), 64 + np.arange(16)])
            w_cols = n0 + (w % 2) * 32 + np.concatenate([np.arange(32), 64 + np.arange(32)])
            if m0 + (w // 2) * 16 >= mt or n0 + (w % 2) * 32 >= n:
                assert not ((w_rows < mt).any() and (w_cols < n).any())
    for (name, m, n, _), cov in zip(jobs, covered):
        assert cov.min() == cov.max() == 1, name


def test_strict_keep_and_scratch_are_the_source_layouts():
    """The strict K2a's keep (`fma_keep_floats`, csrc/flow_fma.cu's
    `fma_keep_act`/`fma_keep_s`, as the kernel indexes them: step k's h_l,
    then its gelu'(a_l), l = 0 .. nh, each Bp x Hp, Bp = B rounded up to the
    row group of 16 rows (8 above Hp 544); then every step's s, B x d_b)
    fills its floats exactly once; the K2b scratch
    (`fma_train_scratch_floats`) is the sum of its parts, each rounded up
    to 4 floats, in the source's order."""
    for B, S, size, d_a, nh, Hp in ((5, 3, 7, 4, 1, 32), (37, 2, 19, 10, 4, 544), (33, 4, 8, 3, 2, 64),
                                    (37, 2, 19, 10, 2, 1024)):
        n = fk.fma_keep_floats(B, S, size, d_a, nh, Hp)
        G = 16 if Hp <= 544 else 8
        Bp = fk.fma_keep_rows(B, Hp)
        assert Bp % G == 0 and B <= Bp < B + G
        seen = np.zeros(n, dtype=int)
        for k in range(S):
            for grad in (0, 1):
                for l in range(nh + 1):
                    o = ((k * 2 + grad) * (nh + 1) + l) * Bp * Hp
                    seen[o:o + Bp * Hp] += 1
            o = S * 2 * (nh + 1) * Bp * Hp + k * B * (size - d_a)
            seen[o:o + B * (size - d_a)] += 1
        assert seen.min() == seen.max() == 1
        parts = [S * nh * Hp * Hp, S * 2 * (size - d_a) * Hp, S * Hp * (d_a + d_a % 2), S * B * nh * Hp,
                 S * B * 2 * (size - d_a), S * B * size, S * B * (2 * size + 1), S * (2 * size + 1)]
        assert fk.fma_train_scratch_floats(B, S, size, d_a, nh, Hp) == sum(-(-p // 4) * 4 for p in parts)
    text = (CSRC / "flow_fma.cu").read_text()
    assert "((static_cast<size_t>(k) * 2 + (grad ? 1 : 0)) * (nh + 1) + l) * fma_keep_rows(B, Hp) * Hp" in text
    assert ("static_cast<size_t>(S) * 2 * (nh + 1) * fma_keep_rows(B, Hp) * Hp + static_cast<size_t>(k) * B * d_b"
            in text)
    assert "const int G = 4 * fma_lane_rows(Hp / 32);\n  return (B + G - 1) / G * G;" in text
    assert "  return R * ((4 * col + rb) ^ (((col >> 2) & 7) << (R == 2 ? 1 : 0)));" in text  # fma_keep_grad_at


@pytest.mark.parametrize("tn", fk.KERNEL_TN)
def test_strict_keep_grad_blocks_meet_no_bank_twice(tn):
    """`fma_keep_grad_at` places each of a row group's G x Hp floats of
    gelu' once, a lane's R rows of a column together and aligned; and the
    lanes of each shared-memory phase of K2a's stores and K2b's loads (8
    lanes for 16 bytes, 16 for 8; lane: columns `col(j, cq, lane % 8)`, rows
    from R (lane / 8)) meet distinct bank groups at every accumulator column
    of the lane's 4-column quads, where the unswizzled column-major block
    put them all in one."""
    Hp = 32 * tn
    R = fk.fma_lane_rows(Hp)
    G = 4 * R
    at = fk.fma_keep_grad_at(Hp)
    assert sorted(at.tolist()) == list(range(G * Hp))
    unit = at.view(Hp, 4, R)
    assert torch.equal(unit - unit[:, :, :1], torch.arange(R).expand(Hp, 4, R)) and not (unit[:, :, 0] % R).any()
    qw, q4 = 8 * tn, tn // 4
    phase = 8 if R == 4 else 16
    for cq in range(4):
        for j in range(4 * q4):
            for p0 in range(0, 32, phase):
                lanes = range(p0, p0 + phase)
                cols = [cq * qw + 32 * (j // 4) + 4 * (ln % 8) + j % 4 for ln in lanes]
                slots = {(int(at[c * G + R * (ln // 8)]) // R) % (32 // R) for c, ln in zip(cols, lanes)}
                plain = {((c * G + R * (ln // 8)) // R) % (32 // R) for c, ln in zip(cols, lanes)}
                assert len(slots) == phase and len(plain) < phase, (cq, j, p0)


@pytest.mark.parametrize("B,S,size,d_a,nh,Hp", [(5, 3, 7, 4, 1, 32), (37, 2, 19, 10, 4, 64), (33, 4, 8, 3, 2, 32)])
def test_strict_backward_from_the_plain_keep_is_the_plain_backward(B, S, size, d_a, nh, Hp):
    """What the strict K2b reads, `train_keep_reference` (indexed as the
    kernels index it: csrc/flow_fma.cu's `fma_keep_act`, `fma_keep_s`; h_l
    row-major, gelu'(a_l) a row group of G rows at a time as
    `fma_keep_grad_at` places it and csrc/flow_train_fma.cu's `grad_act`
    reads it), is all
    the backward needs of the MLP: the backward taken from the step inputs
    and that keep, recomputing nothing (the strict K2b's arithmetic), gives
    `fused_flow_train_backward_reference`'s ten grads, in float64."""
    gen = torch.Generator().manual_seed(B + nh)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, dtype=torch.float64)

    an_scale, an_bias = 1 + 0.1 * randn(S, size), 0.1 * randn(S, size)
    ortho = torch.linalg.qr(randn(S, size, size))[0]
    w1y, b1, wm, bm = randn(S, d_a, Hp, scale=0.5), randn(S, Hp, scale=0.1), randn(S, nh, Hp, Hp, scale=Hp ** -0.5), \
        randn(S, nh, Hp, scale=0.1)
    wout, bout = randn(S, Hp, 2 * (size - d_a), scale=0.1), randn(S, 2 * (size - d_a), scale=0.1)
    args = (an_scale, an_bias, ortho, w1y, b1, wm, bm, wout, bout)
    x, h_proj, dz, dld = randn(B, size), randn(S, B, Hp, scale=0.5), randn(B, size), randn(B)
    _, _, bound = fk.fused_flow_train_reference(x, h_proj, *args)
    keep = fk.train_keep_reference(bound, h_proj, *args)
    assert keep.numel() == fk.fma_keep_floats(B, S, size, d_a, nh, Hp)
    d_b, Bp, G = size - d_a, fk.fma_keep_rows(B, Hp), 4 * fk.fma_lane_rows(Hp)
    at = fk.fma_keep_grad_at(Hp)

    def kept(k, l, grad):
        o = ((k * 2 + grad) * (nh + 1) + l) * Bp * Hp
        block = keep[o:o + Bp * Hp]
        if grad:  # each row group's block, column-major
            block = block.view(Bp // G, G * Hp)[:, at].view(Bp // G, Hp, G).transpose(1, 2)
        return block.reshape(Bp, Hp)[:B]

    grads = [torch.zeros_like(t) for t in (dz, h_proj, an_scale, an_bias, w1y, b1, wm, bm, wout, bout)]
    dx, dhp, dan_s, dan_b, dw1y, db1, dwm, dbm, dwout, dbout = grads
    dx = dz
    for k in range(S - 1, -1, -1):
        inner = k < S - 1
        x1 = bound[k] * an_scale[k] + an_bias[k] if inner else bound[k]
        o = S * 2 * (nh + 1) * Bp * Hp + k * B * d_b
        s = keep[o:o + B * d_b].view(B, d_b)
        dx2 = dx @ ortho[k].T if inner else dx
        dz_b = dx2[:, d_a:]
        ds = dz_b * torch.exp(s) * x1[:, d_a:] + dld[:, None]
        dout = torch.cat([dz_b, ds * (1 - s * s)], dim=-1)
        dwout[k], dbout[k] = kept(k, nh, 0).T @ dout, dout.sum(0)
        dh = dout @ wout[k].T
        for i in range(nh - 1, -1, -1):
            da = kept(k, i + 1, 1) * dh
            dwm[k, i], dbm[k, i] = kept(k, i, 0).T @ da, da.sum(0)
            dh = da @ wm[k, i].T
        da0 = kept(k, 0, 1) * dh
        dw1y[k], db1[k], dhp[k] = x1[:, :d_a].T @ da0, da0.sum(0), da0
        dx1 = torch.cat([dx2[:, :d_a] + da0 @ w1y[k].T, dz_b * torch.exp(s)], dim=-1)
        if inner:
            dan_s[k] = (dx1 * bound[k]).sum(0) + dld.sum() / an_scale[k]
            dan_b[k] = dx1.sum(0)
            dx = dx1 * an_scale[k]
        else:
            dx = dx1
    refs = fk.fused_flow_train_backward_reference(bound, h_proj, dz, dld, *args)
    for name, a, b in zip(GRAD_NAMES, (dx, dhp, dan_s, dan_b, dw1y, db1, dwm, dbm, dwout, dbout), refs):
        torch.testing.assert_close(a, b, atol=1e-12, rtol=1e-10, msg=name)


def _plain_case(B: int, S: int, size: int, d_a: int, nh: int, Hp: int, seed: int):
    """Random float32 step inputs, conditions, cotangents and the nine kernel
    arguments (ActNorm off identity, orthonormal mixes), from a seed."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32))

    ortho = torch.from_numpy(np.stack([np.linalg.qr(rng.normal(size=(size, size)))[0] for _ in range(S)])
                             .astype(np.float32))
    args = [1 + t(S, size, scale=0.1), t(S, size, scale=0.2), ortho, t(S, d_a, Hp, scale=0.5), t(S, Hp, scale=0.1),
            t(S, nh, Hp, Hp, scale=Hp ** -0.5), t(S, nh, Hp, scale=0.1), t(S, Hp, 2 * (size - d_a), scale=0.1),
            t(S, 2 * (size - d_a), scale=0.1)]
    return t(B, size), t(S, B, Hp, scale=0.5), args, t(B, size), t(B)


@pytest.mark.parametrize("B,chunk_rows,ends", [(100, 32, [32, 64, 100]), (96, 32, [32, 64, 96]),
                                               (131, 64, [64, 131]), (70, 32, [32, 70])])
def test_strict_chunked_backward_matches_the_whole_one(B, chunk_rows, ends):
    """The strict backward in row chunks on the plain versions (a chunk's
    plain backward, the weight and ActNorm grads summed over the chunks; a
    tail of fewer than 32 rows joins the last chunk) against the whole
    batch's: dx and dh_proj equal to the bit (each row's own), the rest
    within float32's sum order, atol 1e-6 x the grad's largest |value|."""
    S, size, d_a, nh, Hp = 3, 7, 4, 2, 32
    x, h_proj, args, dz, dld = _plain_case(B, S, size, d_a, nh, Hp, seed=B)
    assert [e for _, e in fk.strict_chunks(dz, h_proj, args[5], d_a, fk.MODE_FMA, chunk_rows)] == ends
    _, _, bound = fk.fused_flow_train_reference(x, h_proj, *args)
    whole = fk.fused_flow_train_bwd(bound, h_proj, dz, dld, *args, mode=fk.MODE_FMA)
    chunked = fk.fused_flow_train_bwd(bound, h_proj, dz, dld, *args, mode=fk.MODE_FMA, chunk_rows=chunk_rows)
    for name, a, b in zip(GRAD_NAMES, chunked, whole):
        if name in ("x", "h_proj"):
            assert torch.equal(a, b), name
        else:
            torch.testing.assert_close(a, b, atol=1e-6 * b.abs().max().item(), rtol=0, msg=name)
    with pytest.raises(ValueError, match="keep"):  # in chunks the backward makes its own keeps
        fk.fused_flow_train_bwd(bound, h_proj, dz, dld, *args, mode=fk.MODE_FMA, chunk_rows=chunk_rows,
                                keep=torch.zeros(1))


def test_strict_chunked_training_step_through_autograd_on_the_cpu():
    """`fused_flow_train(chunk_rows=...)` in autograd: z and logdet are the
    whole batch's, the input and condition grads equal to the bit, the
    weight grads within float32's sum order; outside the strict mode, or
    with no `chunk_rows` on the CPU, nothing chunks; `chunk_rows` that is
    not a positive multiple of 32 raises."""
    x, h_proj, args, dz, dld = _plain_case(100, 3, 7, 4, 2, 32, seed=5)
    outs = []
    for chunk_rows in (None, 32):
        leaves = [t.clone().requires_grad_(True) for t in (x, h_proj, *args)]
        z, ld = fk.fused_flow_train(*leaves, mode=fk.MODE_FMA, chunk_rows=chunk_rows)
        ((z * dz).sum() + (ld * dld).sum()).backward()
        outs.append((z.detach(), ld.detach(), [t.grad for t in leaves]))
    (z0, ld0, g0), (z1, ld1, g1) = outs
    assert torch.equal(z0, z1) and torch.equal(ld0, ld1)
    assert torch.equal(g0[0], g1[0]) and torch.equal(g0[1], g1[1])
    for a, b in zip(g1[2:], g0[2:]):
        torch.testing.assert_close(a, b, atol=1e-6 * max(b.abs().max().item(), 1e-30), rtol=0)
    assert fk.strict_chunks(dz, h_proj, args[5], 4, fk.MODE_3XTF32, 32) is None
    assert fk.strict_chunks(dz, h_proj, args[5], 4, fk.MODE_FMA) is None
    for bad in (0, 48, -32):
        with pytest.raises(ValueError, match="multiple of 32"):
            fk.strict_chunks(dz, h_proj, args[5], 4, fk.MODE_FMA, bad)


@pytest.mark.parametrize("card_bytes", [85_017_853_952, 80 * 10**9])
def test_strict_chunk_rule_at_the_flagship_shape(card_bytes):
    """The chunk rule at the flagship's shape (26 steps, 4 hidden layers at
    Hp 544, size 19, d_a 10) on an 80 GB card (an H100 80GB's total memory,
    and 80e9 bytes): a multiple of 32 rows whose keep and K2b scratch take
    at most an eighth of the card's memory, and 32 rows more would not; so
    4096 rows (the main path's batch) and 12,288 take one chunk, 65,536
    rows several, each within the share but a tail of fewer than 32 rows."""
    shape = (26, 19, 10, 4, 544)
    rows = fk.strict_chunk_rows(*shape, card_bytes)

    def chunk_bytes(n: int) -> int:
        S, size, d_a, nh, Hp = shape
        return 4 * (fk.fma_keep_floats(n, S, size, d_a, nh, Hp) + fk.fma_train_scratch_floats(n, S, size, d_a, nh, Hp))

    assert rows % fk.STRICT_CHUNK_ROWS == 0
    assert chunk_bytes(rows) <= fk.STRICT_CHUNK_SHARE * card_bytes < chunk_bytes(rows + fk.STRICT_CHUNK_ROWS)
    assert 12_288 < rows < 16_384
    assert fk.row_chunks(4096, rows) == [(0, 4096)] and fk.row_chunks(12_288, rows) == [(0, 12_288)]
    chunks = fk.row_chunks(65_536, rows)
    assert len(chunks) == 6 and chunks[0] == (0, rows) and chunks[-1][1] == 65_536
    assert all(e - f <= rows for f, e in chunks)
    if card_bytes == 85_017_853_952:
        assert rows == 13_088  # the value the docstrings and PERF.md give


@pytest.mark.parametrize("B,chunk_rows,largest", [(4099, 1024, 1027), (4096, 1024, 1024), (65_536, 13_088, 13_088),
                                                  (100, 32, 36), (131, 64, 67)])
def test_strict_chunk_buffers_are_sized_for_the_largest_chunk(B, chunk_rows, largest):
    """The one keep and the one K2b scratch that serve every row chunk hold
    what the largest chunk needs (`fma_keep_floats`,
    `fma_train_scratch_floats` of its rows), and the largest chunk can be the
    last, where `row_chunks` joins a tail of fewer than 32 rows to it; every
    chunk's keep and scratch fit in their first floats."""
    shape = (26, 19, 10, 4, 544)
    chunks = fk.row_chunks(B, chunk_rows)
    assert max(e - f for f, e in chunks) == largest
    keep, scratch = fk.strict_chunk_buffers(chunks, *shape)
    assert (keep, scratch) == (fk.fma_keep_floats(largest, *shape), fk.fma_train_scratch_floats(largest, *shape))
    for f, e in chunks:
        assert fk.fma_keep_floats(e - f, *shape) <= keep and fk.fma_train_scratch_floats(e - f, *shape) <= scratch


def test_strict_weight_grad_sum_order_emulated_in_float32():
    """The weight-grad pass's fixed order, emulated in float32: each
    output's sum over 4096 rows taken kFtK rows at a time into a fresh sum,
    each stage's sum added to the running one, is nearer the float64 sum
    than one running float32 sum over all rows (RMS over 544 columns of
    column sums, the bias grads, and of A^T B outputs), and independent of
    the tile an output falls in."""
    rng = np.random.default_rng(0)
    K, stage = 4096, fk.kernel_limit("kFtK")
    da = rng.normal(size=(K, 544)).astype(np.float32)
    h = (0.5 + rng.random(size=(K, 3))).astype(np.float32)

    def two_level(prod):
        total = np.zeros(prod.shape[1], dtype=np.float32)
        for s0 in range(0, K, stage):
            fresh = np.zeros(prod.shape[1], dtype=np.float32)
            for r in range(s0, min(K, s0 + stage)):
                fresh = fresh + prod[r]
            total = total + fresh
        return total

    def one_level(prod):
        total = np.zeros(prod.shape[1], dtype=np.float32)
        for r in range(K):
            total = total + prod[r]
        return total

    for prod in (da, (h[:, :1] * da).astype(np.float32)):
        exact = prod.astype(np.float64).sum(0)
        err2 = np.sqrt(np.mean((two_level(prod) - exact) ** 2))
        err1 = np.sqrt(np.mean((one_level(prod) - exact) ** 2))
        assert err2 < 0.5 * err1, (err2, err1)


# ---------------------------------------------------------------------------
# (d) on a card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_case(cuda, hidden: int, nh: int, rows: int, seed: int, size: int = 19):
    """A flow of 3 steps with `nh` hidden layers of width `hidden` on the card
    (ActNorm off identity): x, h_proj (one condition row a row), the nine
    kernel arguments."""
    stack = FeatureNetworkStack([ConcatenateCondition(None, 3), LSTMFeatureNetwork(3, 4, 8, 1)])
    model = CondRealNVP(size=size, nested_sizes=[hidden] * (nh + 1), n_blocks=3, n_conditions=8,
                        feature_network_stack=stack, act_norm=True, random_state=0, pallas_strict=True)
    params = model.init(device=cuda)
    rng = np.random.default_rng(seed)
    an = params["blocks"]["actnorm"]
    params = dict(params, blocks=dict(params["blocks"], actnorm={
        "scale": an["scale"] + torch.from_numpy(0.2 * rng.normal(size=an["scale"].shape).astype(np.float32)).to(cuda),
        "bias": torch.from_numpy(0.2 * rng.normal(size=an["bias"].shape).astype(np.float32)).to(cuda),
    }))
    with torch.no_grad():
        traj = torch.from_numpy(rng.normal(size=(rows, 9, 3)).astype(np.float32)).to(cuda)
        kargs, h_proj = model._fused_flow_args(params, model.encode(params, (traj,)))
        x = torch.from_numpy(rng.normal(size=(rows, size)).astype(np.float32)).to(cuda)
    return x, h_proj, [kargs[n] for n in ARG_NAMES]


@pytest.mark.gpu
@pytest.mark.parametrize("hidden,nh,rows", [(16, 2, 37), (16, 1, 32), (100, 4, 6 * 37 + 5), (526, 4, 203),
                                            (526, 14, 33), (1000, 2, 101), (1000, 4, 4099), (526, 1, 4099),
                                            (526, 4, 4099)])
def test_strict_training_kernels_match_plain_versions_on_card(cuda, hidden, nh, rows):
    """On the plain version's inputs: the strict K2a's z, logdet, step inputs
    and what it keeps for K2b within 1e-4 of their plain versions
    (`fused_flow_train_reference`, `train_keep_reference`); the strict K2b,
    on the plain step inputs and the plain keep, at the JAX grad bar; each
    equal to the bit between two calls; the chain, K2b on K2a's step inputs
    and keep, at the grad bar too; counted on their route and mode."""
    x, h_proj, args = _card_case(cuda, hidden, nh, rows, seed=hidden + rows)
    before = (fk.fused_flow_train_fwd.route_launches[fk.ROUTE_FMA], fk.fused_flow_train_bwd.route_launches[fk.ROUTE_FMA],
              fk.fused_flow_train_fwd.mode_launches[fk.MODE_FMA], fk.fused_flow_train_bwd.mode_launches[fk.MODE_FMA])
    with torch.no_grad():
        keep, again = (fk.train_keep(x, h_proj, args[5], args[3].shape[1], fk.MODE_FMA) for _ in range(2))
        one = fk.fused_flow_train_fwd(x, h_proj, *args, mode=fk.MODE_FMA, keep=keep)
        two = fk.fused_flow_train_fwd(x, h_proj, *args, mode=fk.MODE_FMA, keep=again)
        ref = fk.fused_flow_train_reference(x, h_proj, *args)
        plain_keep = fk.train_keep_reference(ref[2], h_proj, *args)
        gen = torch.Generator(device=cuda).manual_seed(rows)
        dz = torch.randn(x.shape, generator=gen, device=cuda)
        dld = torch.randn((rows,), generator=gen, device=cuda)
        g1 = fk.fused_flow_train_bwd(ref[2], h_proj, dz, dld, *args, mode=fk.MODE_FMA, keep=plain_keep)
        g2 = fk.fused_flow_train_bwd(ref[2], h_proj, dz, dld, *args, mode=fk.MODE_FMA, keep=plain_keep)
        chain = fk.fused_flow_train_bwd(one[2], h_proj, dz, dld, *args, mode=fk.MODE_FMA, keep=keep)
        grefs = fk.fused_flow_train_backward_reference(ref[2], h_proj, dz, dld, *args)
        torch.cuda.synchronize()
    for name, a, b, c in zip(("z", "logdet", "bound", "keep"), (*one, keep), (*two, again), (*ref, plain_keep)):
        torch.testing.assert_close(a, c, atol=1e-4, rtol=0, msg=name)
        assert torch.equal(a, b), name
    for name, a, b, c, d in zip(GRAD_NAMES, g1, g2, grefs, chain):
        torch.testing.assert_close(a, c, atol=5e-4, rtol=1e-3, msg=name)
        assert torch.equal(a, b), name
        torch.testing.assert_close(d, c, atol=5e-4, rtol=1e-3, msg=f"{name} (chain)")
    after = (fk.fused_flow_train_fwd.route_launches[fk.ROUTE_FMA], fk.fused_flow_train_bwd.route_launches[fk.ROUTE_FMA],
             fk.fused_flow_train_fwd.mode_launches[fk.MODE_FMA], fk.fused_flow_train_bwd.mode_launches[fk.MODE_FMA])
    assert [a - b for a, b in zip(after, before)] == [2, 3, 2, 3]


@pytest.mark.gpu
def test_strict_training_refuses_a_missing_keep_on_card(cuda):
    """The strict K2a and K2b have one way to run: each raises without the
    keep, before any launch, and counts nothing."""
    x, h_proj, args = _card_case(cuda, 16, 2, 37, seed=1)
    counts = (fk.fused_flow_train_fwd.launches, fk.fused_flow_train_bwd.launches)
    with torch.no_grad():
        keep = fk.train_keep(x, h_proj, args[5], args[3].shape[1], fk.MODE_FMA)
        with pytest.raises(ValueError, match="keep"):
            fk.fused_flow_train_fwd(x, h_proj, *args, mode=fk.MODE_FMA)
        bound = fk.fused_flow_train_reference(x, h_proj, *args)[2]
        with pytest.raises(ValueError, match="keep"):
            fk.fused_flow_train_bwd(bound, h_proj, x, x[:, 0].contiguous(), *args, mode=fk.MODE_FMA)
        with pytest.raises(ValueError, match="keep"):  # a keep of another shape
            fk.fused_flow_train_bwd(bound, h_proj, x, x[:, 0].contiguous(), *args, mode=fk.MODE_FMA, keep=keep[1:])
    assert (fk.fused_flow_train_fwd.launches, fk.fused_flow_train_bwd.launches) == counts


@pytest.mark.gpu
@pytest.mark.parametrize("Hp,size,d_a,rows,nh", [(544, 19, 10, 4096, 4), (1024, 19, 10, 101, 14), (32, 7, 4, 37, 1)])
def test_strict_training_layout_on_card_is_the_host_copy(cuda, Hp, size, d_a, rows, nh):
    """The rows kernel's layout and the weight-grad pass's blocks, the keep's
    and the scratch's floats, as the libraries compute them, are the host's
    copies."""
    from bcnf_tpu_torch.ops._build import load_library

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    S = 26
    assert fk.fma_train_card_layout(rows, S, Hp, size, d_a, nh) == (
        *fk.fma_train_layout(rows, Hp, size, d_a, sms), S * len(fk.fma_atb_tiles(size, d_a, nh, Hp)))
    assert load_library("flow_fma").bcnf_flow_fma_keep(rows, S, size, d_a, nh, Hp) == fk.fma_keep_floats(
        rows, S, size, d_a, nh, Hp)
    assert load_library("flow_train_fma").bcnf_flow_train_fma_scratch(rows, S, size, d_a, nh, Hp) == (
        fk.fma_train_scratch_floats(rows, S, size, d_a, nh, Hp))


@pytest.mark.gpu
def test_strict_training_step_launches_only_the_strict_kernels_on_card(cuda):
    """A strict model's training forward and backward (dropout 0, a batch
    past the floor) launch K2a and K2b once each, both in float32 FMA on
    their FMA routes, and nothing of the 3xTF32 or one-pass routes; the loss
    and grads match the plain autograd step in float32 (TF32 off)."""
    from bcnf_tpu_torch.bridge import map_tree, tree_leaves
    from bcnf_tpu_torch.utils.misc import inn_nll_loss

    stack = FeatureNetworkStack([ConcatenateCondition(None, 3), LSTMFeatureNetwork(3, 4, 8, 1)])
    model = CondRealNVP(size=19, nested_sizes=[100] * 3, n_blocks=4, n_conditions=8, feature_network_stack=stack,
                        act_norm=True, random_state=0, pallas_strict=True)
    params = model.init(torch.Generator().manual_seed(0), device=cuda)
    rng = np.random.default_rng(7)
    y = torch.from_numpy(rng.normal(size=(256, 19)).astype(np.float32)).to(cuda)
    traj = torch.from_numpy(rng.normal(size=(256, 9, 3)).astype(np.float32)).to(cuda)
    counters = (fk.fused_flow_train_fwd, fk.fused_flow_train_bwd)
    for c in counters:
        c.launches = 0
        c.mode_launches.clear()
        c.route_launches.clear()
    losses, grads = [], []
    for kernels in (True, False):
        model.use_pallas = kernels
        p = map_tree(lambda t: t.detach().clone().requires_grad_(True), params)
        z, ld = model.forward(p, y, traj, train=True)
        loss = inn_nll_loss(z, ld)
        loss.backward()
        torch.cuda.synchronize()
        losses.append(loss.item())
        grads.append([t.grad for t in tree_leaves(p)])
    for c in counters:
        assert c.launches == 1 and dict(c.mode_launches) == {fk.MODE_FMA: 1}
        assert dict(c.route_launches) == {fk.ROUTE_FMA: 1}
    assert abs(losses[0] - losses[1]) <= 1e-4 * max(1.0, abs(losses[1]))
    for a, b in zip(*grads):
        if b is None:  # the fixed mixes: detached on the plain path, zero grads through the kernels
            assert a is None or not a.any()
        else:
            torch.testing.assert_close(a, b, atol=5e-4, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("hidden,nh,rows,chunk_rows", [(526, 4, 1000, 256), (100, 2, 101, 32), (1000, 2, 300, 128)])
def test_strict_chunked_step_matches_the_whole_step_on_card(cuda, hidden, nh, rows, chunk_rows):
    """The strict training step with its backward forced into row chunks
    (`fused_flow_train(chunk_rows=...)`: K2a again on each chunk's step
    inputs into a chunk's keep, then K2b on the chunk): z, logdet, dx and
    dh_proj equal to the bit to the whole batch's; every grad no further
    from the float64 plain version (relative to its largest value) than
    twice the larger of the float32 plain version's and the whole batch's
    kernel's distance; and the launches counted: K2a once for the forward
    (keeping nothing) and once a chunk, K2b once a chunk."""
    x, h_proj, args = _card_case(cuda, hidden, nh, rows, seed=hidden + rows)
    gen = torch.Generator(device=cuda).manual_seed(rows)
    dz = torch.randn(x.shape, generator=gen, device=cuda)
    dld = torch.randn((rows,), generator=gen, device=cuda)
    n_chunks = len(fk.row_chunks(rows, chunk_rows))
    outs = []
    for cr in (None, chunk_rows):
        counts = (fk.fused_flow_train_fwd.route_launches[fk.ROUTE_FMA], fk.fused_flow_train_bwd.route_launches[fk.ROUTE_FMA],
                  fk.fused_flow_train_fwd.mode_launches[fk.MODE_FMA], fk.fused_flow_train_bwd.mode_launches[fk.MODE_FMA])
        leaves = [t.detach().clone().requires_grad_(True) for t in (x, h_proj, *args)]
        z, ld = fk.fused_flow_train(*leaves, mode=fk.MODE_FMA, chunk_rows=cr)
        ((z * dz).sum() + (ld * dld).sum()).backward()
        torch.cuda.synchronize()
        after = (fk.fused_flow_train_fwd.route_launches[fk.ROUTE_FMA], fk.fused_flow_train_bwd.route_launches[fk.ROUTE_FMA],
                 fk.fused_flow_train_fwd.mode_launches[fk.MODE_FMA], fk.fused_flow_train_bwd.mode_launches[fk.MODE_FMA])
        k = 1 if cr is None else n_chunks
        assert [a - b for a, b in zip(after, counts)] == [1 + (k if cr else 0), k, 1 + (k if cr else 0), k]
        outs.append((z.detach(), ld.detach(), [t.grad for i, t in enumerate(leaves) if i != 4]))
    (z0, ld0, g0), (z1, ld1, g1) = outs
    assert torch.equal(z0, z1) and torch.equal(ld0, ld1)
    assert torch.equal(g0[0], g1[0]) and torch.equal(g0[1], g1[1])
    with torch.no_grad():
        bound = fk.fused_flow_train_reference(x, h_proj, *args)[2]
        g32 = fk.fused_flow_train_backward_reference(bound, h_proj, dz, dld, *args)
        a64 = [t.double() for t in args]
        bound64 = fk.fused_flow_train_reference(x.double(), h_proj.double(), *a64)[2]
        g64 = fk.fused_flow_train_backward_reference(bound64, h_proj.double(), dz.double(), dld.double(), *a64)
    for name, c, w, p, r in zip(GRAD_NAMES, g1, g0, g32, g64):
        d_c, d_w, d_p = ((t.double() - r).abs().max().item() / r.abs().max().item() for t in (c, w, p))
        assert d_c <= 2 * max(d_p, d_w), (name, d_c, d_w, d_p)


@pytest.mark.gpu
def test_strict_chunks_share_one_keep_and_scratch_on_card(cuda):
    """The strict backward forced into chunks of 1024 rows at 4099 rows
    (1024, 1024, 1024 and 1027): one keep and one K2b scratch, allocated
    once (`fused_flow_train_bwd.allocations`), serve all four chunks; K2a
    runs once a chunk and K2b once a chunk. Its dx and dh_proj equal the
    whole batch's to the bit, and every grad equals, to the bit, the same
    chunks run with a keep, a scratch and a set of grads of their own each,
    summed in the chunks' order (the backward before its buffers were
    shared)."""
    x, h_proj, args = _card_case(cuda, 526, 4, 4099, seed=11)
    gen = torch.Generator(device=cuda).manual_seed(4099)
    dz, dld = torch.randn(x.shape, generator=gen, device=cuda), torch.randn((4099,), generator=gen, device=cuda)
    named, parts = dict(zip(ARG_NAMES, args)), fk.BWD_ROWS | fk.BWD_WEIGHT_GRADS | fk.BWD_ACTNORM
    chunks = fk.row_chunks(4099, 1024)
    assert [e - f for f, e in chunks] == [1024, 1024, 1024, 1027]
    with torch.no_grad():
        keep = fk.train_keep(x, h_proj, args[5], args[3].shape[1], fk.MODE_FMA)
        bound = fk.fused_flow_train_fwd(x, h_proj, *args, mode=fk.MODE_FMA, keep=keep)[2]
        whole = fk.fused_flow_train_bwd(bound, h_proj, dz, dld, *args, mode=fk.MODE_FMA, keep=keep)
        del keep
        allocs = dict(fk.fused_flow_train_bwd.allocations)
        counts = (fk.fused_flow_train_fwd.launches, fk.fused_flow_train_bwd.launches)
        got = fk.fused_flow_train_bwd(bound, h_proj, dz, dld, *args, mode=fk.MODE_FMA, chunk_rows=1024)
        torch.cuda.synchronize()
        assert {k: v - allocs.get(k, 0) for k, v in fk.fused_flow_train_bwd.allocations.items()} == {
            "keep": 1, "scratch": 1}
        assert (fk.fused_flow_train_fwd.launches - counts[0], fk.fused_flow_train_bwd.launches - counts[1]) == (4, 4)
        dx, dhp, sums = torch.empty_like(dz), torch.empty_like(h_proj), []
        for first, end in chunks:  # a keep, a scratch and grads of the chunk's own
            mine = fk.train_keep(bound[0, first:end], h_proj, args[5], args[3].shape[1], fk.MODE_FMA)
            fk._train_fwd(bound[0, first:end], h_proj, named, fk.MODE_FMA, None, mine, first)
            g = (dx, dhp, *(torch.empty_like(t) for n, t in named.items() if n != "ortho"))
            fk._train_bwd_parts(bound, h_proj, dz, dld, named, g, parts, fk.MODE_FMA, None, mine, (first, end))
            sums = list(g[2:]) if not sums else [t.add_(c) for t, c in zip(sums, g[2:])]
        torch.cuda.synchronize()
    assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])
    for name, a, b in zip(GRAD_NAMES, got, (dx, dhp, *sums)):
        assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("hidden,nh,rows,first,count", [(526, 4, 1000, 768, 232), (526, 4, 1000, 0, 232),
                                                        (100, 2, 101, 64, 37), (1000, 2, 300, 256, 44)])
def test_strict_k2a_reads_only_its_row_range_on_card(cuda, hidden, nh, rows, first, count):
    """The strict K2a on rows first .. first + count - 1 of a batch's h_proj
    (as the chunked backward runs it), where count is not a whole number of
    row groups and h_proj is followed by NaN: z, logdet, step inputs and the
    whole keep, its rows past count included, within 1e-4 of the plain
    versions on those rows alone. A read past the range (the last step's
    rows past the batch, or the next chunk's rows) shows as NaN or as
    another row's values in the keep's last row group."""
    x, h_proj, args = _card_case(cuda, hidden, nh, rows, seed=hidden + first)
    S, _, Hp = h_proj.shape
    flat = torch.full((h_proj.numel() + 16 * Hp,), float("nan"), device=cuda)
    hp = flat[:h_proj.numel()].view(h_proj.shape)
    hp.copy_(h_proj)
    xc, hc = x[first:first + count].contiguous(), h_proj[:, first:first + count].contiguous()
    with torch.no_grad():
        keep = fk.train_keep(xc, hc, args[5], args[3].shape[1], fk.MODE_FMA)
        out = fk._train_fwd(xc, hp, dict(zip(ARG_NAMES, args)), fk.MODE_FMA, None, keep, first)
        ref = fk.fused_flow_train_reference(xc, hc, *args)
        plain_keep = fk.train_keep_reference(ref[2], hc, *args)
        torch.cuda.synchronize()
    for name, a, c in zip(("z", "logdet", "bound", "keep"), (*out, keep), (*ref, plain_keep)):
        torch.testing.assert_close(a, c, atol=1e-4, rtol=0, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("size,stages", [(60, 3), (160, 2)])
def test_strict_k2a_keeps_through_a_short_ring_on_card(cuda, size, stages):
    """The strict K2a where its ring holds few stages (3 and 2 at Hp 544 with
    these sizes, `fma_layout`), so that the next layer's weights wait on the
    gelu' slots' bulk stores: the keep within 1e-4 of `train_keep_reference`,
    equal to the bit between calls."""
    x, h_proj, args = _card_case(cuda, 526, 2, 203, seed=size, size=size)
    d_a = args[3].shape[1]
    assert fk.fma_layout(203, 544, size, d_a, torch.cuda.get_device_properties(cuda).multi_processor_count)[2] == stages
    with torch.no_grad():
        keeps = [fk.train_keep(x, h_proj, args[5], d_a, fk.MODE_FMA) for _ in range(2)]
        outs = [fk.fused_flow_train_fwd(x, h_proj, *args, mode=fk.MODE_FMA, keep=k) for k in keeps]
        ref = fk.fused_flow_train_reference(x, h_proj, *args)
        plain_keep = fk.train_keep_reference(ref[2], h_proj, *args)
        torch.cuda.synchronize()
    for name, a, b, c in zip(("z", "logdet", "bound", "keep"), (*outs[0], keeps[0]), (*outs[1], keeps[1]),
                             (*ref, plain_keep)):
        torch.testing.assert_close(a, c, atol=1e-4, rtol=0, msg=name)
        assert torch.equal(a, b), name


def test_strict_train_parts_patches_apply_to_the_kernel_sources():
    """Each variant of tools/strict_train_parts.py patches this checkout's
    csrc/flow_train_fma.cu (or the flow_fma.cu it includes) at exactly one
    place, and so does each of its strict K2a variants csrc/flow_fma.cu, so
    that the tool times the parts of the kernels as they are."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("strict_train_parts", Path(__file__).resolve().parent.parent
                                                  / "tools" / "strict_train_parts.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    sources = {f: (CSRC / f).read_text() for f in ("flow_train_fma.cu", "flow_fma.cu")}
    assert tool.PATCHES["as built"] == [] and len(tool.PATCHES) >= 8
    assert tool.K2A_PATCHES["as built"] == [] and len(tool.K2A_PATCHES) >= 4
    for name, patches in (*tool.PATCHES.items(), *tool.K2A_PATCHES.items()):
        for f, old, new in patches:
            assert sources[f].count(old) == 1 and old != new, (name, old)


# ---------------------------------------------------------------------------
# K1's 3xTF32 inverse: the variants of tools/k1_3xtf32_fold.py
# ---------------------------------------------------------------------------


def test_fold_tool_patches_apply_to_the_kernel_source():
    """Each variant of tools/k1_3xtf32_fold.py patches csrc/flow_wgmma.cu at
    exactly one place: ring stages of one k-step (`stage1`, with its weight
    layout), the warpgroups issuing in turn (`pingpong`), and with stages of
    one k-step another product of a layer (two fresh half
    accumulators taking turns, with the `wgmma` widths they need, written as
    csrc/wgmma_tf32.cuh writes the ones it has; no fresh accumulator)
    inserted before the kernel's own and called in its place (the tool
    imports neither JAX nor the JAX package: tests/test_torch_port_imports.py)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("k1_fold", Path(__file__).resolve().parent.parent / "tools"
                                                  / "k1_3xtf32_fold.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    source = (CSRC / "flow_wgmma.cu").read_text()
    assert set(tool.PATCHES) == {"as built", "stage1", "pingpong", "halves", "unfolded"}
    assert tool.PATCHES["as built"] == []
    assert tool.STAGE_KS == {"stage1": 1, "halves": 1, "unfolded": 1}
    for name, patches in tool.PATCHES.items():
        for old, new in patches:
            assert source.count(old) == 1 and old != new, name
    assert source.count("fold_product<TN>(") == 1  # its one call
    assert tool.PARTS == {"products": 1, "stream": 2, "no exchange": 3, "neither": 0}
    header = (CSRC / "wgmma_tf32.cuh").read_text()

    def norm(text: str) -> str:  # whitespace and string-literal splits aside
        return re.sub(r"\s+", " ", text).strip().replace('" "', "")

    for n in (64, 96, 136):  # the widths the halves variant adds are written as the header writes its own
        written = re.search(rf"template <>\nstruct WgmmaTf32<{n}> \{{.*?\n\}};\n", header, re.S).group(0)
        assert norm(written) == norm(tool.wgmma_spec(n))
    assert all(f"kWg{n} = {v}" in source for n, v in (("Products", 1), ("Copies", 2), ("Exchange", 4)))
