"""The one-pass whole-flow forward's route (bcnf_tpu_torch/ops/flow_kernel.py:
`flow_route` with inverse=False) and its `wgmma` kernel
(csrc/flow_fwd_wgmma.cu), which K1's forward, K2a and K4's forward take in
the reduced mode at padded widths up to 544. On the CPU: which kernel each
mode and width takes, the limits the route reads from the kernel's source,
the training gate open wherever it was, the plain one-pass forward against
JAX's Pallas kernels in interpret mode at JAX's reduced-mode bar, and the
parts tool's patches. The `gpu` tests hold the kernel against its plain
one-pass version on a card: `python -m pytest
tests/test_torch_port_fwd_route.py -m gpu --noconftest` (JAX is imported
only inside the tests that compare with it, so the file also runs where JAX
is not installed)."""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from bcnf_tpu_torch.models import CondRealNVP, ConcatenateCondition, FeatureNetworkStack, LSTMFeatureNetwork
from bcnf_tpu_torch.ops import flow_kernel as fk
from bcnf_tpu_torch.ops.tf32 import matmul_tf32

CSRC = Path(fk.__file__).resolve().parent / "csrc"
ROOT = Path(__file__).resolve().parent.parent
REDUCED_BAR = 5e-3  # JAX's bar for its reduced kernel mode (tests/test_flow_kernel.py:130-141)
ARG_NAMES = ("an_scale", "an_bias", "ortho", "w1y", "b1", "wm", "bm", "wout", "bout")


def _constant(name: str) -> int:
    text = (CSRC / "flow_fwd_wgmma.cu").read_text()
    return int(re.search(rf"constexpr\s+int\s+{name}\s*=\s*(\d+)\s*;", text).group(1))


@pytest.mark.parametrize("H,wgmma", [(16, True), (100, True), (256, True), (526, True), (700, False), (1000, False)])
def test_one_pass_forward_takes_wgmma_up_to_hp_544(H, wgmma):
    """The one-pass forward takes the `wgmma` forward at every padded width
    up to 544 (the flagship's) and the one-pass row tiles at 768 and 1024;
    the 3xTF32 forward likewise its own build of the `wgmma` forward, or
    above 544 the wide forward (`csrc/flow_wide_wgmma.cu`), strict the FMA
    kernel; the inverse its `wgmma` route up to 544, and above it the
    one-pass row tiles and, in 3xTF32, the wide inverse (the same source)."""
    Hp = fk.padded_width(H)
    one_pass = fk.ROUTE_FWD_WGMMA_TF32 if wgmma else fk.ROUTE_ROWS_TF32
    assert fk.flow_route(Hp, 19, 10, False, fk.MODE_TF32) == one_pass
    assert fk.flow_route(Hp, 19, 10, False, fk.MODE_3XTF32) == (fk.ROUTE_FWD_WGMMA if wgmma else fk.ROUTE_WIDE_FWD)
    assert fk.flow_route(Hp, 19, 10, False, fk.MODE_FMA) == fk.ROUTE_FMA
    assert fk.flow_route(Hp, 19, 10, True, fk.MODE_TF32) == (fk.ROUTE_WGMMA_TF32 if wgmma else fk.ROUTE_ROWS_TF32)
    assert fk.flow_route(Hp, 19, 10, True, fk.MODE_3XTF32) == (fk.ROUTE_WGMMA if wgmma else fk.ROUTE_WIDE)
    assert fk.ROUTE_LIBRARY[fk.ROUTE_FWD_WGMMA_TF32] == "flow_fwd_wgmma_tf32"
    assert fk.ROUTE_LIBRARY[fk.ROUTE_FWD_WGMMA] == "flow_fwd_wgmma"


def test_forced_row_tiles(monkeypatch):
    """`FWD_WGMMA_MAX_TN = 0` forces the row tiles of either mode at every
    width the `wgmma` forward would take; the inverse and the strict mode do
    not move."""
    monkeypatch.setattr(fk, "FWD_WGMMA_MAX_TN", 0)
    for Hp in (32, 128, 544):
        assert fk.flow_route(Hp, 19, 10, False, fk.MODE_TF32) == fk.ROUTE_ROWS_TF32
        assert fk.flow_route(Hp, 19, 10, True, fk.MODE_TF32) == fk.ROUTE_WGMMA_TF32
        assert fk.flow_route(Hp, 19, 10, False, fk.MODE_3XTF32) == fk.ROUTE_ROWS


@pytest.mark.parametrize("size,d_a,route,ring", [
    (19, 10, "fwd_wgmma_tf32", 4),   # the flagship: 4 stages of 16 weight rows beside the tile
    (20, 16, "fwd_wgmma_tf32", 4),   # d_a 16: W1y fills one stage
    (29, 14, "fwd_wgmma_tf32", 3),   # n_out 30: a larger state leaves room for 3 stages
    (20, 17, "rows_tf32", 0),        # d_a 17: W1y past one stage
    (33, 8, "rows_tf32", 0),         # n_out 50: Wout's 4 stages past the 2 that fit
    (38, 19, "rows_tf32", 0),        # d_a 19
    (90, 45, None, 0),               # past the row tiles' shared memory too
], ids=["flagship", "d_a16", "n_out30", "d_a17", "n_out50", "d_a19", "size90"])
def test_route_falls_back_where_the_wgmma_forward_refuses_the_shape(size, d_a, route, ring):
    """Past what the `wgmma` forward holds (W1y's d_a rows in one ring stage,
    Wout's rows in no more stages than the ring has, the ring beside the
    tile and the rows' state: `fw_ring`) the one-pass forward takes the row
    tiles, and None where those refuse too."""
    assert fk.fwd_wgmma_ring(544, size, d_a) == ring
    assert fk.flow_route(544, size, d_a, False, fk.MODE_TF32) == route


def test_wgmma_forward_shared_memory_and_ring_are_the_source_sums():
    """`kernel_smem` of the `wgmma` forward is `fw_smem` at the least ring,
    term for term from the constants of csrc/flow_fwd_wgmma.cu (the ring's
    barriers, the 64-row tile, the stages of kFwStageK weight rows of half the
    columns, and x, the mix's output, both halves of [t | s'] and logdet a
    row); its ring is the most stages up to kFwRingMax that fit, and at least
    Wout's stages."""
    rows, stage_k = _constant("kFwRows"), _constant("kFwStageK")
    lo, hi, barriers = _constant("kFwRingMin"), _constant("kFwRingMax"), _constant("kFwBarrierFloats")
    assert (rows, _constant("kFwCluster")) == (64, 2) and barriers >= 2 * hi
    for name in ("kFwRows", "kFwCluster", "kFwStageK", "kFwRingMin", "kFwRingMax", "kFwBarrierFloats"):
        assert fk.kernel_limit(name) == _constant(name)
    source = (CSRC / "flow_fwd_wgmma.cu").read_text()
    body = source[source.index("size_t fw_smem("):]
    body = body[: body.index("}")]
    for term in ("kFwBarrierFloats", "kFwRows) * (Hp + 4)", "ring) * kFwStageK * (Hp / 2)",
                 "kFwRows) * (2 * size + 2 * n_out + 1)"):
        assert term in body, term
    limit = fk.kernel_limit("kSmemLimit")
    for tn in (1, 2, 4, 8, 12, 16, 17):
        Hp = 32 * tn
        for size, d_a in ((19, 10), (5, 3), (21, 11), (29, 14)):
            n_out = 2 * (size - d_a)

            def smem(r, Hp=Hp, size=size, n_out=n_out):
                return 4 * (barriers + rows * (Hp + 4) + r * stage_k * Hp // 2 + rows * (2 * size + 2 * n_out + 1))

            assert fk.fwd_wgmma_smem(Hp, size, d_a, 3) == smem(3)
            assert fk.kernel_smem(fk.ROUTE_FWD_WGMMA_TF32, Hp, size, d_a) == smem(lo)
            wout_rows = min((stage_k * Hp // 2 // n_out) // 4 * 4, Hp // 2)
            least = max(lo, -(-(Hp // 2) // wout_rows)) if wout_rows >= 4 else hi + 1
            want = max((r for r in range(least, hi + 1) if smem(r) <= limit), default=0)
            assert fk.fwd_wgmma_ring(Hp, size, d_a) == want
    assert fk.fwd_wgmma_ring(544, 19, 10) == 4


def _parent_gate(Hp: int, size: int, d_a: int, nh: int, mode: str) -> bool:
    """The training gate before the `wgmma` forward: K2a's row tiles'
    shared memory within a block's, and a K2b route."""
    if Hp % 32 or Hp // 32 not in fk.KERNEL_TN or not 0 < d_a < size or nh < 1:
        return False
    if fk.kernel_smem(fk.ROUTE_ROWS, Hp, size, d_a) > fk.kernel_limit("kSmemLimit"):
        return False
    return fk.train_bwd_route(Hp, size, d_a, nh, mode) is not None


@pytest.mark.parametrize("mode", [fk.MODE_TF32, fk.MODE_3XTF32])
@pytest.mark.parametrize("Hp", [32, 128, 544, 768, 1024])
def test_training_gate_opens_wherever_it_did(Hp, mode):
    """`train_kernels_take` opens on every shape it opened on before K2a's
    one-pass route moved (the row tiles' shared memory and a K2b route),
    among them every shape of the K2b route tests' parametrised cases, and
    closes where K2b has no route."""
    shapes = [(s, d, nh) for s in (5, 7, 19, 20, 21, 29, 33, 38, 39, 50) for d in (3, 8, 10, 16, 17, 19)
              for nh in (0, 1, 4, 13, 14) if d < s]
    for size, d_a, nh in shapes:
        before = _parent_gate(Hp, size, d_a, nh, mode)
        now = fk.train_kernels_take(Hp, size, d_a, nh, mode)
        assert now or not before, (Hp, size, d_a, nh, mode)
        if now:
            assert fk.flow_route(Hp, size, d_a, False, mode) is not None
            assert fk.train_bwd_route(Hp, size, d_a, nh, mode) is not None


def test_cpu_tensors_take_the_plain_forward_and_count_nothing():
    """A CPU tensor takes the plain versions in the one-pass mode, whatever
    the route at its shape, and counts no launch, no route and no weight
    preparation."""
    rng = np.random.default_rng(5)
    S, B, size, d_a, H, nh = 3, 40, 5, 3, 32, 1

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32))

    args = [1 + 0.1 * t(S, size), 0.1 * t(S, size), torch.linalg.qr(t(S, size, size))[0].contiguous(),
            t(S, d_a, H, scale=0.5), t(S, H, scale=0.1), t(S, nh, H, H, scale=0.2), t(S, nh, H, scale=0.1),
            t(S, H, 2 * (size - d_a), scale=0.1), t(S, 2 * (size - d_a), scale=0.1)]
    x, h_proj, h_cond = t(B, size), t(S, B, H), t(S, 7, H)
    assert fk.flow_route(H, size, d_a, False, fk.MODE_TF32) == fk.ROUTE_FWD_WGMMA_TF32
    counts = (fk.fused_flow.launches, dict(fk.fused_flow.route_launches), fk.fused_flow_train_fwd.launches,
              dict(fk.fused_flow_train_fwd.route_launches), fk.prepare_train_weights.launches)
    got = fk.fused_flow(x, h_cond, *args, inverse=False, n_cond=7, mode=fk.MODE_TF32)
    want = fk.fused_flow_reference(x, h_cond, *args, inverse=False, n_cond=7)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = fk.fused_flow_train_fwd(x, h_proj, *args, mode=fk.MODE_TF32)
    want = fk.fused_flow_train_reference(x, h_proj, *args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fk.train_weights(x, h_proj, args[5], d_a, fk.MODE_TF32) is None
    assert counts == (fk.fused_flow.launches, dict(fk.fused_flow.route_launches), fk.fused_flow_train_fwd.launches,
                      dict(fk.fused_flow_train_fwd.route_launches), fk.prepare_train_weights.launches)


def test_prepare_train_weights_takes_a_stack_of_no_layer():
    """K4 of a coupling with one hidden layer (nh 0) has no hidden weight to
    lay out: the preparation is an empty tensor of the layout's shape, and
    launches nothing."""
    before = fk.prepare_train_weights.launches
    out = fk.prepare_train_weights(torch.zeros(1, 0, 64, 64))
    assert out.shape == (1, 0, 2, 2, 8, 4, 2, 8, 4) and fk.prepare_train_weights.launches == before


def _jax_case(hidden: int, nh: int, n_cond: int, B: int, seed: int):
    """A JAX flow of 4 steps with `nh` hidden layers of width `hidden`, its
    ActNorm off identity, and its kernel arguments for `n_cond` conditions."""
    import jax
    import jax.numpy as jnp

    from bcnf_tpu.models import CondRealNVP as JaxCondRealNVP
    from bcnf_tpu.models import ConcatenateCondition as JaxConcat
    from bcnf_tpu.models import FeatureNetworkStack as JaxStack
    from bcnf_tpu.models import FullyConnectedFeatureNetwork as JaxFC

    stack = JaxStack([JaxConcat(input_size=None, output_size=6), JaxFC(sizes=[6, 32, 16])])
    model = JaxCondRealNVP(size=7, nested_sizes=[hidden] * (nh + 1), n_blocks=4, n_conditions=16,
                           feature_network_stack=stack, act_norm=True, random_state=0)
    params = model.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    blocks = dict(params["blocks"])
    blocks["actnorm"] = {
        "scale": jnp.asarray((1.0 + 0.2 * rng.normal(size=(3, 7))).astype(np.float32)),
        "bias": jnp.asarray((0.2 * rng.normal(size=(3, 7))).astype(np.float32)),
    }
    h = jnp.asarray(rng.normal(size=(n_cond, 16)).astype(np.float32))
    kargs, h_proj = model._fused_flow_args(dict(params, blocks=blocks), h)
    x = rng.normal(size=(B, 7)).astype(np.float32)
    return kargs, h_proj, x


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("nh", [1, 4])
@pytest.mark.parametrize("hidden", [32, 64])
def test_one_pass_plain_forward_matches_jax_default_mode(hidden, nh):
    """K1's plain one-pass forward (every MLP product through `matmul_tf32`,
    what the `wgmma` forward is held against on the card) against JAX's
    `fused_flow(inverse=False, precision="default", interpret=True)`, 4
    conditions for 14 rows (N does not divide B; row r takes r % 4), within
    JAX's reduced-mode bar."""
    import jax.numpy as jnp

    from bcnf_tpu.ops.flow_kernel import fused_flow as jax_fused_flow

    kargs, h_proj, x = _jax_case(hidden, nh, 4, 14, seed=hidden + nh)
    z_ref, ld_ref = jax_fused_flow(jnp.asarray(x), h_proj, **kargs, inverse=False, n_cond=4, block_b=2,
                                   precision="default", interpret=True)
    args = {k: _t(v) for k, v in dict(kargs, h_proj=h_proj).items()}
    z, ld = fk.fused_flow_reference(_t(x), **args, inverse=False, n_cond=4, mm=matmul_tf32)
    assert np.abs(z.numpy() - np.asarray(z_ref)).max() <= REDUCED_BAR
    assert np.abs(ld.numpy() - np.asarray(ld_ref)).max() <= REDUCED_BAR


@pytest.mark.parametrize("nh", [1, 4])
@pytest.mark.parametrize("hidden", [32, 64])
def test_one_pass_plain_train_forward_matches_jax_default_mode(hidden, nh):
    """K2a's plain one-pass version against JAX's
    `fused_flow_train(precision="default", interpret=True)` (rows with their
    own conditions), z and logdet within JAX's reduced-mode bar, and its step
    inputs the rows each step received."""
    import jax.numpy as jnp

    from bcnf_tpu.ops.flow_kernel import fused_flow_train as jax_fused_flow_train

    kargs, h_proj, x = _jax_case(hidden, nh, 24, 24, seed=10 + hidden + nh)
    z_ref, ld_ref = jax_fused_flow_train(jnp.asarray(x), h_proj, kargs, block_b=8, precision="default",
                                         interpret=True)
    args = [_t(kargs[n]) for n in ARG_NAMES]
    z, ld, bound = fk.fused_flow_train_reference(_t(x), _t(h_proj), *args, mm=matmul_tf32)
    assert np.abs(z.numpy() - np.asarray(z_ref)).max() <= REDUCED_BAR
    assert np.abs(ld.numpy() - np.asarray(ld_ref)).max() <= REDUCED_BAR
    assert torch.equal(bound[0], _t(x)) and bound.shape == (4, 24, 7)


def test_fwd_wgmma_parts_patches_apply_to_the_kernel_source():
    """tools/fwd_wgmma_parts.py's variants are text patches of
    csrc/flow_fwd_wgmma.cu: each finds its text exactly once, and changes it.
    The tool imports neither JAX nor the JAX package."""
    path = ROOT / "tools" / "fwd_wgmma_parts.py"
    spec = importlib.util.spec_from_file_location("fwd_wgmma_parts", path)
    parts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parts)
    src = (CSRC / "flow_fwd_wgmma.cu").read_text()
    for name, pairs in parts.PATCHES.items():
        for old, new in pairs:
            assert src.count(old) == 1 and old != new, name
    assert {"products", "stream", "neither", "no_fma", "no_gelu"} <= set(parts.PATCHES)
    imports = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", path.read_text(), re.MULTILINE)
    assert not [m for m in imports if m.split(".")[0] in ("jax", "jaxlib", "bcnf_tpu")]


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _train_case(cuda, hidden: int, nh: int, rows: int, seed: int) -> tuple:
    """A size-19 flow of 3 steps with `nh` hidden layers of width `hidden` on
    the card (ActNorm off identity): x, h_proj (one condition row a row) and
    the nine kernel arguments."""
    stack = FeatureNetworkStack([ConcatenateCondition(None, 3), LSTMFeatureNetwork(3, 4, 8, 1)])
    model = CondRealNVP(size=19, nested_sizes=[hidden] * (nh + 1), n_blocks=3, n_conditions=8,
                        feature_network_stack=stack, act_norm=True, random_state=0)
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
    x = torch.from_numpy(rng.normal(size=(rows, 19)).astype(np.float32)).to(cuda)
    return x, h_proj, [kargs[n] for n in ARG_NAMES]


def _dist(a, b) -> float:
    return max((x - y).abs().max().item() for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n_cond", [(32, 32), (65, 7), (4099, 7)], ids=["one_cluster", "ragged", "flagship_rows"])
@pytest.mark.parametrize("nh", [1, 4])
@pytest.mark.parametrize("hidden", [16, 100, 526])  # Hp 32, 128, 544
def test_one_pass_forward_on_wgmma_matches_plain_on_card(cuda, monkeypatch, hidden, nh, rows, n_cond):
    """K1's one-pass forward on the `wgmma` forward against the plain
    one-pass version: z and logdet within 5e-3 (JAX's reduced-mode bar), no
    further from it than twice the one-pass row tiles' distance on the same
    inputs, two calls equal to the bit; counted once on its route."""
    x, h_proj, args = _train_case(cuda, hidden, nh, rows, seed=40 + nh)
    h_cond = h_proj[:, :n_cond].contiguous()
    assert fk.flow_route(h_proj.shape[-1], 19, 10, False, fk.MODE_TF32) == fk.ROUTE_FWD_WGMMA_TF32
    before = fk.fused_flow.route_launches[fk.ROUTE_FWD_WGMMA_TF32]
    with torch.no_grad():
        first = fk.fused_flow(x, h_cond, *args, inverse=False, n_cond=n_cond, mode=fk.MODE_TF32)
        second = fk.fused_flow(x, h_cond, *args, inverse=False, n_cond=n_cond, mode=fk.MODE_TF32)
        plain = fk.fused_flow_reference(x, h_cond, *args, inverse=False, n_cond=n_cond, mm=matmul_tf32)
        monkeypatch.setattr(fk, "FWD_WGMMA_MAX_TN", 0)
        tiles = fk.fused_flow(x, h_cond, *args, inverse=False, n_cond=n_cond, mode=fk.MODE_TF32)
        torch.cuda.synchronize()
    assert fk.fused_flow.route_launches[fk.ROUTE_FWD_WGMMA_TF32] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert _dist(first, plain) <= REDUCED_BAR
    assert _dist(first, plain) <= 2 * max(_dist(tiles, plain), 1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [32, 33, 100, 4096, 4099])
@pytest.mark.parametrize("nh", [1, 4])
@pytest.mark.parametrize("hidden", [16, 526])
def test_one_pass_train_forward_on_wgmma_matches_plain_on_card(cuda, monkeypatch, hidden, nh, rows):
    """K2a on the `wgmma` forward (its step inputs stored) against the plain
    one-pass version: z, logdet and the step inputs within 5e-3, no further
    than twice the row tiles' distance, two calls equal to the bit; counted
    on its route."""
    x, h_proj, args = _train_case(cuda, hidden, nh, rows, seed=50 + nh)
    before = fk.fused_flow_train_fwd.route_launches[fk.ROUTE_FWD_WGMMA_TF32]
    with torch.no_grad():
        first = fk.fused_flow_train_fwd(x, h_proj, *args, mode=fk.MODE_TF32)
        second = fk.fused_flow_train_fwd(x, h_proj, *args, mode=fk.MODE_TF32)
        plain = fk.fused_flow_train_reference(x, h_proj, *args, mm=matmul_tf32)
        monkeypatch.setattr(fk, "FWD_WGMMA_MAX_TN", 0)
        tiles = fk.fused_flow_train_fwd(x, h_proj, *args, mode=fk.MODE_TF32)
        torch.cuda.synchronize()
    assert fk.fused_flow_train_fwd.route_launches[fk.ROUTE_FWD_WGMMA_TF32] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert _dist(first, plain) <= REDUCED_BAR
    assert _dist(first, plain) <= 2 * max(_dist(tiles, plain), 1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("hidden", [100, 526])
def test_k2b_on_the_weights_k2a_prepared_equals_its_own_on_card(cuda, hidden):
    """A one-pass training step (`fused_flow_train` through autograd)
    prepares the hidden weights once, K2a runs on the `wgmma` forward and K2b
    on its `wgmma` route on the weights K2a handed over; its grads equal, to
    the bit, K2b's on weights it prepares itself."""
    x, h_proj, args = _train_case(cuda, hidden, 4, 259, seed=60)
    leaves = [t.clone().requires_grad_(True) for t in (x, h_proj, *args)]
    before = (fk.prepare_train_weights.launches, fk.fused_flow_train_fwd.route_launches[fk.ROUTE_FWD_WGMMA_TF32],
              fk.fused_flow_train_bwd.route_launches[fk.ROUTE_WGMMA_TF32])
    z, ld = fk.fused_flow_train(*leaves, mode=fk.MODE_TF32)
    dz, dld = torch.randn_like(z), torch.randn_like(ld)
    grads = torch.autograd.grad((z, ld), leaves, grad_outputs=(dz, dld))
    torch.cuda.synchronize()
    after = (fk.prepare_train_weights.launches, fk.fused_flow_train_fwd.route_launches[fk.ROUTE_FWD_WGMMA_TF32],
             fk.fused_flow_train_bwd.route_launches[fk.ROUTE_WGMMA_TF32])
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1)
    with torch.no_grad():
        _, _, bound = fk.fused_flow_train_fwd(x, h_proj, *args, mode=fk.MODE_TF32)
        own = fk.fused_flow_train_bwd(bound, h_proj, dz, dld, *args, mode=fk.MODE_TF32)
        torch.cuda.synchronize()
    handed = [g for i, g in enumerate(grads) if i != 4]  # the mix's zero grad is not K2b's
    assert all(torch.equal(a, b) for a, b in zip(handed, own))


@pytest.mark.gpu
@pytest.mark.parametrize("nh", [0, 1])
def test_k4_one_pass_forward_on_wgmma_on_card(cuda, nh):
    """K4's one-pass forward (one coupling, nh 0 and 1) runs the `wgmma`
    forward on its kept weights: within 5e-3 of the plain one-pass version,
    the layout prepared once for two calls."""
    from bcnf_tpu_torch.ops.coupling_kernel import fused_affine_coupling, fused_affine_coupling_reference

    rng = np.random.default_rng(70 + nh)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32)).to(cuda)

    H, d_a, d_b, B = 526, 10, 9, 4099
    w = dict(w1y=t(d_a, H, scale=0.3), b1=t(H, scale=0.1), wm=[t(H, H, scale=H ** -0.5) for _ in range(nh)],
             bm=[t(H, scale=0.1) for _ in range(nh)], wout=t(H, 2 * d_b, scale=0.05), bout=t(2 * d_b, scale=0.1))
    x_a, x_b, proj = t(B, d_a), t(B, d_b), t(7, H)
    before = (fused_affine_coupling.launches, fused_affine_coupling.stage_preparations,
              fk.fused_flow.route_launches[fk.ROUTE_FWD_WGMMA_TF32])
    with torch.no_grad():
        one = fused_affine_coupling(x_a, x_b, proj, **w, n_cond=7, mode=fk.MODE_TF32)
        two = fused_affine_coupling(x_a, x_b, proj, **w, n_cond=7, mode=fk.MODE_TF32)
        plain = fused_affine_coupling_reference(x_a, x_b, proj, **w, inverse=False, n_cond=7, mm=matmul_tf32)
        torch.cuda.synchronize()
    assert (fused_affine_coupling.launches - before[0], fused_affine_coupling.stage_preparations - before[1]) == (2, 1)
    assert fk.fused_flow.route_launches[fk.ROUTE_FWD_WGMMA_TF32] == before[2]  # K4 counts its own launches
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    assert _dist(one, plain) <= REDUCED_BAR
