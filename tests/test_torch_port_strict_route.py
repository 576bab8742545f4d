"""The strict K1 (float32 FMA, `csrc/flow_fma.cu`) on the CPU: the shapes its
route takes, the shared memory and the launch layout the host reads from the
kernel's source, the persistent blocks' schedule of row groups, and the
plain version it is held against on the card, against JAX's exact-float32
kernel (the Pallas kernel in interpret mode, as tests/test_flow_kernel.py
runs it). The kernel itself runs only on a card (tests/test_torch_port_imports.py,
`-m gpu`)."""

import ast
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcnf_tpu.ops.flow_kernel import fused_flow as jax_fused_flow
from bcnf_tpu_torch.ops import flow_kernel as fk

CSRC = Path(fk.__file__).resolve().parent / "csrc"
ROOT = Path(__file__).resolve().parent.parent
SIZES = (2, 19, 21, 64, 90)
FMA_CONSTANTS = ("kFmaWarps", "kFmaLaneRows", "kFmaWideTN", "kFmaStageRows", "kFmaRingMin", "kFmaRingMax")


def _pr1_takes(Hp: int, size: int, d_a: int) -> bool:
    """The shared memory the first strict kernel's launcher checked (up to
    slice 13): its BM x Hp tile (64 rows, 32 from Hp 768), BM rows of [x |
    x Q | t s' | logdet] and a two-slab buffer of at least 4 weight rows."""
    BM, n_out = (64 if Hp // 32 <= 17 else 32), 2 * (size - d_a)
    return 4 * (BM * Hp + BM * (2 * size + n_out + 1) + 2 * 4 * Hp) <= 232448


# shapes of SIZES x every valid d_a the first strict kernel took, by TN
PR1_TAKES = {1: 191, 2: 191, 4: 191, 8: 191, 12: 191, 16: 177, 17: 159, 24: 191, 32: 191}


@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
@pytest.mark.parametrize("tn", fk.KERNEL_TN)
def test_strict_route_takes_every_shape_the_first_kernel_took(tn, inverse):
    """`flow_route(..., MODE_FMA)` takes every (size, d_a) the first strict
    kernel took at Hp = 32 TN, for every compiled TN and both directions,
    and routes it to the FMA kernel only."""
    Hp = 32 * tn
    took = [(s, d) for s in SIZES for d in range(1, s) if _pr1_takes(Hp, s, d)]
    assert len(took) == PR1_TAKES[tn]
    for s, d in took:
        assert fk.flow_route(Hp, s, d, inverse, fk.MODE_FMA) == fk.ROUTE_FMA, (Hp, s, d)
    for s, d in ((19, 0), (19, 19)):
        assert fk.flow_route(Hp, s, d, inverse, fk.MODE_FMA) is None
    assert fk.ROUTE_LIBRARY[fk.ROUTE_FMA] == "flow_fma"


def _source_constant(name: str) -> int:
    text = (CSRC / "flow_fma.cu").read_text()
    return int(re.search(rf"constexpr\s+int\s+{name}\s*=\s*(\d+)\s*;", text).group(1))


def test_strict_constants_are_read_from_the_kernel_source():
    """The host's copy of the launch (`fma_smem`, `fma_stage`, `fma_layout`)
    reads the kernel's constants from csrc/flow_fma.cu."""
    assert {n: fk.kernel_limit(n) for n in FMA_CONSTANTS} == {n: _source_constant(n) for n in FMA_CONSTANTS}
    assert (fk.kernel_limit("kFmaWarps"), fk.kernel_limit("kFmaLaneRows"), fk.kernel_limit("kFmaWideTN")) == (8, 4, 17)


@pytest.mark.parametrize("tn", fk.KERNEL_TN)
def test_strict_shared_memory_is_the_source_sum(tn):
    """`kernel_smem(ROUTE_FMA, ...)` is the kernel's `fma_smem` with its
    shortest ring (kFmaRingMin stages) term for term: two barriers a stage,
    the transposed tile Hp x (8 R + 4) with R rows a lane (kFmaLaneRows,
    half above kFmaWideTN), the stages (their weight rows, at least 4 rows
    of Wout), and the round's 8 R rows' state; and every layout the
    launcher picks stays within kSmemLimit, with the longest ring that
    fits."""
    Hp, limit, ring = 32 * tn, fk.kernel_limit("kSmemLimit"), fk.kernel_limit("kFmaRingMin")
    wide = tn > fk.kernel_limit("kFmaWideTN")
    R = fk.kernel_limit("kFmaLaneRows") // (2 if wide else 1)
    assert fk.fma_lane_rows(Hp) == R
    for size, d_a in ((19, 10), (5, 2), (90, 1), (64, 63)):
        stage = max(fk.kernel_limit("kFmaStageRows") // (2 if wide else 1) * Hp, 4 * 2 * (size - d_a))

        def smem(stages):
            return 16 * stages + 4 * (Hp * (8 * R + 4) + stages * stage + 8 * R * (4 * size - 2 * d_a + 1))

        assert fk.kernel_smem(fk.ROUTE_FMA, Hp, size, d_a) == smem(ring) == fk.fma_smem(Hp, size, d_a, ring)
        if smem(ring) <= limit:
            for B in (1, 4096, 80_000):
                rows, blocks, stages, st, got = fk.fma_layout(B, Hp, size, d_a, 132)
                assert (rows, st) == (R, stage) and got == smem(stages) <= limit
                assert fk.kernel_limit("kFmaRingMin") <= stages <= fk.kernel_limit("kFmaRingMax")
                assert stages == fk.kernel_limit("kFmaRingMax") or smem(stages + 1) > limit
                assert blocks == min(-(-B // (4 * R)), 132)


@pytest.mark.parametrize("B,N,layout", [
    (80_000, 8, (4, 132, 4, 8704, 224960)),  # a strict `sample` of 10,000 x 8
    (4096, 4096, (4, 132, 4, 8704, 224960)),  # `log_prob`
], ids=["sample", "log_prob"])
def test_strict_layout_at_the_flagship_shapes(B, N, layout):
    """The flagship (Hp 544, size 19, d_a 10) on 132 SMs: 4 rows a lane (32
    a round), a ring of 4 stages of 16 weight rows in 224,960 bytes, one
    block an SM."""
    assert fk.fma_layout(B, 544, 19, 10, 132) == layout
    assert fk.kernel_smem(fk.ROUTE_FMA, 544, 19, 10) <= layout[4]


@pytest.mark.parametrize("sms", [132, 7, 1])
@pytest.mark.parametrize("B", [1, 63, 64, 4096, 4099, 80_000])
def test_strict_schedule_covers_each_row_once(B, sms):
    """The persistent blocks' ranges of row groups (`fma_groups`, the copy of
    the kernel's `block_groups`), walked in rounds of 2 groups a block (each
    of 4 R rows), cover every row of the batch exactly once; the ranges
    differ in size by at most one group; no block is empty."""
    rows, blocks, *_ = fk.fma_layout(B, 544, 19, 10, sms)
    group = 4 * rows
    groups = fk.fma_groups(B, rows, blocks)
    assert len(groups) == blocks == min(-(-B // group), sms)
    seen = np.zeros(B, np.int64)
    for g0, g1 in groups:
        assert g1 > g0
        for t in range(-(-(g1 - g0) // 2)):
            for rg in range(2):
                g = g0 + 2 * t + rg
                if g < g1:
                    seen[g * group: min(B, (g + 1) * group)] += 1
    assert (seen == 1).all()
    sizes = [g1 - g0 for g0, g1 in groups]
    assert max(sizes) - min(sizes) <= 1


def test_strict_rounds_at_the_flagship_shapes():
    """At 80,000 rows every block walks 19 rounds of 32 rows (5000 groups of
    16 over 132 blocks: 37 or 38 each, the last round of the former with
    one group), not the first kernel's 9.47 waves of 64-row blocks; at 4096
    rows 124 of the 132 SMs take one full round, 8 a half round."""
    rows, blocks, *_ = fk.fma_layout(80_000, 544, 19, 10, 132)
    sizes = [g1 - g0 for g0, g1 in fk.fma_groups(80_000, rows, blocks)]
    assert (rows, blocks) == (4, 132) and set(sizes) == {37, 38} and {-(-n // 2) for n in sizes} == {19}
    rows, blocks, *_ = fk.fma_layout(4096, 544, 19, 10, 132)
    assert [g1 - g0 for g0, g1 in fk.fma_groups(4096, rows, blocks)].count(2) == 124 and blocks == 132


def _stacked(rng, S: int, size: int, d_a: int, nh: int, H: int, N: int) -> dict:
    def r(*shape, scale=1.0):
        return (scale * rng.normal(size=shape)).astype(np.float32)

    q = np.stack([np.linalg.qr(rng.normal(size=(size, size)))[0] for _ in range(S)]).astype(np.float32)
    return {"h_proj": r(S, N, H, scale=0.5), "an_scale": 1 + r(S, size, scale=0.2), "an_bias": r(S, size, scale=0.2),
            "ortho": q, "w1y": r(S, d_a, H, scale=d_a ** -0.5), "b1": r(S, H, scale=0.1),
            "wm": r(S, nh, H, H, scale=H ** -0.5), "bm": r(S, nh, H, scale=0.1),
            "wout": r(S, H, 2 * (size - d_a), scale=0.3 * H ** -0.5), "bout": r(S, 2 * (size - d_a), scale=0.1)}


@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
def test_strict_plain_version_matches_jax_highest_at_hp_1024(inverse):
    """The plain version the strict kernel is held against, on the kernel's
    own arguments padded to the widest width (H 1000 -> Hp 1024), against
    JAX's `fused_flow(precision="highest")` (its exact-float32 kernel mode,
    in interpret mode) on the unpadded ones. JAX's bar, 1e-4."""
    rng = np.random.default_rng(1000)
    S, size, d_a, N, B, H = 3, 7, 3, 4, 16, 1000
    args = _stacked(rng, S, size, d_a, 1, H, N)
    x = rng.normal(size=(B, size)).astype(np.float32)
    ref = jax_fused_flow(jnp.asarray(x), *(jnp.asarray(args[k]) for k in (
        "h_proj", "an_scale", "an_bias", "ortho", "w1y", "b1", "wm", "bm", "wout", "bout")),
        inverse=inverse, n_cond=N, block_b=B, precision="highest", interpret=True)
    kargs, h_proj = fk.pad_hidden({k: torch.from_numpy(v) for k, v in args.items() if k != "h_proj"},
                                  torch.from_numpy(args["h_proj"]))
    assert h_proj.shape[-1] == 1024 and fk.flow_route(1024, size, d_a, inverse, fk.MODE_FMA) == fk.ROUTE_FMA
    before = fk.fused_flow.launches
    ours = fk.fused_flow(torch.from_numpy(x), h_proj, **kargs, inverse=inverse, n_cond=N, mode=fk.MODE_FMA)
    assert fk.fused_flow.launches == before  # a CPU tensor: the plain version, no launch
    for got, want in zip((ours,) if inverse else ours, (ref,) if inverse else ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
def test_strict_plain_version_matches_jax_with_no_square_layer(inverse):
    """nh = 0 (one hidden layer: the input layer feeds the output layer, the
    case K4 runs at one step): the plain version on the JAX model's stacked
    arguments against the JAX model's float32 XLA path (`forward` and
    `inverse_given_h` at "highest", what JAX's own tests hold `fused_flow`
    against): the Pallas kernel in interpret mode cannot tile a weight axis
    of length 0. JAX's bar, 1e-4; rows draws-major, N not dividing B."""
    import jax

    from bcnf_tpu.models import CondRealNVP as JaxCondRealNVP
    from bcnf_tpu.models import ConcatenateCondition as JaxConcat
    from bcnf_tpu.models import FeatureNetworkStack as JaxStack
    from bcnf_tpu.models import FullyConnectedFeatureNetwork as JaxFC

    stack = JaxStack([JaxConcat(input_size=None, output_size=6), JaxFC(sizes=[6, 32, 16])])
    model = JaxCondRealNVP(size=7, nested_sizes=[24], n_blocks=4, n_conditions=16, feature_network_stack=stack,
                           act_norm=True, random_state=0)
    params = model.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    params["blocks"]["actnorm"] = {"scale": jnp.asarray(1.0 + 0.2 * rng.normal(size=(3, 7)).astype(np.float32)),
                                   "bias": jnp.asarray(0.2 * rng.normal(size=(3, 7)).astype(np.float32))}
    N, B = 5, 23
    cond = rng.normal(size=(N, 6)).astype(np.float32)
    h = model.encode(params, (jnp.asarray(cond),))
    # stack_flow_params's layout (JAX's stacks no empty hidden axis): entry K the final coupling
    cp, fin, d_a = params["blocks"]["coupling"]["a"]["layers"], params["final"]["a"]["layers"], model.coupling.d_a
    assert len(cp) == 2

    def cat(a, b):
        return torch.from_numpy(np.concatenate([np.asarray(a), np.asarray(b)[None]], axis=0))

    S, H = 4, 24
    kargs = {"an_scale": cat(params["blocks"]["actnorm"]["scale"], np.ones(7, np.float32)),
             "an_bias": cat(params["blocks"]["actnorm"]["bias"], np.zeros(7, np.float32)),
             "ortho": cat(params["blocks"]["ortho"], np.eye(7, dtype=np.float32)),
             "w1y": cat(cp[0]["w"], fin[0]["w"])[:, :d_a].contiguous(), "b1": cat(cp[0]["b"], fin[0]["b"]),
             "wm": torch.zeros((S, 0, H, H)), "bm": torch.zeros((S, 0, H)),
             "wout": cat(cp[1]["w"], fin[1]["w"]), "bout": cat(cp[1]["b"], fin[1]["b"])}
    h_proj = cat(model.coupling.cond_proj(params["blocks"]["coupling"], h)["a"][0],
                 model.coupling.cond_proj(params["final"], h)["a"][0])
    kargs, h_proj = fk.pad_hidden(kargs, h_proj)
    x = rng.normal(size=(B, 7)).astype(np.float32)
    ours = fk.fused_flow(torch.from_numpy(x), h_proj, **kargs, inverse=inverse, n_cond=N, mode=fk.MODE_FMA)
    rows = np.arange(B) % N
    with jax.default_matmul_precision("highest"):
        if inverse:
            ref = (model.inverse_given_h(params, jnp.asarray(x), h[rows]),)
        else:
            ref = model.forward(params, jnp.asarray(x), jnp.asarray(cond[rows]))
    for got, want in zip((ours,) if inverse else ours, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def _load_tool():
    spec = importlib.util.spec_from_file_location("strict_flow_parts", ROOT / "tools" / "strict_flow_parts.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_strict_parts_patches_apply_to_the_kernel_source():
    """Each variant of tools/strict_flow_parts.py patches csrc/flow_fma.cu at
    exactly one place (it stops on a patch that does not apply); the tool
    imports neither JAX nor the JAX package."""
    tool = _load_tool()
    for name, patches in tool.PATCHES.items():
        for f, old, new in patches:
            assert (CSRC / f).read_text().count(old) == 1, (name, f, old)
            assert old != new
    assert set(tool.PATCHES) >= {"as built", "products", "stream", "no_narrow", "no_gelu", "no_rows"}
    assert set(tool.PATCHES_PR1) == {"as built", "products", "stream", "no_narrow", "no_gelu", "no_rows"}
    tree = ast.parse((ROOT / "tools" / "strict_flow_parts.py").read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert not names & {"jax", "jaxlib", "flax", "optax", "bcnf_tpu"}


def test_sass_against_reads_kernels_by_name():
    """tools/sass_against.py splits a `cuobjdump -sass` listing into kernels
    by name, the anonymous namespace's per-file tag (which differs between
    checkouts) and the instructions' addresses taken out, so that the same
    code in two builds compares equal and other code does not."""
    spec = importlib.util.spec_from_file_location("sass_against", ROOT / "tools" / "sass_against.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)

    def listing(tag: str, op: str) -> str:
        return (f"\tcode for sm_90a\n\t\tFunction : _ZN46_GLOBAL__N__{tag}_13_flow_wgmma_cu_47edce4018flow_inverse"
                f"_wgmmaILi17EEEvPKf\n        /*0000*/                   {op} R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */\n"
                f"        /*0010*/                   EXIT ;                  /* 0x000000000000794d */\n")

    one, two, other = tool.kernels(listing("263b8b0c", "LDC")), tool.kernels(listing("9a1f00aa", "LDC")), tool.kernels(
        listing("263b8b0c", "MOV"))
    assert list(one) == ["_ZN46_GLOBAL__N_18flow_inverse_wgmmaILi17EEEvPKf"] and one == two and one != other


def test_first_strict_kernel_is_gone():
    """The first strict kernel (PR 1's template) and its helpers left
    flow_kernel.cu and flow_common.cuh: one strict kernel, in flow_fma.cu."""
    kernel, common = (CSRC / "flow_kernel.cu").read_text(), (CSRC / "flow_common.cuh").read_text()
    assert "bcnf_fused_flow" not in kernel and "flow_kernel(" not in kernel.replace("rows_flow_kernel(", "")
    for helper in ("mac_slab", "matmul_hidden", "matmul_narrow", "load_slab"):
        assert helper not in common and helper not in kernel
    assert "extern \"C\" int bcnf_fused_flow(" in (CSRC / "flow_fma.cu").read_text()
    assert not re.search(r"\b(wgmma|mma_passes|mma_tf32)\w*\s*<", (CSRC / "flow_fma.cu").read_text())
