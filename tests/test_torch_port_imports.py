"""The port's import boundary and device rule (bcnf_tpu_torch).

This file imports nothing of JAX, so its `gpu` tests also run on a machine
with a card and no JAX: `python -m pytest tests/test_torch_port_imports.py
-m gpu --noconftest` (the repo's conftest configures JAX)."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from bcnf_tpu_torch.bridge import map_tree
from bcnf_tpu_torch.models import CondRealNVP, ConcatenateCondition, FeatureNetworkStack, LSTMFeatureNetwork
from bcnf_tpu_torch.ops import lstm
from bcnf_tpu_torch.ops.coupling_kernel import (
    fused_affine_coupling,
    fused_affine_coupling_reference,
    mlp_params_to_kernel_args,
)
from bcnf_tpu_torch.ops.flow_kernel import fused_flow, fused_flow_reference, padded_width
from bcnf_tpu_torch.ops.lstm_kernel import (
    lstm_direction_bwd,
    lstm_direction_bwd_reference,
    lstm_direction_fwd,
    lstm_direction_fwd_reference,
)
from bcnf_tpu_torch.utils.misc import resolve_device


def _needs_no_gpu() -> None:
    if torch.cuda.is_available():
        pytest.skip("checks the device rule of a host without a GPU")


def _tiny_model(hidden: int = 16) -> CondRealNVP:
    stack = FeatureNetworkStack([ConcatenateCondition(None, 3), LSTMFeatureNetwork(3, 4, 8, 1)])
    return CondRealNVP(size=5, nested_sizes=[hidden, hidden], n_blocks=3, n_conditions=8,
                       feature_network_stack=stack, act_norm=True, random_state=0)


def test_port_imports_no_jax_and_no_bcnf_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import bcnf_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(bcnf_tpu_torch.__path__, 'bcnf_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "need = ['__main__', 'ops.flow_kernel', 'ops.lstm_kernel', 'ops.coupling_kernel', 'train.trainer',\n"
        "        'train.optim', 'train.checkpoint', 'train.history', 'native', 'simulation.physics',\n"
        "        'simulation.priors', 'simulation.camera', 'simulation.observation', 'simulation.sampling',\n"
        "        'simulation.resimulation', 'eval.calibration', 'plots.eval_plots', 'ops.attention',\n"
        "        'models.layers', 'models.splines', 'models.cnn', 'models.pretrained', 'train.online',\n"
        "        'simulation.video_processing', 'plots.debug_plotting', 'eval.crossvalidate',\n"
        "        'hpo.gp_minimize', 'hpo.driver', 'parallel', 'parallel.mesh', 'plots.base',\n"
        "        'plots.data_plots', 'utils.prng', 'utils.profiling', 'utils.summary']\n"
        "assert all('bcnf_tpu_torch.' + n in names for n in need), names\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "for lib in ('sklearn', 'matplotlib', 'pandas'):\n"
        "    assert lib not in sys.modules, lib + ' was imported'\n"
        "bad = [m for m in sys.modules if m == 'bcnf_tpu' or m.startswith('bcnf_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 50


def test_module_lists_of_the_two_packages_match():
    """Every module of `bcnf_tpu` has its counterpart in the port but
    `utils/jit.py`, which only sets a TPU compiler flag (read from the
    files: importing `bcnf_tpu` would load JAX)."""
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent

    def modules(pkg: str) -> set[str]:
        return {str(p.relative_to(root / pkg)) for p in (root / pkg).rglob("*.py")}

    assert modules("bcnf_tpu") - modules("bcnf_tpu_torch") == {"utils/jit.py"}


def test_resolve_device_rule():
    assert resolve_device("cpu") == torch.device("cpu")
    _needs_no_gpu()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")


def test_sample_without_device_raises_on_gpu_less_host():
    _needs_no_gpu()
    model = _tiny_model()
    params = model.init(device="cpu")
    cond = torch.zeros((2, 6, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.sample(params, torch.Generator().manual_seed(0), 4, cond)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init()
    out = model.sample(params, torch.Generator().manual_seed(0), 4, cond, device="cpu")
    assert out.shape == (4, 2, 5) and torch.isfinite(out).all()


def test_sample_cli_without_device_raises_on_gpu_less_host(tmp_path):
    _needs_no_gpu()
    from bcnf_tpu_torch.__main__ import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["sample", "-m", str(tmp_path), "-d", str(tmp_path / "d.pkl"), "-o", str(tmp_path / "o.npy")])


@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
def test_fused_flow_on_cpu_takes_reference_and_launches_nothing(inverse):
    model = _tiny_model()
    params = model.init(device="cpu")
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    kargs, h_proj = model._fused_flow_args(params, h)
    x = torch.from_numpy(rng.normal(size=(11, 5)).astype(np.float32))
    before = fused_flow.launches
    out = fused_flow(x, h_proj, **kargs, inverse=inverse, n_cond=3)
    ref = fused_flow_reference(x, h_proj, **kargs, inverse=inverse, n_cond=3)
    for a, b in zip(out if not inverse else (out,), ref if not inverse else (ref,)):
        assert torch.equal(a, b)
    assert fused_flow.launches == before


def test_padded_width_is_exact_zero_padding():
    assert padded_width(526) == 544 and padded_width(24) == 32 and padded_width(1024) == 1024
    with pytest.raises(ValueError):
        padded_width(1025)
    # the padded and unpadded stacks compute the same function
    model = _tiny_model()
    params = model.init(device="cpu")
    from bcnf_tpu_torch.ops.flow_kernel import stack_flow_params

    h = torch.randn(4, 8, generator=torch.Generator().manual_seed(1))
    kargs_p, hp_p = model._fused_flow_args(params, h)
    kargs = stack_flow_params(model, params)
    hp = hp_p[..., :16]
    x = torch.randn(8, 5, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(
        fused_flow_reference(x, hp_p, **kargs_p, inverse=True, n_cond=4),
        fused_flow_reference(x, hp, **kargs, inverse=True, n_cond=4), atol=1e-6, rtol=0,
    )


def test_smoke_tools_and_port_scripts_import_no_jax():
    """chip_smoke.py, every tool under tools/ and the port's script
    scripts/k3a_parts.py import neither JAX nor the JAX package (an AST walk
    of every import statement, top level or inside a function): they run on
    the card's machine, which has no JAX."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    files = [root / "chip_smoke.py", root / "scripts" / "k3a_parts.py", *sorted((root / "tools").glob("*.py"))]
    found = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            found += [f"{path.name}: {n}" for n in names if n.split(".")[0] in ("jax", "jaxlib", "bcnf_tpu", "optax")]
    assert len(files) >= 8 and not found, found


def test_k3a_parts_patches_apply_to_the_kernel_source():
    """scripts/k3a_parts.py's variants are text patches of the forward LSTM
    kernel: each still finds its target, and each variant dispatches only
    the widths it times (TN 4 and 5)."""
    import importlib.util
    from pathlib import Path

    from bcnf_tpu_torch.ops._build import SOURCES

    path = Path(__file__).resolve().parent.parent / "scripts" / "k3a_parts.py"
    spec = importlib.util.spec_from_file_location("k3a_parts", path)
    parts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parts)
    src = SOURCES["lstm_kernel"].read_text()
    for name, pairs in parts.PATCHES.items():
        out = parts.variant_source(src, pairs)
        assert all(new in out for _, new in pairs), name
        assert "case 4: CALL(4)" in out and "case 5: CALL(5)" in out and "case 6: CALL(6)" not in out, name


def test_wgmma_tf32_parts_patches_apply_to_the_kernel_source():
    """tools/wgmma_tf32_parts.py's variants are text patches of
    csrc/flow_wgmma.cu: each still finds its target once, and each changes
    the source."""
    import importlib.util
    from pathlib import Path

    from bcnf_tpu_torch.ops._build import SOURCES

    path = Path(__file__).resolve().parent.parent / "tools" / "wgmma_tf32_parts.py"
    spec = importlib.util.spec_from_file_location("wgmma_tf32_parts", path)
    parts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parts)
    src = SOURCES["flow_wgmma_tf32"].read_text()
    assert parts.PATCHES["as built"] == []
    for name, pairs in parts.PATCHES.items():
        for old, new in pairs:
            assert src.count(old) == 1 and old != new, name


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("strict", [False, True], ids=["3xtf32", "strict"])
@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
@pytest.mark.parametrize("hidden", [16, 100, 526, 1000])  # wgmma up to Hp 544, wide inverse and forward row tiles above
def test_kernel_matches_reference_on_card(cuda, inverse, hidden, strict):
    """A CUDA tensor launches K1 on the route of its mode and width (counted
    once, and once on that route: in 3xTF32 the `wgmma` inverse and the
    `wgmma` forward up to Hp 544, above it the wide inverse and the wide
    forward), ragged rows included, within the flow bar of the float32
    plain version."""
    from bcnf_tpu_torch.ops.flow_kernel import ROUTE_FMA, ROUTE_FWD_WGMMA, ROUTE_WGMMA, ROUTE_WIDE, ROUTE_WIDE_FWD

    model = _tiny_model(hidden)
    params = model.init(device=cuda)
    rng = np.random.default_rng(3)
    traj = torch.from_numpy(rng.normal(size=(6, 9, 3)).astype(np.float32)).to(cuda)
    kargs, h_proj = model._fused_flow_args(params, model.encode(params, (traj,)))
    x = torch.from_numpy(rng.normal(size=(6 * 37 + 5, 5)).astype(np.float32)).to(cuda)
    route = (ROUTE_FMA if strict else (ROUTE_WIDE if inverse else ROUTE_WIDE_FWD) if hidden > 544
             else ROUTE_WGMMA if inverse else ROUTE_FWD_WGMMA)
    before = fused_flow.launches, fused_flow.route_launches[route]
    out = fused_flow(x, h_proj, **kargs, inverse=inverse, n_cond=6, mode="fma" if strict else "3xtf32")
    ref = fused_flow_reference(x, h_proj, **kargs, inverse=inverse, n_cond=6)
    torch.cuda.synchronize()
    assert (fused_flow.launches, fused_flow.route_launches[route]) == (before[0] + 1, before[1] + 1)
    for a, b in zip(out if not inverse else (out,), ref if not inverse else (ref,)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


def _float32_ulps(t: torch.Tensor, n: int) -> float:
    """n float32 rounding steps at the largest magnitude of t."""
    return n * float(torch.finfo(torch.float32).eps) * max(1.0, t.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
@pytest.mark.parametrize("rows,n_cond", [(6 * 37 + 5, 6), (4099, 7), (64, 64)], ids=["ragged", "n_not_dividing", "one_round"])
@pytest.mark.parametrize("hidden", [16, 100, 526, 1000])  # Hp 32, 128, 544, 1024: csrc/flow_fma.cu, float32 FMA
def test_strict_kernel_against_float64_on_card(cuda, hidden, rows, n_cond, inverse):
    """The strict K1 (`MODE_FMA`, csrc/flow_fma.cu) against the plain version
    in float64: no further from it than twice the float32 plain version's
    own distance (plus 4 float32 steps at the largest value, the floor of
    two float32 orders of summation), so it is float32 arithmetic and not a
    reduced one; within the flow bar of the float32 plain version; and two
    calls equal to the bit (no atomics, a fixed order of every sum)."""
    from bcnf_tpu_torch.ops.flow_kernel import MODE_FMA, ROUTE_FMA

    model = _tiny_model(hidden)
    params = model.init(device=cuda)
    rng = np.random.default_rng(hidden + rows)
    traj = torch.from_numpy(rng.normal(size=(n_cond, 9, 3)).astype(np.float32)).to(cuda)
    kargs, h_proj = model._fused_flow_args(params, model.encode(params, (traj,)))
    x = torch.from_numpy(rng.normal(size=(rows, 5)).astype(np.float32)).to(cuda)
    before = fused_flow.route_launches[ROUTE_FMA]
    one = fused_flow(x, h_proj, **kargs, inverse=inverse, n_cond=n_cond, mode=MODE_FMA)
    two = fused_flow(x, h_proj, **kargs, inverse=inverse, n_cond=n_cond, mode=MODE_FMA)
    torch.cuda.synchronize()
    assert fused_flow.route_launches[ROUTE_FMA] == before + 2
    p32 = fused_flow_reference(x, h_proj, **kargs, inverse=inverse, n_cond=n_cond)
    p64 = fused_flow_reference(x.double(), h_proj.double(), **{k: v.double() for k, v in kargs.items()},
                               inverse=inverse, n_cond=n_cond)
    wrap = (lambda t: (t,)) if inverse else tuple
    for a, b, c, d in zip(wrap(one), wrap(two), wrap(p32), wrap(p64)):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, atol=1e-4, rtol=0)
        d32, dk = (c.double() - d).abs().max().item(), (a.double() - d).abs().max().item()
        assert dk <= 2 * d32 + _float32_ulps(d, 4), (dk, d32)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 63, 4096, 4099, 80_000])
@pytest.mark.parametrize("Hp,size,d_a", [(544, 19, 10), (32, 5, 2), (1024, 19, 10), (544, 90, 33)])
def test_strict_layout_on_card_is_the_host_copy(cuda, Hp, size, d_a, B):
    """The strict kernel's launcher picks the layout `fma_layout` computes
    for this card's SM count (rows a warp, blocks, ring stages, floats a
    stage, shared memory)."""
    from bcnf_tpu_torch.ops.flow_kernel import fma_card_layout, fma_layout

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert fma_card_layout(B, Hp, size, d_a) == fma_layout(B, Hp, size, d_a, sms)


@pytest.mark.gpu
@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
@pytest.mark.parametrize("hidden", [16, 526, 1000])  # wgmma up to Hp 544, row tiles above
def test_one_pass_kernel_matches_plain_one_pass_on_card(cuda, inverse, hidden):
    """K1 in one TF32 pass on the one-pass route of its width (`wgmma` up to
    Hp 544 both ways, the row tiles above), ragged rows included, within
    5e-3 (the JAX package's reduced-mode bar) of the plain one-pass version;
    counted once on its route. The float32 plain version is off by more than
    the 3xTF32 kernel is: the pass is one."""
    from bcnf_tpu_torch.ops.flow_kernel import ROUTE_FWD_WGMMA_TF32, ROUTE_ROWS_TF32, ROUTE_WGMMA_TF32
    from bcnf_tpu_torch.ops.tf32 import matmul_tf32

    model = _tiny_model(hidden)
    params = model.init(device=cuda)
    rng = np.random.default_rng(3)
    traj = torch.from_numpy(rng.normal(size=(6, 9, 3)).astype(np.float32)).to(cuda)
    kargs, h_proj = model._fused_flow_args(params, model.encode(params, (traj,)))
    x = torch.from_numpy(rng.normal(size=(6 * 37 + 5, 5)).astype(np.float32)).to(cuda)
    route = ROUTE_ROWS_TF32 if hidden > 544 else ROUTE_WGMMA_TF32 if inverse else ROUTE_FWD_WGMMA_TF32
    before = fused_flow.route_launches[route]
    out = fused_flow(x, h_proj, **kargs, inverse=inverse, n_cond=6, mode="tf32")
    three = fused_flow(x, h_proj, **kargs, inverse=inverse, n_cond=6)
    ref = fused_flow_reference(x, h_proj, **kargs, inverse=inverse, n_cond=6, mm=matmul_tf32)
    f32 = fused_flow_reference(x, h_proj, **kargs, inverse=inverse, n_cond=6)
    torch.cuda.synchronize()
    assert fused_flow.route_launches[route] == before + 1
    pick = (lambda o: o) if inverse else (lambda o: o[0])
    torch.testing.assert_close(pick(out), pick(ref), atol=5e-3, rtol=0)
    assert (pick(out) - pick(f32)).abs().max() > (pick(three) - pick(f32)).abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("hidden", [526, 1000])
def test_one_pass_training_kernels_match_plain_one_pass_on_card(cuda, hidden):
    """K2a and K2b in one TF32 pass (through `fused_flow_train(mode="tf32")`)
    against their plain one-pass versions: z and logdet within 5e-3, each
    grad within 5e-3 max(1, max |plain|); counted once by mode."""
    from bcnf_tpu_torch.ops.flow_kernel import (
        fused_flow_train,
        fused_flow_train_backward_reference,
        fused_flow_train_bwd,
        fused_flow_train_fwd,
        fused_flow_train_reference,
    )
    from bcnf_tpu_torch.ops.tf32 import matmul_tf32

    stack = FeatureNetworkStack([ConcatenateCondition(None, 3), LSTMFeatureNetwork(3, 4, 8, 1)])
    model = CondRealNVP(size=19, nested_sizes=[hidden] * 3, n_blocks=4, n_conditions=8,
                        feature_network_stack=stack, act_norm=True, random_state=0)
    with torch.no_grad():
        x, h_proj, args = _train_args(model, model.init(device=cuda), B=300, seed=4, device=cuda)
    before = fused_flow_train_fwd.mode_launches["tf32"], fused_flow_train_bwd.mode_launches["tf32"]
    leaves = [t.clone().requires_grad_(True) for t in (x, h_proj, *args)]
    z, ld = fused_flow_train(*leaves, mode="tf32")
    dz, dld = torch.randn_like(z), torch.randn_like(ld)
    grads = torch.autograd.grad((z, ld), leaves, grad_outputs=(dz, dld))
    torch.cuda.synchronize()
    assert (fused_flow_train_fwd.mode_launches["tf32"], fused_flow_train_bwd.mode_launches["tf32"]) == (
        before[0] + 1, before[1] + 1)
    z_r, ld_r, bound = fused_flow_train_reference(x, h_proj, *args, mm=matmul_tf32)
    torch.testing.assert_close(z, z_r, atol=5e-3, rtol=0)
    torch.testing.assert_close(ld, ld_r, atol=5e-3, rtol=0)
    refs = fused_flow_train_backward_reference(bound, h_proj, dz, dld, *args, mm=matmul_tf32)
    names = ("x", "h_proj", "an_scale", "an_bias", "w1y", "b1", "wm", "bm", "wout", "bout")
    for name, g, r in zip(names, [g for i, g in enumerate(grads) if i != 4], refs):
        torch.testing.assert_close(g, r, atol=5e-3 * max(1.0, r.abs().max().item()), rtol=0, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [64, 65, 4099], ids=["one_block", "one_row_past", "ragged"])
def test_wgmma_inverse_at_the_flagship_width_on_card(cuda, rows):
    """K1's inverse on `wgmma` at Hp 544 (size 19, 4 hidden layers, 4 steps)
    against the float32 plain version at the flow bar: a block of exactly 64
    rows, one row more, and a ragged count over 7 conditions; the weights
    prepared on the card are the CPU's bit for bit; one block an SM."""
    from bcnf_tpu_torch.ops import _build
    from bcnf_tpu_torch.ops.flow_kernel import prepare_weights

    stack = FeatureNetworkStack([ConcatenateCondition(None, 3), LSTMFeatureNetwork(3, 4, 8, 1)])
    model = CondRealNVP(size=19, nested_sizes=[526] * 5, n_blocks=4, n_conditions=8,
                        feature_network_stack=stack, act_norm=True, random_state=0)
    with torch.no_grad():
        x, h_proj, args = _train_args(model, model.init(device=cuda), B=7, seed=20, device=cuda)
        kargs = dict(zip(("an_scale", "an_bias", "ortho", "w1y", "b1", "wm", "bm", "wout", "bout"), args))
        x = torch.randn((rows, 19), generator=torch.Generator(device=cuda).manual_seed(21), device=cuda)
        staged = prepare_weights(kargs["wm"])
        assert torch.equal(staged.cpu(), prepare_weights(kargs["wm"].cpu()))
        before = fused_flow.route_launches["wgmma"]
        out = fused_flow(x, h_proj, **kargs, inverse=True, n_cond=7)
        ref = fused_flow_reference(x, h_proj, **kargs, inverse=True, n_cond=7)
        torch.cuda.synchronize()
    assert fused_flow.route_launches["wgmma"] == before + 1
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    assert _build.load_library("flow_wgmma").bcnf_flow_wgmma_occupancy(544, 19, 10) == 1


def _wide_model(hidden: int, n_blocks: int = 4) -> CondRealNVP:
    """The flagship's flow shape (size 19, 4 hidden layers) at `hidden`."""
    stack = FeatureNetworkStack([ConcatenateCondition(None, 3), LSTMFeatureNetwork(3, 4, 8, 1)])
    return CondRealNVP(size=19, nested_sizes=[hidden] * 5, n_blocks=n_blocks, n_conditions=8,
                       feature_network_stack=stack, act_norm=True, random_state=0)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n_cond", [(257, 7), (4097, 9), (64, 64)], ids=["odd_tiles", "64k_plus_1", "one_tile"])
@pytest.mark.parametrize("hidden", [32, 100, 500, 526])  # Hp 32, 128, 512, 544: TN 1, 4, 16, 17
def test_3xtf32_wgmma_inverse_against_float64_on_card(cuda, hidden, rows, n_cond):
    """K1's 3xTF32 inverse on `wgmma` (2-block clusters splitting each hidden
    layer's columns, each k-stage's three passes folded into a float32 sum)
    at TN 1, 4, 16 and 17 and ragged rows (64 k + 1 over an odd count of
    64-row tiles), against the plain version in float64: no further from it
    than twice the float32 plain version's own distance (plus 4 float32
    steps at the largest value, the floor of two float32 orders of
    summation); within the flow bar of the float32 plain version; two calls
    equal to the bit (no atomics, one order of every sum); counted once a
    call on its route."""
    model = _wide_model(hidden)
    with torch.no_grad():
        _, h_proj, args = _train_args(model, model.init(device=cuda), B=n_cond, seed=hidden + rows, device=cuda)
        kargs = dict(zip(("an_scale", "an_bias", "ortho", "w1y", "b1", "wm", "bm", "wout", "bout"), args))
        x = torch.randn((rows, 19), generator=torch.Generator(device=cuda).manual_seed(rows), device=cuda)
        before = fused_flow.route_launches["wgmma"]
        one = fused_flow(x, h_proj, **kargs, inverse=True, n_cond=n_cond)
        two = fused_flow(x, h_proj, **kargs, inverse=True, n_cond=n_cond)
        p32 = fused_flow_reference(x, h_proj, **kargs, inverse=True, n_cond=n_cond)
        p64 = fused_flow_reference(x.double(), h_proj.double(), **{k: v.double() for k, v in kargs.items()},
                                   inverse=True, n_cond=n_cond)
        torch.cuda.synchronize()
    assert fused_flow.route_launches["wgmma"] == before + 2
    assert torch.equal(one, two)
    torch.testing.assert_close(one, p32, atol=1e-4, rtol=0)
    d32, dk = (p32.double() - p64).abs().max().item(), (one.double() - p64).abs().max().item()
    assert dk <= 2 * d32 + _float32_ulps(p64, 4), (dk, d32)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [257, 4099])
def test_k4_3xtf32_inverse_at_one_step_on_card(cuda, rows):
    """K4's 3xTF32 inverse (K1's `wgmma` kernel at one step, on the weight
    stages it keeps) at the flagship's width (Hp 544): within the flow bar
    of its plain version, from the plain version in float64 no further than
    twice the float32 plain version's own distance, two calls equal to the
    bit, counted on K4."""
    model = _wide_model(526, n_blocks=2)
    params = model.init(device=cuda)
    cp = model.coupling
    blk0 = map_tree(lambda t: t[0], params["blocks"]["coupling"])
    args = mlp_params_to_kernel_args(blk0["a"], cp.d_a)
    rng = np.random.default_rng(rows)
    with torch.no_grad():
        h = model.encode(params, (torch.from_numpy(rng.normal(size=(7, 9, 3)).astype(np.float32)).to(cuda),))
        h_proj = cp.cond_proj(blk0, h)["a"][0]
        x = torch.from_numpy(rng.normal(size=(rows, 19)).astype(np.float32)).to(cuda)
        x_a, x_b = x[:, : cp.d_a].contiguous(), x[:, cp.d_a:].contiguous()
        before = fused_affine_coupling.launches
        one = fused_affine_coupling(x_a, x_b, h_proj, **args, inverse=True)
        two = fused_affine_coupling(x_a, x_b, h_proj, **args, inverse=True)
        p32 = fused_affine_coupling_reference(x_a, x_b, h_proj, **args, inverse=True, n_cond=7)
        p64 = fused_affine_coupling_reference(x_a.double(), x_b.double(), h_proj.double(),
                                              **map_tree(lambda t: t.double(), args), inverse=True, n_cond=7)
        torch.cuda.synchronize()
    assert fused_affine_coupling.launches == before + 2
    assert torch.equal(one, two)
    torch.testing.assert_close(one, p32, atol=1e-4, rtol=0)
    d32, dk = (p32.double() - p64).abs().max().item(), (one.double() - p64).abs().max().item()
    assert dk <= 2 * d32 + _float32_ulps(p64, 4), (dk, d32)


@pytest.mark.gpu
def test_3xtf32_wgmma_library_spills_nothing_on_card(cuda):
    """The 3xTF32 `flow_wgmma` library as built: each of its 7 kernel
    instances (TN 1, 2, 4, 8, 12, 16, 17) keeps nothing on the stack or in
    local memory (where ptxas spills registers), and its SASS holds no
    local-memory load or store."""
    import re
    from pathlib import Path

    from bcnf_tpu_torch.ops import _build

    usage = _build.resource_usage("flow_wgmma")
    assert len(usage) == 7 and all(u["STACK"] == 0 and u["LOCAL"] == 0 for u in usage.values()), usage
    sass = subprocess.run([str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass", str(_build.build("flow_wgmma"))],
                          capture_output=True, text=True, check=True).stdout
    assert sass.count("Function : ") == 7 and not re.search(r"\b(LDL|STL)\b", sass)


def _train_args(model: CondRealNVP, params: dict, B: int, seed: int, device) -> tuple:
    """K2a/K2b arguments in the training layout (one condition row per row),
    ActNorm moved off identity so its grads are exercised."""
    rng = np.random.default_rng(seed)
    an = params["blocks"]["actnorm"]
    params = dict(params, blocks=dict(params["blocks"], actnorm={
        "scale": an["scale"] + torch.from_numpy(0.2 * rng.normal(size=an["scale"].shape).astype(np.float32)).to(device),
        "bias": torch.from_numpy(0.2 * rng.normal(size=an["bias"].shape).astype(np.float32)).to(device),
    }))
    traj = torch.from_numpy(rng.normal(size=(B, 9, 3)).astype(np.float32)).to(device)
    kargs, h_proj = model._fused_flow_args(params, model.encode(params, (traj,)))
    x = torch.from_numpy(rng.normal(size=(B, model.size)).astype(np.float32)).to(device)
    return x, h_proj, [kargs[n] for n in ("an_scale", "an_bias", "ortho", "w1y", "b1", "wm", "bm", "wout", "bout")]


@pytest.mark.gpu
@pytest.mark.parametrize("hidden", [16, 100, 526])
def test_train_kernels_match_plain_versions_on_card(cuda, hidden):
    """K2a's outputs and every grad K2b gives, against the plain versions, on
    a ragged row count; each kernel counts one launch."""
    from bcnf_tpu_torch.ops.flow_kernel import (
        fused_flow_train,
        fused_flow_train_backward_reference,
        fused_flow_train_bwd,
        fused_flow_train_fwd,
        fused_flow_train_reference,
    )

    stack = FeatureNetworkStack([ConcatenateCondition(None, 3), LSTMFeatureNetwork(3, 4, 8, 1)])
    model = CondRealNVP(size=5, nested_sizes=[hidden] * 3, n_blocks=4, n_conditions=8,
                        feature_network_stack=stack, act_norm=True, random_state=0)
    with torch.no_grad():
        x, h_proj, args = _train_args(model, model.init(device=cuda), B=6 * 37 + 5, seed=4, device=cuda)
    before = (fused_flow_train_fwd.launches, fused_flow_train_bwd.launches)
    leaves = [t.clone().requires_grad_(True) for t in (x, h_proj, *args)]
    z, ld = fused_flow_train(*leaves)
    dz, dld = torch.randn_like(z), torch.randn_like(ld)
    grads = torch.autograd.grad((z, ld), leaves, grad_outputs=(dz, dld))
    torch.cuda.synchronize()
    assert (fused_flow_train_fwd.launches, fused_flow_train_bwd.launches) == (before[0] + 1, before[1] + 1)
    z_r, ld_r, bound = fused_flow_train_reference(x, h_proj, *args)
    torch.testing.assert_close(z, z_r, atol=1e-4, rtol=0)
    torch.testing.assert_close(ld, ld_r, atol=1e-4, rtol=0)
    refs = fused_flow_train_backward_reference(bound, h_proj, dz, dld, *args)
    names = ("x", "h_proj", "an_scale", "an_bias", "w1y", "b1", "wm", "bm", "wout", "bout")
    for name, g, r in zip(names, [g for i, g in enumerate(grads) if i != 4], refs):
        torch.testing.assert_close(g, r, atol=5e-4, rtol=1e-3, msg=name)
    assert torch.equal(grads[4], torch.zeros_like(args[2]))


@pytest.mark.gpu
@pytest.mark.parametrize("hidden,rows", [(1000, 6 * 37 + 5), (526, 20), (1000, 20)],
                         ids=["16_row_tiles", "one_partial_block", "one_partial_16_row_block"])
def test_train_forward_matches_plain_version_on_card(cuda, hidden, rows):
    """K2a (3xTF32 hidden products) at the 16-row tiles of the widest widths
    and at a batch under one block: z, logdet and the step inputs against the
    plain version at the flow bar; one launch counted."""
    from bcnf_tpu_torch.ops.flow_kernel import fused_flow_train_fwd, fused_flow_train_reference

    stack = FeatureNetworkStack([ConcatenateCondition(None, 3), LSTMFeatureNetwork(3, 4, 8, 1)])
    model = CondRealNVP(size=19, nested_sizes=[hidden] * 3, n_blocks=4, n_conditions=8,
                        feature_network_stack=stack, act_norm=True, random_state=0)
    with torch.no_grad():
        x, h_proj, args = _train_args(model, model.init(device=cuda), B=rows, seed=18, device=cuda)
        before = fused_flow_train_fwd.launches
        out = fused_flow_train_fwd(x, h_proj, *args)
        ref = fused_flow_train_reference(x, h_proj, *args)
        torch.cuda.synchronize()
    assert fused_flow_train_fwd.launches == before + 1
    for name, a, b in zip(("z", "logdet", "bound"), out, ref):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0, msg=name)


@pytest.mark.gpu
def test_two_shard_step_on_card_matches_the_unsharded_step(cuda):
    """The data-parallel step on a mesh of two shards placed on the one card
    (`Mesh([cuda, cuda])`, as chip_smoke.py's phase 16): each shard's
    forward and backward run K2a/K2b on its 256 rows (twice the unsharded
    step's launches), and the mean-reduced grads are the unsharded step's at
    the JAX grad bar (atol 5e-4, rtol 1e-3)."""
    from bcnf_tpu_torch.bridge import map_tree, tree_leaves
    from bcnf_tpu_torch.ops.flow_kernel import fused_flow_train_bwd, fused_flow_train_fwd
    from bcnf_tpu_torch.parallel import Mesh, replicate_trainable
    from bcnf_tpu_torch.train import Trainer

    model = _tiny_model(100)
    params = model.init(device=cuda)
    rng = np.random.default_rng(9)
    y = torch.from_numpy(rng.normal(size=(512, 5)).astype(np.float32)).to(cuda)
    traj = torch.from_numpy(rng.normal(size=(512, 9, 3)).astype(np.float32)).to(cuda)
    config = {"global": {"dtype": "float32"}, "optimizer": {"type": "Adam", "kwargs": {"lr": 1e-3}},
              "lr_scheduler": {"type": "ReduceLROnPlateau", "kwargs": {}},
              "training": {"validation_split": 0.0, "val_loss_window_size": 1, "val_loss_patience": None,
                           "val_loss_tolerance_mode": "rel", "val_loss_tolerance": 1e-3, "batch_size": 512,
                           "n_epochs": 1}}
    trainer = Trainer(config, data=(y.cpu().numpy(), [traj.cpu().numpy()]), mesh=Mesh([cuda, cuda]))
    p1 = map_tree(lambda t: t.detach().clone().requires_grad_(True), params)
    before = fused_flow_train_fwd.launches
    z, ld = model.forward(p1, y, traj, train=True)
    torch.mean(0.5 * torch.sum(z**2, dim=-1) - ld).backward()
    one = fused_flow_train_fwd.launches - before
    replicas = replicate_trainable(trainer.mesh, map_tree(lambda t: t.detach().clone().requires_grad_(True), params))
    before = fused_flow_train_fwd.launches, fused_flow_train_bwd.launches
    trainer.shard_grads(model, replicas, y, [traj], [None, None])
    assert one == 1 and (fused_flow_train_fwd.launches, fused_flow_train_bwd.launches) == (before[0] + 2, before[1] + 2)
    for a, b in zip(tree_leaves(replicas[0]), tree_leaves(p1)):
        if b.grad is not None:
            torch.testing.assert_close(a.grad, b.grad, atol=5e-4, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,launched", [(32, 1), (31, 0)])
def test_training_forward_on_card_takes_the_kernels_from_the_batch_floor(cuda, rows, launched):
    """Under autograd a CUDA batch of >= 32 rows (the floor the card's sweep
    set) goes through K2a/K2b; one row fewer takes the plain path; both give
    the CPU's loss and grads."""
    from bcnf_tpu_torch.bridge import map_tree, tree_leaves
    from bcnf_tpu_torch.ops.flow_kernel import fused_flow_train_bwd, fused_flow_train_fwd

    model = _tiny_model(100)
    params = model.init(device="cpu")
    rng = np.random.default_rng(8)
    y = torch.from_numpy(rng.normal(size=(rows, 5)).astype(np.float32))
    traj = torch.from_numpy(rng.normal(size=(rows, 9, 3)).astype(np.float32))
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        p = map_tree(lambda t: t.to(dev).requires_grad_(True), params)
        before = (fused_flow_train_fwd.launches, fused_flow_train_bwd.launches)
        z, ld = model.forward(p, y.to(dev), traj.to(dev), train=True)
        torch.mean(0.5 * torch.sum(z**2, dim=-1) - ld).backward()
        after = (fused_flow_train_fwd.launches, fused_flow_train_bwd.launches)
        assert after == (before[0] + launched * (dev.type == "cuda"), before[1] + launched * (dev.type == "cuda"))
        grads[dev.type] = [t.grad for t in tree_leaves(p)]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        if a is not None and b is not None:
            torch.testing.assert_close(a.cpu(), b, atol=5e-4, rtol=1e-3)


@pytest.mark.gpu
def test_sample_on_card_matches_cpu(cuda):
    model = _tiny_model()
    cond = torch.randn((4, 9, 3), generator=torch.Generator().manual_seed(5))
    before = fused_flow.launches
    on_card = model.sample(model.init(device=cuda), torch.Generator().manual_seed(6), 50, cond, device=cuda)
    assert fused_flow.launches == before + 1
    on_cpu = model.sample(model.init(device="cpu"), torch.Generator().manual_seed(6), 50, cond, device="cpu")
    torch.testing.assert_close(on_card.cpu(), on_cpu, atol=1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("hidden,batch,steps", [(12, 7, 10), (140, 259, 30), (128, 33, 16), (256, 40, 5),
                                                (212, 64, 30), (212, 100, 30)])  # the video model's LSTM: Hp 224
def test_lstm_kernels_match_plain_versions_on_card(cuda, reverse, hidden, batch, steps):
    """K3a's hs, cs and K3b's dxp, dW_hh against the plain versions, ragged
    batches (the bars of tests/test_lstm_kernel.py, dW_hh's atol scaled to
    its largest value); each wrapper counts one launch."""
    g = torch.Generator(device=cuda).manual_seed(8)
    xp = torch.randn((steps, batch, 4 * hidden), generator=g, device=cuda)
    w_hh = torch.randn((hidden, 4 * hidden), generator=g, device=cuda) / hidden**0.5
    before = (lstm_direction_fwd.launches, lstm_direction_bwd.launches)
    hs, cs = lstm_direction_fwd(xp, w_hh, reverse)
    hs_r, cs_r = lstm_direction_fwd_reference(xp, w_hh, reverse)
    dhs = torch.randn(hs.shape, generator=g, device=cuda)
    dxp, dw = lstm_direction_bwd(xp, w_hh, hs, cs, dhs, reverse)
    dxp_r, dw_r = lstm_direction_bwd_reference(xp, w_hh, hs, cs, dhs, reverse)
    torch.cuda.synchronize()
    assert (lstm_direction_fwd.launches, lstm_direction_bwd.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(hs, hs_r, atol=1e-5, rtol=0)
    torch.testing.assert_close(cs, cs_r, atol=1e-5, rtol=0)
    torch.testing.assert_close(dxp, dxp_r, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(dw, dw_r, atol=1e-4 * dw_r.abs().max().item(), rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("hidden", [140, 256])
@pytest.mark.parametrize("batch", [64, 65], ids=["one_cluster", "one_row_past"])
def test_lstm_forward_at_the_cluster_edge_on_card(cuda, reverse, hidden, batch):
    """K3a's cluster owns 64 rows: a batch of exactly one cluster and of one
    row more (a second cluster with one valid row), hs and cs at 1e-5."""
    from bcnf_tpu_torch.ops.lstm_kernel import fwd_layout

    assert fwd_layout(batch, hidden, cuda)["rows"] == 64
    g = torch.Generator(device=cuda).manual_seed(19)
    xp = torch.randn((12, batch, 4 * hidden), generator=g, device=cuda)
    w_hh = torch.randn((hidden, 4 * hidden), generator=g, device=cuda) / hidden**0.5
    before = lstm_direction_fwd.launches
    hs, cs = lstm_direction_fwd(xp, w_hh, reverse)
    hs_r, cs_r = lstm_direction_fwd_reference(xp, w_hh, reverse)
    torch.cuda.synchronize()
    assert lstm_direction_fwd.launches == before + 1
    torch.testing.assert_close(hs, hs_r, atol=1e-5, rtol=0)
    torch.testing.assert_close(cs, cs_r, atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("hidden", [140, 128])
def test_lstm_forward_layout_at_batch_4096_on_card(cuda, hidden):
    """At the encoders' widths K3a's 64 clusters of 8 blocks sit two blocks
    an SM: more clusters resident at once than one block an SM allows
    (132 / 8), so batch 4096 takes at most three waves."""
    from bcnf_tpu_torch.ops.lstm_kernel import fwd_layout

    layout = fwd_layout(4096, hidden, cuda)
    assert (layout["rows"], layout["clusters"]) == (64, 64)
    assert layout["resident_clusters"] > 132 // 8, layout
    assert layout["waves"] == -(-64 // layout["resident_clusters"]) <= 3, layout


@pytest.mark.gpu
def test_fused_lstm_on_card_matches_the_cpu_loop(cuda, monkeypatch):
    """2 layers, bidirectional, under BCNF_FUSED_LSTM=1: 4 launches of each
    kernel; values and grads as the CPU time loop gives them."""
    params = lstm.lstm_init(torch.Generator().manual_seed(9), 3, 12, 2, bidirectional=True)
    x = torch.randn((37, 10, 3), generator=torch.Generator().manual_seed(10))
    results = {}
    for dev in (cuda, torch.device("cpu")):
        monkeypatch.setenv("BCNF_FUSED_LSTM", "1" if dev.type == "cuda" else "0")
        p = map_tree(lambda t: t.to(dev).requires_grad_(True), params)
        before = (lstm_direction_fwd.launches, lstm_direction_bwd.launches)
        out = lstm.lstm_apply(p, x.to(dev), 12)
        torch.sum(torch.sin(out)).backward()
        launched = (lstm_direction_fwd.launches - before[0], lstm_direction_bwd.launches - before[1])
        assert launched == ((4, 4) if dev.type == "cuda" else (0, 0))
        results[dev.type] = (out.detach().cpu(), [t.grad.cpu() for layer in p["layers"] for d in layer.values()
                                                  for t in d.values()])
    torch.testing.assert_close(results["cuda"][0], results["cpu"][0], atol=1e-5, rtol=0)
    for a, b in zip(results["cuda"][1], results["cpu"][1]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("hidden,n_hidden", [(16, 0), (100, 2), (526, 4)])
def test_coupling_kernel_matches_plain_version_on_card(cuda, inverse, hidden, n_hidden):
    """K4 (K1's kernels at one step: the inverse on `wgmma`, the forward on
    the row tiles) on a ragged row count against 7 conditions, a coupling
    with no hidden-to-hidden layer among them; one K4 launch counted, none
    of K1's."""
    from bcnf_tpu_torch.models.cnf import AffineCoupling

    port = AffineCoupling(input_size=19, nested_sizes=[hidden] * (n_hidden + 1), n_conditions=32)
    tp = map_tree(lambda t: t.to(cuda), port.init(torch.Generator().manual_seed(5)))
    g = torch.Generator(device=cuda).manual_seed(6)
    rows = 7 * 41 + 3
    x_a = torch.randn((rows, port.d_a), generator=g, device=cuda)
    x_b = torch.randn((rows, port.d_b), generator=g, device=cuda)
    h_proj = port.cond_proj(tp, torch.randn((7, 32), generator=g, device=cuda))["a"][0]
    args = mlp_params_to_kernel_args(tp["a"], port.d_a)
    before = fused_affine_coupling.launches, fused_flow.launches
    out = fused_affine_coupling(x_a, x_b, h_proj, **args, inverse=inverse)
    ref = fused_affine_coupling_reference(x_a, x_b, h_proj, **args, inverse=inverse, n_cond=7)
    torch.cuda.synchronize()
    assert (fused_affine_coupling.launches, fused_flow.launches) == (before[0] + 1, before[1])  # K1's kernels, K4's count
    for a, b in zip((out,) if inverse else out, (ref,) if inverse else ref):
        assert a.is_contiguous()
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_per_coupling_path_on_card_matches_the_whole_flow_kernel(cuda):
    """With use_pallas_coupling, inverse and the no-grad forward launch K4
    in each of the 3 couplings and agree with K1."""
    model = _tiny_model(100)
    params = model.init(device=cuda)
    cond = torch.randn((4, 9, 3), generator=torch.Generator().manual_seed(11)).to(cuda)
    z = torch.randn((9, 4, 5), generator=torch.Generator().manual_seed(12)).to(cuda)
    with torch.no_grad():
        model.use_pallas_coupling = True
        before = (fused_affine_coupling.launches, fused_flow.launches)
        y4 = model.inverse(params, z, cond)
        z4, ld4 = model.forward(params, y4[0], cond)
        assert (fused_affine_coupling.launches - before[0], fused_flow.launches - before[1]) == (6, 0)
        model.use_pallas_coupling = False
        y1 = model.inverse(params, z, cond)
        z1, ld1 = model.forward(params, y4[0], cond)
    torch.testing.assert_close(y4, y1, atol=1e-4, rtol=0)
    torch.testing.assert_close(z4, z1, atol=1e-4, rtol=0)
    torch.testing.assert_close(ld4, ld1, atol=1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("k,m,n,chunk", [(4096, 128, 256, 2048), (1001, 37, 75, 300)], ids=["tiled", "ragged"])
def test_atb_pass_matches_plain_version_on_card(cuda, k, m, n, chunk):
    """The tensor-core AᵀB pass alone (3xTF32): every chunk's partial product
    and column sums against float32 products on the card, within 1e-4 of the
    partial's largest value; the same inputs give the same bits twice (no
    atomics)."""
    from bcnf_tpu_torch.ops.atb import atb, atb_reference

    g = torch.Generator(device=cuda).manual_seed(13)
    a = torch.randn((k, m), generator=g, device=cuda)
    b = torch.randn((k, n), generator=g, device=cuda)
    before = atb.launches
    c, sums = atb(a, b, chunk)
    c2, sums2 = atb(a, b, chunk)
    c_r, sums_r = atb_reference(a, b, chunk)
    torch.cuda.synchronize()
    assert atb.launches == before + 2 and c.shape == (-(-k // chunk), m, n)
    assert torch.equal(c, c2) and torch.equal(sums, sums2)
    torch.testing.assert_close(c, c_r, atol=1e-4 * c_r.abs().max().item(), rtol=1e-4)
    torch.testing.assert_close(sums, sums_r, atol=1e-4 * sums_r.abs().max().item(), rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("hidden,batch,steps", [(140, 64, 12), (140, 70, 12), (32, 96, 8), (224, 45, 6)])
def test_lstm_backward_parts_match_plain_versions_on_card(cuda, reverse, hidden, batch, steps):
    """K3b's two parts, each alone: the cluster recurrence (dxp) and the
    dW_hh pass over its dxp, against the plain version; tiled and ragged
    batches (32 rows a cluster), per-gate widths 160, 32 and 224."""
    from bcnf_tpu_torch.ops.lstm_kernel import BWD_DW, BWD_RECURRENCE, _bwd_parts

    g = torch.Generator(device=cuda).manual_seed(14)
    xp = torch.randn((steps, batch, 4 * hidden), generator=g, device=cuda)
    w_hh = torch.randn((hidden, 4 * hidden), generator=g, device=cuda) / hidden**0.5
    hs, cs = lstm_direction_fwd_reference(xp, w_hh, reverse)
    dhs = torch.randn(hs.shape, generator=g, device=cuda)
    dxp_r, dw_r = lstm_direction_bwd_reference(xp, w_hh, hs, cs, dhs, reverse)
    dxp, dw = torch.full_like(xp, float("nan")), torch.full_like(w_hh, float("nan"))
    _bwd_parts(xp, w_hh, hs, cs, dhs, reverse, dxp, dw, BWD_RECURRENCE)
    torch.cuda.synchronize()
    assert torch.isnan(dw).all()
    torch.testing.assert_close(dxp, dxp_r, atol=1e-4, rtol=1e-4)
    _bwd_parts(xp, w_hh, hs, cs, dhs, reverse, dxp_r.clone(), dw, BWD_DW)
    torch.cuda.synchronize()
    torch.testing.assert_close(dw, dw_r, atol=1e-4 * dw_r.abs().max().item(), rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("hidden", [526, 700, 1000])  # 32-row tiles; 16-row tiles at the widest widths
@pytest.mark.parametrize("rows", [256, 259], ids=["tiled", "ragged"])
def test_train_backward_matches_plain_version_on_card(cuda, hidden, rows):
    """K2b (rows kernels on tensor cores, weight grads by the AᵀB pass)
    against its plain version, every grad at the JAX grad bar; its rows part
    alone gives the call's dx and dh_proj and writes no weight grad."""
    from bcnf_tpu_torch.ops.flow_kernel import (
        BWD_ROWS,
        _train_bwd_parts,
        fused_flow_train_backward_reference,
        fused_flow_train_bwd,
        fused_flow_train_reference,
    )

    stack = FeatureNetworkStack([ConcatenateCondition(None, 3), LSTMFeatureNetwork(3, 4, 8, 1)])
    model = CondRealNVP(size=19, nested_sizes=[hidden] * 3, n_blocks=3, n_conditions=8,
                        feature_network_stack=stack, act_norm=True, random_state=0)
    with torch.no_grad():
        x, h_proj, args = _train_args(model, model.init(device=cuda), B=rows, seed=15, device=cuda)
        z, ld, bound = fused_flow_train_reference(x, h_proj, *args)
        g = torch.Generator(device=cuda).manual_seed(16)
        dz, dld = torch.randn(z.shape, generator=g, device=cuda), torch.randn(ld.shape, generator=g, device=cuda)
        before = fused_flow_train_bwd.launches
        grads = fused_flow_train_bwd(bound, h_proj, dz, dld, *args)
        refs = fused_flow_train_backward_reference(bound, h_proj, dz, dld, *args)
        names = ("an_scale", "an_bias", "ortho", "w1y", "b1", "wm", "bm", "wout", "bout")
        rows_only = tuple(torch.full_like(t, float("nan")) for t in grads)
        _train_bwd_parts(bound, h_proj, dz, dld, dict(zip(names, args)), rows_only, BWD_ROWS)
        torch.cuda.synchronize()
    assert fused_flow_train_bwd.launches == before + 1
    for name, gk, r in zip(("x", "h_proj", "an_scale", "an_bias", "w1y", "b1", "wm", "bm", "wout", "bout"),
                           grads, refs):
        torch.testing.assert_close(gk, r, atol=min(5e-4, 1e-4 * r.abs().max().item()), rtol=1e-3, msg=name)
    assert torch.equal(rows_only[0], grads[0]) and torch.equal(rows_only[1], grads[1])
    assert all(torch.isnan(t).all() for t in rows_only[2:])


def _one_pass_bwd_case(cuda, hidden: int, nh: int, rows: int, seed: int) -> tuple:
    """K2b's inputs for a size-19 flow of 3 steps with `nh` hidden layers of
    width `hidden`: the step inputs from the plain one-pass forward, seeded
    standard-normal cotangents; and the plain one-pass version's grads."""
    from bcnf_tpu_torch.ops.flow_kernel import fused_flow_train_backward_reference, fused_flow_train_reference
    from bcnf_tpu_torch.ops.tf32 import matmul_tf32

    stack = FeatureNetworkStack([ConcatenateCondition(None, 3), LSTMFeatureNetwork(3, 4, 8, 1)])
    model = CondRealNVP(size=19, nested_sizes=[hidden] * (nh + 1), n_blocks=3, n_conditions=8,
                        feature_network_stack=stack, act_norm=True, random_state=0)
    with torch.no_grad():
        x, h_proj, args = _train_args(model, model.init(device=cuda), B=rows, seed=seed, device=cuda)
        z, _, bound = fused_flow_train_reference(x, h_proj, *args, mm=matmul_tf32)
        g = torch.Generator(device=cuda).manual_seed(seed + 1)
        dz, dld = torch.randn(z.shape, generator=g, device=cuda), torch.randn((rows,), generator=g, device=cuda)
        plain = fused_flow_train_backward_reference(bound, h_proj, dz, dld, *args, mm=matmul_tf32)
    return bound, h_proj, dz, dld, args, plain


def _worst(grads, plain) -> float:
    """The largest max |d| over the ten grads, each over max(1, max |plain|)."""
    return max((a - p).abs().max().item() / max(1.0, p.abs().max().item()) for a, p in zip(grads, plain))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [32, 33, 100, 4096, 4099])
@pytest.mark.parametrize("nh", [1, 4])
@pytest.mark.parametrize("hidden", [16, 100, 526])  # Hp 32, 128, 544
def test_one_pass_train_backward_on_wgmma_matches_plain_one_pass_on_card(cuda, monkeypatch, hidden, nh, rows):
    """K2b's one-pass `wgmma` route against the plain one-pass version: every
    grad within 5e-3 max(1, max |plain|) (JAX's reduced-mode bar), no further
    from it than twice the one-pass row tiles' own distance, two calls equal
    to the bit; counted once on its route."""
    from bcnf_tpu_torch.ops import flow_kernel as fk

    bound, h_proj, dz, dld, args, plain = _one_pass_bwd_case(cuda, hidden, nh, rows, seed=30)
    assert fk.train_bwd_route(h_proj.shape[-1], 19, 10, nh, fk.MODE_TF32) == fk.ROUTE_WGMMA_TF32
    before = fk.fused_flow_train_bwd.route_launches[fk.ROUTE_WGMMA_TF32]
    with torch.no_grad():
        first = fk.fused_flow_train_bwd(bound, h_proj, dz, dld, *args, mode=fk.MODE_TF32)
        second = fk.fused_flow_train_bwd(bound, h_proj, dz, dld, *args, mode=fk.MODE_TF32)
        monkeypatch.setattr(fk, "TRAIN_WGMMA_MAX_TN", 0)
        tiles = fk.fused_flow_train_bwd(bound, h_proj, dz, dld, *args, mode=fk.MODE_TF32)
        torch.cuda.synchronize()
    assert fk.fused_flow_train_bwd.route_launches[fk.ROUTE_WGMMA_TF32] == before + 2
    names = ("x", "h_proj", "an_scale", "an_bias", "w1y", "b1", "wm", "bm", "wout", "bout")
    for name, a, b, p in zip(names, first, second, plain):
        assert torch.equal(a, b), name
        torch.testing.assert_close(a, p, atol=5e-3 * max(1.0, p.abs().max().item()), rtol=0, msg=name)
    assert _worst(first, plain) <= 2 * _worst(tiles, plain)


def _three_pass_case(cuda, hidden: int, nh: int, rows: int, seed: int) -> tuple:
    """K2a's and K2b's inputs for a size-19 flow of 3 steps with `nh` hidden
    layers of width `hidden`, the step inputs from the plain 3xTF32 forward,
    seeded standard-normal cotangents; and the plain 3xTF32 versions' outputs
    (z, logdet, step inputs) and grads."""
    from bcnf_tpu_torch.ops.flow_kernel import fused_flow_train_backward_reference, fused_flow_train_reference
    from bcnf_tpu_torch.ops.tf32 import matmul_3xtf32

    stack = FeatureNetworkStack([ConcatenateCondition(None, 3), LSTMFeatureNetwork(3, 4, 8, 1)])
    model = CondRealNVP(size=19, nested_sizes=[hidden] * (nh + 1), n_blocks=3, n_conditions=8,
                        feature_network_stack=stack, act_norm=True, random_state=0)
    with torch.no_grad():
        x, h_proj, args = _train_args(model, model.init(device=cuda), B=rows, seed=seed, device=cuda)
        fwd = fused_flow_train_reference(x, h_proj, *args, mm=matmul_3xtf32)
        g = torch.Generator(device=cuda).manual_seed(seed + 1)
        dz, dld = torch.randn((rows, 19), generator=g, device=cuda), torch.randn((rows,), generator=g, device=cuda)
        bwd = fused_flow_train_backward_reference(fwd[2], h_proj, dz, dld, *args, mm=matmul_3xtf32)
    return x, h_proj, args, dz, dld, fwd, bwd


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [32, 33, 100, 4096, 4099])
@pytest.mark.parametrize("hidden,nh", [(16, 1), (16, 4), (100, 1), (100, 4), (526, 1), (526, 4), (526, 14)])
def test_3xtf32_training_kernels_on_wgmma_match_plain_3xtf32_on_card(cuda, hidden, nh, rows):
    """K2a and K2b in 3xTF32 on their `wgmma` routes (csrc/flow_fwd_wgmma.cu,
    csrc/flow_train_wgmma.cu) against the plain 3xTF32 versions
    (`mm=matmul_3xtf32`): z, logdet and the step inputs within 1e-4 (the JAX
    package's kernel bar), every grad at the JAX grad bar with its atol
    capped at 1e-4 of the grad's largest value; two calls of each equal to
    the bit; each counted twice on its route, on weights prepared in 3xTF32.
    Hp 32, 128, 544 with 1 and 4 hidden layers, and 14 at 544 (17 weight-grad
    jobs a step, past the row tiles' limit: the shape the `wgmma` route opens
    to training at float32)."""
    from bcnf_tpu_torch.ops import flow_kernel as fk

    x, h_proj, args, dz, dld, fwd, bwd = _three_pass_case(cuda, hidden, nh, rows, seed=40)
    Hp = h_proj.shape[-1]
    assert fk.flow_route(Hp, 19, 10, False, fk.MODE_3XTF32) == fk.ROUTE_FWD_WGMMA
    assert fk.train_bwd_route(Hp, 19, 10, nh, fk.MODE_3XTF32) == fk.ROUTE_WGMMA
    before = (fk.fused_flow_train_fwd.route_launches[fk.ROUTE_FWD_WGMMA],
              fk.fused_flow_train_bwd.route_launches[fk.ROUTE_WGMMA], fk.prepare_train_weights.pass_launches[3])
    with torch.no_grad():
        one, two = fk.fused_flow_train_fwd(x, h_proj, *args), fk.fused_flow_train_fwd(x, h_proj, *args)
        first = fk.fused_flow_train_bwd(fwd[2], h_proj, dz, dld, *args)
        second = fk.fused_flow_train_bwd(fwd[2], h_proj, dz, dld, *args)
        torch.cuda.synchronize()
    assert (fk.fused_flow_train_fwd.route_launches[fk.ROUTE_FWD_WGMMA],
            fk.fused_flow_train_bwd.route_launches[fk.ROUTE_WGMMA],
            fk.prepare_train_weights.pass_launches[3]) == (before[0] + 2, before[1] + 2, before[2] + 4)
    for name, a, b, p in zip(("z", "logdet", "bound"), one, two, fwd):
        assert torch.equal(a, b), name
        torch.testing.assert_close(a, p, atol=1e-4, rtol=0, msg=name)
    names = ("x", "h_proj", "an_scale", "an_bias", "w1y", "b1", "wm", "bm", "wout", "bout")
    for name, a, b, p in zip(names, first, second, bwd):
        assert torch.equal(a, b), name
        torch.testing.assert_close(a, p, atol=min(5e-4, 1e-4 * p.abs().max().item()), rtol=1e-3, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("hidden", [100, 526])
def test_3xtf32_training_step_prepares_the_weights_once_on_card(cuda, hidden):
    """`fused_flow_train` in 3xTF32 through autograd at Hp <= 544: K2a on the
    3xTF32 `wgmma` forward and K2b on the 3xTF32 `wgmma` route, once each,
    both on one preparation of the hi/lo weights (`prepare_train_weights`
    with 3 passes, counted once); the step's z and logdet equal to the bit
    to K2a's, and its grads to K2b's on the same weights prepared apart."""
    from bcnf_tpu_torch.ops import flow_kernel as fk

    x, h_proj, args, _, _, _, _ = _three_pass_case(cuda, hidden, 4, 259, seed=41)
    leaves = [t.clone().requires_grad_(True) for t in (x, h_proj, *args)]
    counters = (fk.fused_flow_train_fwd.route_launches, fk.fused_flow_train_bwd.route_launches,
                fk.prepare_train_weights.pass_launches)
    before = [dict(c) for c in counters]
    z, ld = fk.fused_flow_train(*leaves)
    grads = torch.autograd.grad((z.square().sum() - ld.sum()), leaves)
    torch.cuda.synchronize()
    moved = [{k: c[k] - b.get(k, 0) for k in c if c[k] != b.get(k, 0)} for c, b in zip(counters, before)]
    assert moved == [{fk.ROUTE_FWD_WGMMA: 1}, {fk.ROUTE_WGMMA: 1}, {3: 1}]
    with torch.no_grad():
        ws = fk.prepare_train_weights(args[5], passes=3)
        z2, ld2, bound = fk.fused_flow_train_fwd(x, h_proj, *args, wstages=ws)
        dx, dhp, *rest = fk.fused_flow_train_bwd(bound, h_proj, (2 * z2).contiguous(), -torch.ones_like(ld2), *args,
                                                 wstages=ws)
        torch.cuda.synchronize()
    assert torch.equal(z, z2) and torch.equal(ld, ld2)
    assert torch.equal(grads[0], dx) and torch.equal(grads[1], dhp)
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.gpu
def test_3xtf32_weight_preparation_on_card_is_its_plain_version(cuda):
    """`prepare_train_weights(wm, passes=3)` on the card (the 3xTF32 library's
    `prepare_kernel`) equals its plain version to the bit (hi in TF32 and lo
    = w - hi beside it, both directions, both ranks), and its hi part the
    one-pass layout."""
    from bcnf_tpu_torch.ops import flow_kernel as fk

    g = torch.Generator(device=cuda).manual_seed(42)
    for Hp in (32, 128, 544):
        wm = torch.randn((3, 2, Hp, Hp), generator=g, device=cuda)
        got = fk.prepare_train_weights(wm, passes=3)
        torch.cuda.synchronize()
        want = fk.prepare_train_weights_reference(wm.cpu(), passes=3)
        assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)), Hp
        assert torch.equal(got[:, :, :, :, :, 0], fk.prepare_train_weights(wm, passes=1)), Hp


@pytest.mark.gpu
def test_one_pass_train_backward_on_wgmma_parts_on_card(cuda):
    """The `parts` mask on the `wgmma` route: the rows kernels alone give the
    call's dx and dh_proj and write no weight grad; the weight-grad passes
    alone write dWm and dbm only, the rest alone the other weight grads and
    the ActNorm's only (each part alone, so they can be timed one by one);
    the weights prepared on the card are the plain version's to the bit,
    one counted launch."""
    from bcnf_tpu_torch.ops.flow_kernel import (
        BWD_ACTNORM, BWD_ROWS, BWD_WEIGHT_GRADS, MODE_TF32, ROUTE_WGMMA_TF32, _train_bwd_parts, fused_flow_train_bwd,
        prepare_train_weights, prepare_train_weights_reference,
    )

    bound, h_proj, dz, dld, args, _ = _one_pass_bwd_case(cuda, 526, 4, 259, seed=31)
    names = ("an_scale", "an_bias", "ortho", "w1y", "b1", "wm", "bm", "wout", "bout")
    with torch.no_grad():
        grads = fused_flow_train_bwd(bound, h_proj, dz, dld, *args, mode=MODE_TF32)
        parted = tuple(torch.full_like(t, float("nan")) for t in grads)
        before = prepare_train_weights.launches
        wstages = prepare_train_weights(args[5])
        torch.cuda.synchronize()
        assert prepare_train_weights.launches == before + 1
        assert torch.equal(wstages.cpu().view(torch.int32), prepare_train_weights_reference(args[5].cpu()).view(torch.int32))
        route = _train_bwd_parts(bound, h_proj, dz, dld, dict(zip(names, args)), parted, BWD_ROWS, MODE_TF32, wstages)
        torch.cuda.synchronize()
        assert route == ROUTE_WGMMA_TF32
        assert torch.equal(parted[0], grads[0]) and torch.equal(parted[1], grads[1])
        assert all(torch.isnan(t).all() for t in parted[2:])
        for part, written in ((BWD_WEIGHT_GRADS, (6, 7)), (BWD_ACTNORM, (2, 3, 4, 5, 8, 9))):
            alone = tuple(torch.full_like(t, float("nan")) for t in grads)
            _train_bwd_parts(bound, h_proj, dz, dld, dict(zip(names, args)), alone, part, MODE_TF32, wstages)
            torch.cuda.synchronize()
            assert all(torch.isnan(t).all() for i, t in enumerate(alone) if i not in written), part
            assert not any(torch.isnan(alone[i]).all() for i in written), part


@pytest.mark.gpu
@pytest.mark.parametrize("hidden,mode,forced,route", [
    (526, "tf32", False, "wgmma_tf32"), (526, "tf32", True, "rows_tf32"), (526, "3xtf32", False, "wgmma"),
    (700, "tf32", False, "rows_tf32"), (526, "3xtf32", True, "rows"), (700, "3xtf32", False, "rows"),
], ids=["one_pass_544", "one_pass_544_forced_tiles", "3xtf32_544", "one_pass_768", "3xtf32_544_forced_tiles",
        "3xtf32_768"])
def test_training_step_counts_the_train_backward_route_on_card(cuda, monkeypatch, hidden, mode, forced, route):
    """`fused_flow_train` through autograd runs K2b on the route of its mode
    and width, counted once in `route_launches`: each tensor-core mode on its
    `wgmma` build at Hp 544 (on its row tiles when `TRAIN_WGMMA_MAX_TN` is 0,
    and at Hp 768)."""
    from bcnf_tpu_torch.ops import flow_kernel as fk

    if forced:
        monkeypatch.setattr(fk, "TRAIN_WGMMA_MAX_TN", 0)
    stack = FeatureNetworkStack([ConcatenateCondition(None, 3), LSTMFeatureNetwork(3, 4, 8, 1)])
    model = CondRealNVP(size=19, nested_sizes=[hidden] * 3, n_blocks=3, n_conditions=8,
                        feature_network_stack=stack, act_norm=True, random_state=0)
    with torch.no_grad():
        x, h_proj, args = _train_args(model, model.init(device=cuda), B=64, seed=32, device=cuda)
    leaves = [t.clone().requires_grad_(True) for t in (x, h_proj, *args)]
    before = dict(fk.fused_flow_train_bwd.route_launches)
    z, ld = fk.fused_flow_train(*leaves, mode=mode)
    grads = torch.autograd.grad((z.square().sum() - ld.sum()), leaves)
    torch.cuda.synchronize()
    after = fk.fused_flow_train_bwd.route_launches
    assert {r: after[r] - before.get(r, 0) for r in after if after[r] != before.get(r, 0)} == {route: 1}
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.gpu
def test_resimulation_on_card_matches_cpu(cuda):
    from bcnf_tpu_torch.config import ParameterIndexMapping
    from bcnf_tpu_torch.simulation.resimulation import resimulate

    class _Mapped:
        parameter_index_mapping = ParameterIndexMapping(["x0_x", "x0_y", "x0_z", "v0_x", "v0_y", "v0_z", "g",
                                                         "w_x", "w_y", "w_z", "b", "m", "r"])

    rng = np.random.default_rng(20)
    M, N = 64, 64
    base = np.array([0, 0, 1.5, 8, 2, 7, 9.81, 1, -1, 0.3, 0.02, 0.3, 0.1], np.float32)
    y_hat = (base * (1 + 0.3 * rng.normal(size=(M, N, 13)))).astype(np.float32)
    data = {"rho": rng.gamma(3.5, 0.35, size=N).astype(np.float32)}
    on_card = resimulate(_Mapped(), None, 2.0, 0.067, data, y_hat, device=cuda)
    on_cpu = resimulate(_Mapped(), None, 2.0, 0.067, data, y_hat, device="cpu")
    assert on_card.shape == on_cpu.shape == (N, M, 30, 3)
    fin = np.isfinite(on_cpu).all(axis=(2, 3))
    np.testing.assert_array_equal(np.isfinite(on_card).all(axis=(2, 3)), fin)
    scale = 1.0 + np.abs(on_cpu[fin]).max(axis=(1, 2))
    assert (np.abs(on_card[fin] - on_cpu[fin]).max(axis=(1, 2)) <= 1e-5 * scale).all()


@pytest.mark.gpu
def test_rank_batch_through_k1_matches_plain_version_on_card(cuda):
    from bcnf_tpu_torch.eval.calibration import compute_y_hat_ranks

    model = _tiny_model()
    params = model.init(device=cuda)
    rng = np.random.default_rng(21)
    N, M = 30, 500
    cond = torch.from_numpy(rng.normal(size=(N, 9, 3)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.normal(size=(N, 5)).astype(np.float32)).to(cuda)
    draws = {}
    for use_kernel in (True, False):
        model.use_pallas = use_kernel
        before = fused_flow.launches
        with torch.no_grad():
            draws[use_kernel] = model.sample(params, torch.Generator(device=cuda).manual_seed(3), M, cond, device=cuda)
        assert fused_flow.launches == before + use_kernel
    model.use_pallas = True
    # one rank batch (30 conditions x 500 draws) through K1, on the same z as draws[True]
    before = fused_flow.launches
    k_ranks = compute_y_hat_ranks(model, params, y, cond, M_samples=M,
                                  generator=torch.Generator(device=cuda).manual_seed(3), device=cuda)
    assert fused_flow.launches == before + 1
    assert np.array_equal(k_ranks, (draws[True] < y[None]).sum(dim=0).cpu().numpy())
    plain_ranks = (draws[False] < y[None]).sum(dim=0).cpu().numpy()
    ties = ((draws[False] - y[None]).abs() < 1e-4).sum(dim=0).cpu().numpy()
    assert (np.abs(k_ranks - plain_ranks) <= ties).all()


@pytest.mark.gpu
def test_impact_loop_graph_replays_match_the_eager_loop_on_card(cuda, monkeypatch):
    from bcnf_tpu_torch.simulation import physics

    rng = np.random.default_rng(22)
    n = 100
    x0 = torch.from_numpy(np.c_[rng.normal(0, 5, (n, 2)), rng.uniform(0.1, 2.5, n)].astype(np.float32))
    v0 = torch.from_numpy(np.c_[rng.normal(0, 8, (n, 2)), rng.normal(7, 5, n)].astype(np.float32))
    g = torch.tensor([0.0, 0.0, -9.81]).expand(n, 3)
    w = torch.from_numpy(rng.normal(0, 2, (n, 3)).astype(np.float32))
    b, m = torch.full((n,), 0.05), torch.from_numpy(rng.uniform(0.05, 0.5, n).astype(np.float32))
    rho, r, a = torch.full((n,), 1.2), torch.full((n,), 0.1), torch.zeros(n, 3)
    args = [t.to(cuda) for t in (x0, v0, g, w, b, m, rho, r, a)]
    graphed = physics.point_of_impact(*args, dt=1 / 30, max_steps=700)
    cpu = physics.point_of_impact(x0, v0, g, w, b, m, rho, r, a, dt=1 / 30, max_steps=700)
    monkeypatch.setattr(physics, "IMPACT_CHECK_EVERY", 10**9)  # one eager run of every step
    eager = physics.point_of_impact(*args, dt=1 / 30, max_steps=700)
    assert torch.equal(graphed, eager)
    torch.testing.assert_close(graphed.cpu(), cpu, atol=1e-4, rtol=1e-5)


# ---------------------------------------------------------------------------
# the model zoo on the card: the Transformer encoder and the spline against
# the CPU, and K1's gate on the couplings it does and does not cover
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_transformer_encoder_on_card_matches_cpu(cuda):
    """t_PTRF_small's encoder widths (46 wide, 4 heads, positional
    embeddings) on the card against the CPU, float32 products both sides."""
    from bcnf_tpu_torch.models import Transformer

    net = Transformer(input_size=3, trf_size=46, n_heads=4, ff_size=46, n_blocks=3, output_size=128,
                      add_positional_embeddings=True)
    params = net.init(torch.Generator().manual_seed(30))
    x = torch.from_numpy(np.random.default_rng(31).normal(size=(64, 30, 3)).astype(np.float32))
    with torch.no_grad():
        on_cpu = net.apply(params, x)
        on_card = net.apply(map_tree(lambda t: t.to(cuda), params), x.to(cuda))
    torch.testing.assert_close(on_card.cpu(), on_cpu, atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_spline_on_card_matches_cpu(cuda, inverse):
    """The spline both ways on the card against the CPU, inside and outside
    the tails: outputs at 1e-4, logdets at 2e-3 (the spline's bar)."""
    from bcnf_tpu_torch.models.splines import rational_quadratic_spline

    rng = np.random.default_rng(32)
    x = torch.from_numpy((rng.normal(size=(4096, 9)) * 2.4).astype(np.float32))
    raw = torch.from_numpy(rng.normal(size=(4096, 9, 23)).astype(np.float32))
    args = (x, raw[..., :8], raw[..., 8:16], raw[..., 16:])
    y_cpu, ld_cpu = rational_quadratic_spline(*args, inverse=inverse)
    y_card, ld_card = rational_quadratic_spline(*(a.to(cuda) for a in args), inverse=inverse)
    torch.testing.assert_close(y_card.cpu(), y_cpu, atol=1e-4, rtol=0)
    torch.testing.assert_close(ld_card.cpu(), ld_cpu, atol=2e-3, rtol=0)
    assert torch.equal(y_card.cpu()[x.abs() > 3], x[x.abs() > 3])


@pytest.mark.gpu
@pytest.mark.parametrize("opts,launches", [
    ({}, 1),
    ({"two_way": True}, 0),
    ({"layer": "AnyGLU", "layer_kwargs": {"activation": "Sigmoid"}}, 0),
    ({"layer": "LinearFFTEnriched"}, 0),
    ({"coupling": "rqs"}, 0),
], ids=["linear", "two-way", "anyglu", "fft", "rqs"])
def test_k1_launches_only_for_couplings_it_covers(cuda, opts, launches):
    """Sampling launches K1 once for a one-way Linear GELU flow and never for
    the others, which take the plain composition; samples finite."""
    from bcnf_tpu_torch.models import Transformer

    stack = FeatureNetworkStack([ConcatenateCondition(None, 3),
                                 Transformer(input_size=3, trf_size=16, n_heads=4, ff_size=16, n_blocks=1,
                                             output_size=8, add_positional_embeddings=True)])
    model = CondRealNVP(size=5, nested_sizes=[16, 16], n_blocks=3, n_conditions=8, feature_network_stack=stack,
                        act_norm=True, random_state=0, **opts)
    params = model.init(device=cuda)
    cond = torch.from_numpy(np.random.default_rng(33).normal(size=(4, 9, 3)).astype(np.float32))
    before = fused_flow.launches
    with torch.no_grad():
        out = model.sample(params, torch.Generator().manual_seed(4), 50, cond, device=cuda)
    torch.cuda.synchronize()
    assert fused_flow.launches == before + launches
    assert out.shape == (50, 4, 5) and torch.isfinite(out).all()


@pytest.mark.gpu
def test_video_cnn_on_card_matches_cpu(cuda):
    """The published video CNN (`videos_CNN_LSTM_large`: 1->8->16->32,
    kernels 8/5/3, head 16128 -> 1000) on the card against the CPU, float32
    both sides (TF32 off): features at 1e-4; weight grads at the JAX grad
    bar (atol 5e-4, rtol 1e-3) at the card's ReLU and max-pool decisions,
    which float32 rounding may take otherwise at a near-tie
    (`chip_smoke.cnn_at_decisions`)."""
    from bcnf_tpu_torch.bridge import tree_leaves
    from bcnf_tpu_torch.models import CNN
    from chip_smoke import cnn_at_decisions

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net = CNN(hidden_channels=[8, 16, 32], kernel_sizes=[8, 5, 3], strides=[1, 1, 1], output_size_lin=1000,
              output_size=1000, image_input_size=(90, 160), dropout_prob=0.5)
    params = net.init(torch.Generator().manual_seed(40))
    x = torch.from_numpy(np.random.default_rng(41).uniform(size=(2, 2, 5, 90, 160)).astype(np.float32))
    ct = torch.from_numpy(np.random.default_rng(42).normal(size=(2, 5, 1000)).astype(np.float32))
    card = map_tree(lambda t: t.to(cuda), params)
    with torch.no_grad():
        torch.testing.assert_close(net.apply(card, x.to(cuda)).cpu(), net.apply(params, x), atol=1e-4, rtol=0)
        _, decisions = cnn_at_decisions(net, card, x.to(cuda))
    grads = {}
    for dev in (torch.device("cpu"), cuda):
        p = map_tree(lambda t: t.detach().to(dev).requires_grad_(True), params)
        (cnn_at_decisions(net, p, x.to(dev), decisions)[0] * ct.to(dev)).sum().backward()
        grads[dev.type] = [t.grad.cpu() for t in tree_leaves(p)]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, atol=5e-4, rtol=1e-3)


@pytest.mark.gpu
def test_online_video_step_on_card(cuda):
    """The online simulator on the card assembles the CPU's batch from the
    same draws (y exactly, trajectories and frames within 1e-4), and online
    video training takes steps on the card with finite losses."""
    import os

    from bcnf_tpu_torch.bridge import tree_leaves
    from bcnf_tpu_torch.config import ParameterIndexMapping, load_yaml
    from bcnf_tpu_torch.models import CNN
    from bcnf_tpu_torch.train.online import OnlineSimulator, train_online

    prior = load_yaml(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                                   "data_prior.yaml"))
    names = ["x0_x", "x0_y", "x0_z", "v0_x", "v0_y", "v0_z", "g", "w_x", "w_y", "w_z", "b", "m", "a_x", "a_y",
             "a_z", "r", "A", "Cd", "rho"]
    sim = OnlineSimulator(prior, ParameterIndexMapping(names), condition_groups=[
        ["videos"], ["cam_radian", "cam_radius", "cam_angles", "cam_heights"]], dt=0.1, T=0.5, ratio=(3, 2))
    draws = sim.draw(torch.Generator().manual_seed(43), 8)
    y_cpu, c_cpu = sim.assemble(draws, 8)
    y_card, c_card = sim.assemble(map_tree(lambda t: t.to(cuda), draws), 8)
    assert torch.equal(y_card.cpu(), y_cpu)
    for a, b in zip(c_card, c_cpu):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=0)
    stack = FeatureNetworkStack([
        ConcatenateCondition(input_size=None, output_size=(20, 30)),
        CNN(hidden_channels=[4, 8], kernel_sizes=[3, 3], strides=[1, 1], output_size_lin=16, output_size=16,
            image_input_size=(20, 30), dropout_prob=0.5),
        LSTMFeatureNetwork(input_size=16, hidden_size=8, output_size=24, num_layers=1),
        ConcatenateCondition(input_size=24, output_size=31, dim=-1),
    ])
    model = CondRealNVP(size=19, nested_sizes=[16, 16], n_blocks=3, n_conditions=31, feature_network_stack=stack,
                        act_norm=True, random_state=0, dropout=0.1)
    trained, history = train_online(model, model.init(device=cuda), sim, n_steps=3, batch_size=8, eval_every=3,
                                    eval_batches=1, device=cuda)
    assert all(t.is_cuda and torch.isfinite(t).all() for t in tree_leaves(trained))
    assert np.isfinite(history["train_loss"][-1][1]) and np.isfinite(history["eval_nll"][-1][1])

