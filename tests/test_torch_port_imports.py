"""The port's import boundary and device rule (bcnf_tpu_torch).

This file imports nothing of JAX, so its `gpu` tests also run on a machine
with a card and no JAX: `python -m pytest tests/test_torch_port_imports.py
-m gpu --noconftest` (the repo's conftest configures JAX)."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from bcnf_tpu_torch.models import CondRealNVP, ConcatenateCondition, FeatureNetworkStack, LSTMFeatureNetwork
from bcnf_tpu_torch.ops.flow_kernel import fused_flow, fused_flow_reference, padded_width
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
        "need = ['__main__', 'ops.flow_kernel', 'train.trainer', 'train.optim', 'train.checkpoint', 'train.history']\n"
        "assert all('bcnf_tpu_torch.' + n in names for n in need), names\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "bad = [m for m in sys.modules if m == 'bcnf_tpu' or m.startswith('bcnf_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
@pytest.mark.parametrize("hidden", [16, 100, 526, 1000])  # 64-row and 32-row tiles
def test_kernel_matches_reference_on_card(cuda, inverse, hidden):
    """A CUDA tensor launches the kernel (counted), ragged rows included."""
    model = _tiny_model(hidden)
    params = model.init(device=cuda)
    rng = np.random.default_rng(3)
    traj = torch.from_numpy(rng.normal(size=(6, 9, 3)).astype(np.float32)).to(cuda)
    kargs, h_proj = model._fused_flow_args(params, model.encode(params, (traj,)))
    x = torch.from_numpy(rng.normal(size=(6 * 37 + 5, 5)).astype(np.float32)).to(cuda)
    before = fused_flow.launches
    out = fused_flow(x, h_proj, **kargs, inverse=inverse, n_cond=6)
    ref = fused_flow_reference(x, h_proj, **kargs, inverse=inverse, n_cond=6)
    torch.cuda.synchronize()
    assert fused_flow.launches == before + 1
    for a, b in zip(out if not inverse else (out,), ref if not inverse else (ref,)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


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
@pytest.mark.parametrize("rows,launched", [(256, 1), (255, 0)])
def test_training_forward_on_card_takes_the_kernels_from_the_batch_floor(cuda, rows, launched):
    """Under autograd a CUDA batch of >= 256 rows goes through K2a/K2b; one
    row fewer takes the plain path; both give the CPU's loss and grads."""
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
