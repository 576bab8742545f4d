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
        "assert 'bcnf_tpu_torch.__main__' in names and 'bcnf_tpu_torch.ops.flow_kernel' in names, names\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "bad = [m for m in sys.modules if m == 'bcnf_tpu' or m.startswith('bcnf_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


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


@pytest.mark.gpu
def test_sample_on_card_matches_cpu(cuda):
    model = _tiny_model()
    cond = torch.randn((4, 9, 3), generator=torch.Generator().manual_seed(5))
    before = fused_flow.launches
    on_card = model.sample(model.init(device=cuda), torch.Generator().manual_seed(6), 50, cond, device=cuda)
    assert fused_flow.launches == before + 1
    on_cpu = model.sample(model.init(device="cpu"), torch.Generator().manual_seed(6), 50, cond, device="cpu")
    torch.testing.assert_close(on_card.cpu(), on_cpu, atol=1e-4, rtol=0)
