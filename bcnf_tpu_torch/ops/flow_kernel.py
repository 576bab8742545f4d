"""The whole RealNVP flow in one CUDA kernel: host side.

Replaces `bcnf_tpu/ops/flow_kernel.py::fused_flow` (the Pallas TPU kernel
`_flow_kernel`). The kernel itself is `csrc/flow_kernel.cu`; this module
stacks and pads its arguments, checks them, launches it on PyTorch's current
stream, and holds its plain PyTorch version, `fused_flow_reference`, which
the CPU tests use and `chip_smoke.py` holds the kernel against on the card.

Layout contract (the same as the JAX kernel's): rows are draws-major, row
``r`` uses the condition projection ``h_proj[step, r % n_cond]``; step ``K``
(the last of ``K+1``) is the final coupling, whose ActNorm and orthonormal
slots are identity and are skipped exactly. Unlike the TPU kernel there is no
tiling rule on ``B`` or ``n_cond``: the kernel masks the ragged last tile.
"""

from __future__ import annotations

import ctypes
from typing import Any

import torch
import torch.nn.functional as F

from bcnf_tpu_torch.ops.nn import gelu

# Each thread of the kernel owns `TN` columns of the padded hidden width
# (32 * TN); these are the widths it is compiled for (`csrc/flow_kernel.cu`).
KERNEL_TN = (1, 2, 4, 8, 12, 16, 17, 24, 32)


def padded_width(H: int) -> int:
    """The hidden width the kernel runs at: the smallest compiled 32*TN >= H."""
    for tn in KERNEL_TN:
        if 32 * tn >= H:
            return 32 * tn
    raise ValueError(f"hidden width {H} exceeds the kernel's largest width {32 * KERNEL_TN[-1]}")


def stack_flow_params(model: Any, params: dict) -> dict:
    """Stacked per-step kernel arguments from a `CondRealNVP` param tree
    (`bcnf_tpu/ops/flow_kernel.py:290-323`). Entry K is the final coupling;
    its ActNorm and orthonormal slots are identity."""
    size = model.size
    d_a = model.coupling.d_a
    blocks = params["blocks"]
    cp = blocks["coupling"]["a"]["layers"]  # leaves (K, ...)
    fin = params["final"]["a"]["layers"]

    def cat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.cat([a, b[None]], dim=0)

    K = cp[0]["w"].shape[0]
    w1 = cat(cp[0]["w"], fin[0]["w"])
    ones = cp[0]["w"].new_ones((size,))
    zeros = cp[0]["w"].new_zeros((size,))
    if model.actnorm is not None:
        an_s = cat(blocks["actnorm"]["scale"], ones)
        an_b = cat(blocks["actnorm"]["bias"], zeros)
    else:
        an_s = ones.expand(K + 1, size)
        an_b = zeros.expand(K + 1, size)
    return {
        "an_scale": an_s,
        "an_bias": an_b,
        "ortho": cat(blocks["ortho"], torch.eye(size, dtype=w1.dtype, device=w1.device)),
        "w1y": w1[:, :d_a, :],
        "b1": cat(cp[0]["b"], fin[0]["b"]),
        "wm": torch.stack([cat(cp[i]["w"], fin[i]["w"]) for i in range(1, len(cp) - 1)], dim=1),
        "bm": torch.stack([cat(cp[i]["b"], fin[i]["b"]) for i in range(1, len(cp) - 1)], dim=1),
        "wout": cat(cp[-1]["w"], fin[-1]["w"]),
        "bout": cat(cp[-1]["b"], fin[-1]["b"]),
    }


def pad_hidden(kargs: dict, h_proj: torch.Tensor) -> tuple[dict, torch.Tensor]:
    """Zero-pad the hidden width H to `padded_width(H)` (`pad_hidden`,
    `bcnf_tpu/ops/flow_kernel.py:326-342`). The same function exactly: padded
    units see zero weights, zero bias and a zero projection, gelu(0) = 0, and
    their zero rows of the next weight add nothing downstream."""
    H = kargs["b1"].shape[-1]
    p = padded_width(H) - H
    out = {k: v.contiguous() for k, v in kargs.items()}
    if p:
        out["w1y"] = F.pad(kargs["w1y"], (0, p))
        out["b1"] = F.pad(kargs["b1"], (0, p))
        out["wm"] = F.pad(kargs["wm"], (0, p, 0, p))
        out["bm"] = F.pad(kargs["bm"], (0, p))
        out["wout"] = F.pad(kargs["wout"], (0, 0, 0, p))
        h_proj = F.pad(h_proj, (0, p))
    return out, h_proj.contiguous()


def fused_flow_reference(
    x: torch.Tensor,
    h_proj: torch.Tensor,
    an_scale: torch.Tensor,
    an_bias: torch.Tensor,
    ortho: torch.Tensor,
    w1y: torch.Tensor,
    b1: torch.Tensor,
    wm: torch.Tensor,
    bm: torch.Tensor,
    wout: torch.Tensor,
    bout: torch.Tensor,
    *,
    inverse: bool,
    n_cond: int,
) -> tuple[torch.Tensor, torch.Tensor] | torch.Tensor:
    """Plain PyTorch version of the kernel: the same steps, one op at a time.
    Forward returns `(z, logdet)`, inverse returns `y`."""
    B, size = x.shape
    n_steps = h_proj.shape[0]
    d_a = w1y.shape[1]
    rows = torch.arange(B, device=x.device) % n_cond

    def coeffs(k: int, x_a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        a = gelu(x_a @ w1y[k] + b1[k] + h_proj[k].index_select(0, rows))
        for i in range(wm.shape[1]):
            a = gelu(a @ wm[k, i] + bm[k, i])
        out = a @ wout[k] + bout[k]
        return out[:, : size - d_a], torch.tanh(out[:, size - d_a:])

    if not inverse:
        ld = x.new_zeros((B,))
        for k in range(n_steps):
            inner = k < n_steps - 1
            if inner:
                x = x * an_scale[k] + an_bias[k]
                ld = ld + torch.sum(torch.log(torch.abs(an_scale[k])))
            t, s = coeffs(k, x[:, :d_a])
            x = torch.cat([x[:, :d_a], torch.exp(s) * x[:, d_a:] + t], dim=-1)
            ld = ld + torch.sum(s, dim=-1)
            if inner:
                x = x @ ortho[k]
        return x, ld

    for k in range(n_steps - 1, -1, -1):
        inner = k < n_steps - 1
        if inner:
            x = x @ ortho[k].T
        t, s = coeffs(k, x[:, :d_a])
        x = torch.cat([x[:, :d_a], (x[:, d_a:] - t) * torch.exp(-s)], dim=-1)
        if inner:
            x = (x - an_bias[k]) / an_scale[k]
    return x


def _check_args(x: torch.Tensor, args: dict[str, torch.Tensor], n_cond: int) -> None:
    for name, t in {"x": x, **args}.items():
        if t.dtype != torch.float32:
            raise TypeError(f"fused_flow: {name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"fused_flow: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_flow: {name} must be contiguous")
    B, size = x.shape
    S, N, Hp = args["h_proj"].shape
    nh, d_a = args["wm"].shape[1], args["w1y"].shape[1]
    expected = {
        "h_proj": (S, n_cond, Hp),
        "an_scale": (S, size),
        "an_bias": (S, size),
        "ortho": (S, size, size),
        "w1y": (S, d_a, Hp),
        "b1": (S, Hp),
        "wm": (S, nh, Hp, Hp),
        "bm": (S, nh, Hp),
        "wout": (S, Hp, 2 * (size - d_a)),
        "bout": (S, 2 * (size - d_a)),
    }
    for name, shape in expected.items():
        if tuple(args[name].shape) != shape:
            raise ValueError(f"fused_flow: {name} has shape {tuple(args[name].shape)}, expected {shape}")
    if Hp % 32 or Hp // 32 not in KERNEL_TN:
        raise ValueError(f"fused_flow: hidden width {Hp} is not one the kernel is built for; pad with pad_hidden")
    if not 0 < d_a < size or n_cond < 1:
        raise ValueError(f"fused_flow: bad split d_a={d_a} of size={size} or n_cond={n_cond}")
    if B * size >= 2**31:
        raise ValueError(f"fused_flow: {B} rows exceed the kernel's 32-bit row indexing")


def fused_flow(
    x: torch.Tensor,
    h_proj: torch.Tensor,
    an_scale: torch.Tensor,
    an_bias: torch.Tensor,
    ortho: torch.Tensor,
    w1y: torch.Tensor,
    b1: torch.Tensor,
    wm: torch.Tensor,
    bm: torch.Tensor,
    wout: torch.Tensor,
    bout: torch.Tensor,
    *,
    inverse: bool,
    n_cond: int,
) -> tuple[torch.Tensor, torch.Tensor] | torch.Tensor:
    """Run the whole flow in one kernel launch. Forward returns `(z, logdet)`,
    inverse returns `y`. A CPU tensor takes `fused_flow_reference`; a CUDA
    tensor launches the kernel (or raises)."""
    args = dict(h_proj=h_proj, an_scale=an_scale, an_bias=an_bias, ortho=ortho,
                w1y=w1y, b1=b1, wm=wm, bm=bm, wout=wout, bout=bout)
    if x.device.type == "cpu":
        return fused_flow_reference(x, **args, inverse=inverse, n_cond=n_cond)
    if x.device.type != "cuda":
        raise ValueError(f"fused_flow runs on CPU or CUDA tensors, not {x.device}")
    _check_args(x, args, n_cond)

    from bcnf_tpu_torch.ops._build import load_library

    lib = load_library()
    B, size = x.shape
    S, _, Hp = h_proj.shape
    y = torch.empty_like(x)
    ld = None if inverse else torch.empty((B,), dtype=x.dtype, device=x.device)
    if B == 0:
        return y if inverse else (y, ld)
    ptr = ctypes.c_void_p
    with torch.cuda.device(x.device):
        err = lib.bcnf_fused_flow(
            ptr(x.data_ptr()), ptr(h_proj.data_ptr()), ptr(an_scale.data_ptr()),
            ptr(an_bias.data_ptr()), ptr(ortho.data_ptr()), ptr(w1y.data_ptr()),
            ptr(b1.data_ptr()), ptr(wm.data_ptr()), ptr(bm.data_ptr()),
            ptr(wout.data_ptr()), ptr(bout.data_ptr()),
            ptr(y.data_ptr()), ptr(0 if ld is None else ld.data_ptr()),
            B, n_cond, S, size, w1y.shape[1], wm.shape[1], Hp, int(inverse),
            ptr(torch.cuda.current_stream().cuda_stream),
        )
    if err != 0:
        raise RuntimeError(f"fused_flow kernel launch failed: {lib.bcnf_cuda_error_string(err).decode()}")
    fused_flow.launches += 1
    return y if inverse else (y, ld)


fused_flow.launches = 0  # type: ignore[attr-defined]
