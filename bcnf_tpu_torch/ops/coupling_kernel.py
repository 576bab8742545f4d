"""One affine coupling in a CUDA kernel: host side.

K4, `fused_affine_coupling`, replaces
`bcnf_tpu/ops/coupling_kernel.py::fused_affine_coupling` (the Pallas TPU
kernel `_coupling_kernel`); the kernel is `csrc/coupling_kernel.cu`. It runs
one coupling's nested MLP on `x_a` plus the hoisted condition projection,
then ``exp(tanh s) * x_b + t`` with the row log-det, or the inverse. The JAX
package reaches it only when a model sets `use_pallas_coupling`
(`bcnf_tpu/models/cnf.py:555-558, 762-764`); so does the port.

Row ``r`` is conditioned on ``h_proj[r % n_cond]``, as K1 does, so a
`(n_samples, N, size)` inverse needs no broadcast copy of the projections.
Unlike the TPU kernel there is no tiling rule: the kernel masks the ragged
last tile. The wrapper zero-pads the hidden width to the kernel's
(`ops/flow_kernel.padded_width`); `fused_affine_coupling_reference` is the
plain version, which serves CPU tensors (the tests) and which `chip_smoke.py`
holds the kernel against on the card.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from bcnf_tpu_torch.ops.flow_kernel import _ptrs, _raise_on, padded_width
from bcnf_tpu_torch.ops.nn import gelu


def mlp_params_to_kernel_args(mlp_params: dict, in_dim: int) -> dict:
    """Split a `NestedMLP` param tree (Linear family) into the kernel's
    arguments (`bcnf_tpu/ops/coupling_kernel.py:145-160`). The first layer's
    weight rows past `in_dim` belong to the condition and go into the
    hoisted projection (`NestedMLP.cond_proj`)."""
    layers = mlp_params["layers"]
    return {
        "w1y": layers[0]["w"][:in_dim],
        "b1": layers[0]["b"],
        "wm": [p["w"] for p in layers[1:-1]],
        "bm": [p["b"] for p in layers[1:-1]],
        "wout": layers[-1]["w"],
        "bout": layers[-1]["b"],
    }


def fused_affine_coupling_reference(
    x_a: torch.Tensor,
    x_b: torch.Tensor,
    h_proj: torch.Tensor,
    w1y: torch.Tensor,
    b1: torch.Tensor,
    wm: Sequence[torch.Tensor],
    bm: Sequence[torch.Tensor],
    wout: torch.Tensor,
    bout: torch.Tensor,
    *,
    inverse: bool,
    n_cond: int,
) -> tuple[torch.Tensor, torch.Tensor] | torch.Tensor:
    """Plain PyTorch version of K4 (`_coupling_kernel`,
    `bcnf_tpu/ops/coupling_kernel.py:34-65`): `(z_b, logdet)` forward, `y_b`
    inverse."""
    d_b = x_b.shape[1]
    rows = torch.arange(x_a.shape[0], device=x_a.device) % n_cond
    a = gelu(x_a @ w1y + b1 + h_proj.index_select(0, rows))
    for w, b in zip(wm, bm):
        a = gelu(a @ w + b)
    out = a @ wout + bout
    t, s = out[:, :d_b], torch.tanh(out[:, d_b:])
    if inverse:
        return (x_b - t) * torch.exp(-s)
    return torch.exp(s) * x_b + t, torch.sum(s, dim=-1)


def _check_args(tensors: dict[str, torch.Tensor], n_cond: int) -> None:
    """Type, device, shape and contiguity of the kernel's arguments, the
    hidden layers' named ``wm[i]``, ``bm[i]``; raises on what it does not take."""
    x_a, x_b, H = tensors["x_a"], tensors["x_b"], tensors["w1y"].shape[-1]
    if x_a.dim() != 2 or x_b.dim() != 2 or n_cond < 1:
        raise ValueError(f"fused_affine_coupling: x_a {tuple(x_a.shape)} and x_b {tuple(x_b.shape)} must be "
                         f"(rows, d), n_cond={n_cond} positive")
    (B, d_a), d_b = x_a.shape, x_b.shape[1]
    expected = {"x_a": (B, d_a), "x_b": (B, d_b), "h_proj": (n_cond, H), "w1y": (d_a, H), "b1": (H,),
                "wout": (H, 2 * d_b), "bout": (2 * d_b,)}
    for name, t in tensors.items():
        shape = expected.get(name, (H, H) if name.startswith("wm") else (H,))
        if t.dtype != torch.float32:
            raise TypeError(f"fused_affine_coupling: {name} must be float32, got {t.dtype}")
        if t.device != x_a.device:
            raise ValueError(f"fused_affine_coupling: {name} is on {t.device}, x_a on {x_a.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_affine_coupling: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not (x_a.is_contiguous() and x_b.is_contiguous()):
        raise ValueError("fused_affine_coupling: x_a and x_b must be contiguous")
    if B * max(d_a, d_b) >= 2**31:
        raise ValueError(f"fused_affine_coupling: {B} rows exceed the kernel's 32-bit row indexing")


def fused_affine_coupling(
    x_a: torch.Tensor,
    x_b: torch.Tensor,
    h_proj: torch.Tensor,
    w1y: torch.Tensor,
    b1: torch.Tensor,
    wm: Sequence[torch.Tensor],
    bm: Sequence[torch.Tensor],
    wout: torch.Tensor,
    bout: torch.Tensor,
    inverse: bool = False,
    n_cond: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor] | torch.Tensor:
    """One coupling over `(B, d_a)`/`(B, d_b)` halves, row r conditioned on
    `h_proj[r % n_cond]` (`n_cond` defaults to `h_proj`'s rows). Returns
    `(z_b, logdet)` forward or `y_b` inverse. A CPU tensor takes
    `fused_affine_coupling_reference`; a CUDA tensor launches the kernel (or
    raises)."""
    n_cond = h_proj.shape[0] if n_cond is None else n_cond
    wm, bm = list(wm), list(bm)
    if x_a.device.type == "cpu":
        return fused_affine_coupling_reference(x_a, x_b, h_proj, w1y, b1, wm, bm, wout, bout,
                                               inverse=inverse, n_cond=n_cond)
    if x_a.device.type != "cuda":
        raise ValueError(f"fused_affine_coupling runs on CPU or CUDA tensors, not {x_a.device}")
    if len(wm) != len(bm):
        raise ValueError(f"fused_affine_coupling: {len(wm)} hidden weights but {len(bm)} biases")
    _check_args(dict(x_a=x_a, x_b=x_b, h_proj=h_proj, w1y=w1y, b1=b1, wout=wout, bout=bout,
                     **{f"wm[{i}]": w for i, w in enumerate(wm)}, **{f"bm[{i}]": b for i, b in enumerate(bm)}),
                n_cond)

    from bcnf_tpu_torch.ops._build import load_library

    lib = load_library("coupling_kernel")
    B, d_b = x_b.shape
    H = w1y.shape[1]
    p = padded_width(H) - H  # exact zero padding, as `pad_hidden` of the whole flow
    wm_p = F.pad(torch.stack(wm), (0, p, 0, p)) if wm else w1y.new_empty((0, H + p, H + p))
    bm_p = F.pad(torch.stack(bm), (0, p)) if bm else w1y.new_empty((0, H + p))
    padded = [t.contiguous() for t in (F.pad(h_proj, (0, p)), F.pad(w1y, (0, p)), F.pad(b1, (0, p)), wm_p, bm_p,
                                       F.pad(wout, (0, 0, 0, p)), bout)]
    out = torch.empty_like(x_b)
    ld = None if inverse else torch.empty((B,), dtype=x_b.dtype, device=x_b.device)
    if B == 0:
        return out if inverse else (out, ld)
    with torch.cuda.device(x_a.device):
        err = lib.bcnf_coupling(
            *_ptrs(x_a, x_b, *padded, out),
            ctypes.c_void_p(0 if ld is None else ld.data_ptr()),
            B, n_cond, x_a.shape[1], d_b, len(wm), H + p, int(inverse),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    _raise_on(err, lib, "fused_affine_coupling")
    fused_affine_coupling.launches += 1
    return out if inverse else (out, ld)


fused_affine_coupling.launches = 0  # type: ignore[attr-defined]
