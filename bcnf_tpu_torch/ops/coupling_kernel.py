"""One affine coupling in a CUDA kernel: host side.

K4, `fused_affine_coupling`, replaces
`bcnf_tpu/ops/coupling_kernel.py::fused_affine_coupling` (the Pallas TPU
kernel `_coupling_kernel`). It runs one coupling's nested MLP on `x_a` plus
the hoisted condition projection, then ``exp(tanh s) * x_b + t`` with the
row log-det, or the inverse. The JAX package reaches it only when a model
sets `use_pallas_coupling` (`bcnf_tpu/models/cnf.py:555-558, 762-764`); so
does the port.

K4 is K1 at one step: K1's last step is the final coupling alone (no
ActNorm, no mix), which is exactly what `_coupling_kernel` computes. So the
wrapper stacks its coupling's weights with S = 1 (`coupling_flow_args`) and
launches K1's kernels (`ops/flow_kernel.py::_launch_flow`) on ``[x_a | x_b]``
in 3xTF32: the inverse on `wgmma` up to the padded width 544, the row tiles
otherwise (JAX's K4 has no strict mode, nor has the port's). A pass of the
per-coupling path launches one coupling once, so the wrapper prepares that
coupling's weights once (the padding, and the `wgmma` layout of the inverse).

Row ``r`` is conditioned on ``h_proj[r % n_cond]``, as K1 does, so a
`(n_samples, N, size)` inverse needs no broadcast copy of the projections.
Unlike the TPU kernel there is no tiling rule: the kernels mask the ragged
last tile. `fused_affine_coupling_reference` is the plain version, which
serves CPU tensors (the tests) and which `chip_smoke.py` holds the kernel
against on the card.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import Sequence

import torch
import torch.nn.functional as F

from bcnf_tpu_torch.ops.flow_kernel import _launch_flow, padded_width
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
    mm: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = torch.matmul,
) -> tuple[torch.Tensor, torch.Tensor] | torch.Tensor:
    """Plain PyTorch version of K4 (`_coupling_kernel`,
    `bcnf_tpu/ops/coupling_kernel.py:34-65`): `(z_b, logdet)` forward, `y_b`
    inverse. `mm` takes every product (the tests pass
    `tf32.matmul_3xtf32`, the arithmetic of the kernel's hidden products)."""
    d_b = x_b.shape[1]
    rows = torch.arange(x_a.shape[0], device=x_a.device) % n_cond
    a = gelu(mm(x_a, w1y) + b1 + h_proj.index_select(0, rows))
    for w, b in zip(wm, bm):
        a = gelu(mm(a, w) + b)
    out = mm(a, wout) + bout
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
    if B * (d_a + d_b) >= 2**31:
        raise ValueError(f"fused_affine_coupling: {B} rows exceed the kernel's 32-bit row indexing")


def coupling_flow_args(h_proj: torch.Tensor, w1y: torch.Tensor, b1: torch.Tensor, wm: Sequence[torch.Tensor],
                       bm: Sequence[torch.Tensor], wout: torch.Tensor, bout: torch.Tensor) -> dict[str, torch.Tensor]:
    """One coupling's arguments as K1's at one step (S = 1: the final
    coupling's slot, whose ActNorm and mix are identity and skipped), the
    hidden width zero-padded to the kernels' (`ops/flow_kernel.padded_width`;
    exact, as `pad_hidden`): every tensor of `fused_flow`'s layout, h_proj
    (1, n_cond, Hp)."""
    H = w1y.shape[1]
    p = padded_width(H) - H
    size = w1y.shape[0] + wout.shape[1] // 2
    wm_p = F.pad(torch.stack(list(wm)), (0, p, 0, p)) if len(wm) else w1y.new_empty((0, H + p, H + p))
    bm_p = F.pad(torch.stack(list(bm)), (0, p)) if len(bm) else w1y.new_empty((0, H + p))
    args = {
        "h_proj": F.pad(h_proj, (0, p))[None],
        "an_scale": w1y.new_ones((1, size)),
        "an_bias": w1y.new_zeros((1, size)),
        "ortho": torch.eye(size, dtype=w1y.dtype, device=w1y.device)[None],
        "w1y": F.pad(w1y, (0, p))[None],
        "b1": F.pad(b1, (0, p))[None],
        "wm": wm_p[None],
        "bm": bm_p[None],
        "wout": F.pad(wout, (0, 0, 0, p))[None],
        "bout": bout[None],
    }
    return {k: v.contiguous() for k, v in args.items()}


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
    `fused_affine_coupling_reference`; a CUDA tensor launches K1's kernel at
    one step (or raises)."""
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
    d_a = x_a.shape[1]
    _, y, ld = _launch_flow(torch.cat([x_a, x_b], dim=1), coupling_flow_args(h_proj, w1y, b1, wm, bm, wout, bout),
                            inverse=inverse, n_cond=n_cond, strict=False)
    if x_a.shape[0]:
        fused_affine_coupling.launches += 1
    y_b = y[:, d_a:].contiguous()
    return y_b if inverse else (y_b, ld)


fused_affine_coupling.launches = 0  # type: ignore[attr-defined]
