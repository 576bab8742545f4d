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
in 3xTF32, or in one TF32 pass in the reduced mode (JAX's K4 takes its dots
at the model's precision): the inverse on `wgmma` up to the padded width
544; the forward in either mode on the `wgmma` forward up to 544
(`csrc/flow_fwd_wgmma.cu`); at 768 and 1024 both ways on the wide kernels
of the mode (`csrc/flow_wide_wgmma.cu`); the row tiles otherwise (JAX's K4 has
no strict mode, nor has the port's); in one pass at 768 and 1024 both ways
on those kernels' one-pass build. The wrapper prepares a coupling's weights
(the padding and stacking, and for a `wgmma` route the layout of its hidden
weights that route reads) once per parameter version and keeps them
(`prepared_coupling`),
so a pass with unchanged weights prepares each coupling once in all, and an
in-place update of a weight (which bumps its `_version`) or a new weight
tensor prepares it again.

Row ``r`` is conditioned on ``h_proj[r % n_cond]``, as K1 does, so a
`(n_samples, N, size)` inverse needs no broadcast copy of the projections.
Unlike the TPU kernel there is no tiling rule: the kernels mask the ragged
last tile. `fused_affine_coupling_reference` is the plain version, which
serves CPU tensors (the tests) and which `chip_smoke.py` holds the kernel
against on the card.
"""

from __future__ import annotations

import collections
from collections.abc import Callable
from typing import Sequence

import torch
import torch.nn.functional as F

from bcnf_tpu_torch.ops.flow_kernel import (
    FWD_WGMMA_ROUTES,
    MODE_3XTF32,
    ROUTE_WGMMA,
    ROUTE_WGMMA_TF32,
    ROUTE_WIDE,
    ROUTE_WIDE_TF32,
    TF32_MODES,
    WIDE_ROUTES,
    WIDE_TF32_ROUTES,
    _check_mode,
    _launch_flow,
    flow_route,
    padded_width,
    route_weights,
)
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
    inverse. `mm` takes every product (`tf32.matmul_3xtf32`, the default
    mode's arithmetic of the kernel's hidden products; `tf32.matmul_tf32`, the
    one-pass mode's)."""
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


def _weight_args(w1y: torch.Tensor, b1: torch.Tensor, wm: Sequence[torch.Tensor], bm: Sequence[torch.Tensor],
                 wout: torch.Tensor, bout: torch.Tensor) -> dict[str, torch.Tensor]:
    """Every argument of `coupling_flow_args` but h_proj."""
    H = w1y.shape[1]
    p = padded_width(H) - H
    size = w1y.shape[0] + wout.shape[1] // 2
    wm_p = F.pad(torch.stack(list(wm)), (0, p, 0, p)) if len(wm) else w1y.new_empty((0, H + p, H + p))
    bm_p = F.pad(torch.stack(list(bm)), (0, p)) if len(bm) else w1y.new_empty((0, H + p))
    args = {
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


def _pad_projection(h_proj: torch.Tensor, Hp: int) -> torch.Tensor:
    return F.pad(h_proj, (0, Hp - h_proj.shape[-1]))[None].contiguous()


def coupling_flow_args(h_proj: torch.Tensor, w1y: torch.Tensor, b1: torch.Tensor, wm: Sequence[torch.Tensor],
                       bm: Sequence[torch.Tensor], wout: torch.Tensor, bout: torch.Tensor) -> dict[str, torch.Tensor]:
    """One coupling's arguments as K1's at one step (S = 1: the final
    coupling's slot, whose ActNorm and mix are identity and skipped), the
    hidden width zero-padded to the kernels' (`ops/flow_kernel.padded_width`;
    exact, as `pad_hidden`): every tensor of `fused_flow`'s layout, h_proj
    (1, n_cond, Hp)."""
    args = _weight_args(w1y, b1, wm, bm, wout, bout)
    return dict(args, h_proj=_pad_projection(h_proj, args["b1"].shape[-1]))


# The prepared weights of the couplings seen last (`prepared_coupling`), the
# least recently used dropped past PREPARED_CAPACITY: room for every
# coupling of a 26-block flow in both directions' layouts, twice over.
PREPARED_CAPACITY = 64
_prepared: collections.OrderedDict[tuple, dict] = collections.OrderedDict()


def _memory_key(t: torch.Tensor) -> tuple:
    return t.data_ptr(), t.dtype, str(t.device), tuple(t.shape), t.stride()


def prepared_coupling(w1y: torch.Tensor, b1: torch.Tensor, wm: Sequence[torch.Tensor], bm: Sequence[torch.Tensor],
                      wout: torch.Tensor, bout: torch.Tensor) -> dict:
    """One coupling's prepared weights: `{"args": every argument of
    `coupling_flow_args` but h_proj, "wstages": {route: the layout of the
    hidden weights that `wgmma` route reads}}` (the layouts filled in by the
    caller as a route needs them; the wide inverse's and forward's one
    layout under `ROUTE_WIDE`, in one pass under `ROUTE_WIDE_TF32`: a layout
    is kept by its mode, and never reaches the other mode's kernel),
    made once per parameter version. Each weight is known by the memory it
    views (address, dtype, device, shape, strides: a per-block view `t[k]`
    of the stacked parameters is a new tensor object at every pass, but the
    same memory) and checked by its `_version`, which every in-place update
    of it or of its base bumps. The entry keeps the weights it was made from,
    so no other tensor can take their memory while it lives. Counts each
    preparation in `fused_affine_coupling.preparations`."""
    weights = (w1y, b1, *wm, *bm, wout, bout)
    key = (len(wm),) + tuple(_memory_key(t) for t in weights)
    versions = tuple(t._version for t in weights)
    entry = _prepared.get(key)
    if entry is not None and entry["versions"] == versions:
        _prepared.move_to_end(key)
        return entry
    with torch.no_grad():
        entry = {"weights": weights, "versions": versions, "args": _weight_args(w1y, b1, wm, bm, wout, bout),
                 "wstages": {}}
    _prepared[key] = entry
    _prepared.move_to_end(key)
    while len(_prepared) > PREPARED_CAPACITY:
        _prepared.popitem(last=False)
    fused_affine_coupling.preparations += 1
    return entry


def layout_key(route: str) -> str:
    """The key under which a coupling keeps the layout of its hidden weights
    that `route` reads (`prepared_coupling`'s "wstages"): the route itself,
    but the wide inverse and forward of a mode read one layout, kept under
    the mode's wide inverse route, so that a layout of one mode never
    reaches the other mode's kernel."""
    if route in WIDE_ROUTES:
        return ROUTE_WIDE_TF32 if route in WIDE_TF32_ROUTES else ROUTE_WIDE
    return route


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
    mode: str = MODE_3XTF32,
) -> tuple[torch.Tensor, torch.Tensor] | torch.Tensor:
    """One coupling over `(B, d_a)`/`(B, d_b)` halves, row r conditioned on
    `h_proj[r % n_cond]` (`n_cond` defaults to `h_proj`'s rows). Returns
    `(z_b, logdet)` forward or `y_b` inverse. A CPU tensor takes
    `fused_affine_coupling_reference` (float32 in every mode); a CUDA tensor
    launches K1's kernel at one step in `mode` (3xTF32 or one TF32 pass) on
    the coupling's prepared weights (`prepared_coupling`), or raises. Counts
    its launches in `launches`, by mode in `mode_launches`, and the
    preparations of its weights in `preparations` (the padded stack) and
    `stage_preparations` (a `wgmma` route's layout)."""
    _check_mode(mode, TF32_MODES)
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
    (B, d_a), size = x_a.shape, x_a.shape[1] + x_b.shape[1]
    entry = prepared_coupling(w1y, b1, wm, bm, wout, bout)
    args = dict(entry["args"], h_proj=_pad_projection(h_proj, entry["args"]["b1"].shape[-1]))
    wstages = None
    route = flow_route(args["b1"].shape[-1], size, d_a, inverse, mode)
    if B and route in (ROUTE_WGMMA, ROUTE_WGMMA_TF32, *WIDE_ROUTES, *FWD_WGMMA_ROUTES):
        layout = layout_key(route)
        if layout not in entry["wstages"]:
            entry["wstages"][layout] = route_weights(route, args["wm"])
            fused_affine_coupling.stage_preparations += 1
        wstages = entry["wstages"][layout]
    _, y, ld = _launch_flow(torch.cat([x_a, x_b], dim=1), args, inverse=inverse, n_cond=n_cond, mode=mode,
                            wstages=wstages)
    if x_a.shape[0]:
        fused_affine_coupling.launches += 1
        fused_affine_coupling.mode_launches[mode] += 1
    y_b = y[:, d_a:].contiguous()
    return y_b if inverse else (y_b, ld)


fused_affine_coupling.launches = 0  # type: ignore[attr-defined]
fused_affine_coupling.mode_launches = collections.Counter()  # type: ignore[attr-defined]
fused_affine_coupling.preparations = 0  # type: ignore[attr-defined]
fused_affine_coupling.stage_preparations = 0  # type: ignore[attr-defined]
