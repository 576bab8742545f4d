"""The deterministic AᵀB weight-grad pass of K2b and K3b on its own: host side.

`csrc/atb.cuh` is not a TPU kernel of its own: the JAX kernels accumulate
their weight grads in VMEM across the batch grid (`bcnf_tpu/ops/
flow_kernel.py::_flow_bwd_train_kernel`, `bcnf_tpu/ops/lstm_kernel.py::
_bwd_kernel`), and the port forms them after the rows, on tensor cores in
3xTF32, in fixed row chunks whose partials are summed in a fixed order. K2b
and K3b call it from C; `atb` exposes it for the tests that hold it against
`atb_reference` on the card. A CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from bcnf_tpu_torch.ops.flow_kernel import _ptrs, _raise_on


def atb_reference(a: torch.Tensor, b: torch.Tensor, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: for each chunk p of `chunk` rows of ``a (k, m)`` and
    ``b (k, n)``, ``a_p^T b_p`` and the column sums of ``b_p``; returns
    ``(c (chunks, m, n), sums (chunks, n))``, at least one chunk."""
    k = a.shape[0]
    starts = range(0, max(k, 1), chunk)
    c = torch.stack([a[r: r + chunk].T @ b[r: r + chunk] for r in starts])
    sums = torch.stack([b[r: r + chunk].sum(0) for r in starts])
    return c, sums


def atb(a: torch.Tensor, b: torch.Tensor, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`atb_reference` in one launch of the AᵀB kernel on CUDA tensors
    (contiguous float32), or the plain version on CPU tensors."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0] or chunk < 1:
        raise ValueError(f"atb takes a (k, m), b (k, n) and a chunk >= 1, got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {chunk}")
    if a.device.type == "cpu":
        return atb_reference(a, b, chunk)
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.float32 or t.device != a.device or not t.is_contiguous():
            raise ValueError(f"atb: {name} must be contiguous float32 on {a.device}")
    from bcnf_tpu_torch.ops._build import load_library

    lib = load_library("lstm_kernel")
    (k, m), n = a.shape, b.shape[1]
    n_chunks = max(1, -(-k // chunk))
    c = torch.empty((n_chunks, m, n), dtype=a.dtype, device=a.device)
    sums = torch.empty((n_chunks, n), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        err = lib.bcnf_atb(*_ptrs(a, b, c, sums), m, n, m, n, k, chunk,
                           ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _raise_on(err, lib, "atb")
    atb.launches += 1
    return c, sums


atb.launches = 0  # type: ignore[attr-defined]
