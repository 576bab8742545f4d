"""The plain PyTorch model of the tensor-core arithmetic of K2a, K2b, K3a and
K3b, for the tests only: nothing on the main path calls it.

The hand-written training kernels (`csrc/flow_kernel.cu`'s K2a,
`csrc/flow_train_kernel.cu`), the LSTM kernels (`csrc/lstm_kernel.cu`) and
the AᵀB pass (`csrc/atb.cuh`) take their
large products on Hopper's tensor cores in 3xTF32 (`csrc/mma_tf32.cuh`): a
float32 ``x`` splits into ``hi = tf32(x)`` (rounded) and ``lo = x - hi``
(which the tensor cores truncate to TF32), and a product ``a b`` is taken as
``a_lo b_hi + a_hi b_lo + a_hi b_hi`` with a float32 accumulator. It is the
Hopper counterpart of the JAX kernels' ``"x3"`` mode (bf16 x 3,
`bcnf_tpu/ops/flow_kernel.py::_dot`), which serves their ``"highest"``
contract. The tests hold the plain versions of those kernels, with
every product replaced by `matmul_3xtf32`, against the JAX kernels.
"""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 (10 explicit mantissa bits), round to nearest with
    ties away from zero, kept in float32: the PTX ``cvt.rna.tf32.f32`` on
    finite values (and on ±inf and 0). Adding half of the 13 dropped bits'
    range to the bit pattern carries into the kept bits exactly when the
    dropped part is at least half, whatever the sign (sign and magnitude are
    separate bits); a carry out of the mantissa moves the exponent up, as
    rounding does."""
    if x.dtype != torch.float32:
        raise TypeError(f"round_tf32 takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32).reshape(x.shape)


def truncate_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 by dropping the 13 low mantissa bits: how the tensor
    cores read a TF32 operand's register."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32).reshape(x.shape)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` as the kernels feed the tensor cores: ``hi = round_tf32(x)``,
    and ``lo = x - hi`` (exact in float32) as the tensor cores read it,
    truncated to TF32."""
    hi = round_tf32(x)
    return hi, truncate_tf32(x - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernels take it on tensor cores: the three products of
    the split operands (each exact in float32: 11-bit significands), the two
    small ones first, summed in float32; the ``lo lo`` term is dropped."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in a single TF32 pass (both operands rounded once): the
    control the tests show to fall outside the float32 bars."""
    return round_tf32(a) @ round_tf32(b)
