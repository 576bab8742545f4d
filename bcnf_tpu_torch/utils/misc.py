"""Small numeric utilities and the port's device rule."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device rule of every entry point: ``None`` means ``"cuda"``.

    Asking for CUDA on a host without a usable GPU raises instead of quietly
    running on the CPU; pass ``device="cpu"`` to run there on purpose.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def inn_nll_loss(z: torch.Tensor, log_det_J: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    """Change-of-variables NLL (`bcnf_tpu/utils/misc.py:9`, reference
    `src/bcnf/utils.py:49-53`). The constant ``D/2*log(2*pi)`` is omitted on
    purpose (SURVEY.md Q9), so NLL numbers compare with the reference's."""
    per_example = 0.5 * torch.sum(z**2, dim=1) - log_det_J
    if reduction == "mean":
        return torch.mean(per_example)
    return per_example


def get_data_type(dtype: str) -> torch.dtype:
    """Map config dtype strings to torch dtypes (reference `src/bcnf/train/utils.py:12-34`)."""
    if dtype == "float64":
        return torch.float64
    if dtype == "bfloat16":
        return torch.bfloat16
    if dtype != "float32":
        print("dtype was not correctly specified in the config file, using default value 'float32'")
    return torch.float32
