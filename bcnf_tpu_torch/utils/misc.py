"""Small numeric utilities and the port's device rule."""

from __future__ import annotations

import numpy as np
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


def get_gaussian_kernel(sigma: float, window_size: int | None = None) -> np.ndarray:
    """Unnormalized Gaussian kernel (`bcnf_tpu/utils/misc.py:22`, reference `src/bcnf/utils.py:56-60`)."""
    if window_size is None:
        window_size = int(sigma * 3.5)
    return np.exp(-np.arange(-window_size, window_size + 1) ** 2 / (2 * sigma**2))


def partconv1d(data: np.ndarray, kernel: np.ndarray, periodic: bool = False) -> np.ndarray:
    """Edge-normalized 1-D convolution (`bcnf_tpu/utils/misc.py:29`, reference
    `src/bcnf/utils.py:63-111`): ``data`` convolved with ``kernel``, the
    truncated kernel renormalized at the edges so boundary values are
    unbiased; optional periodic padding."""
    if not isinstance(data, np.ndarray) or not isinstance(kernel, np.ndarray):
        raise ValueError("Data and kernel must be numpy arrays.")
    if len(kernel) % 2 == 0:
        raise ValueError("Kernel size must be odd.")

    window_size = len(kernel) // 2

    if periodic:
        data = np.concatenate((data[-window_size:], data, data[:window_size]))

    middle = np.convolve(data, kernel / kernel.sum(), mode="valid")

    left = np.empty(2 * window_size - 1)
    right = np.empty(2 * window_size - 1)
    for i in range(1, 2 * window_size):
        left[i - 1] = data[:i] @ kernel[-i:] / kernel[-i:].sum()
        right[i - 1] = (
            data[-2 * window_size + i:] @ kernel[: 2 * window_size - i] / kernel[: 2 * window_size - i].sum()
        )

    out = np.concatenate((left[window_size - 1:], middle, right[:window_size]))

    if periodic:
        out = out[window_size:-window_size]

    return out


def get_data_type(dtype: str) -> torch.dtype:
    """Map config dtype strings to torch dtypes (reference `src/bcnf/train/utils.py:12-34`)."""
    if dtype == "float64":
        return torch.float64
    if dtype == "bfloat16":
        return torch.bfloat16
    if dtype != "float32":
        print("dtype was not correctly specified in the config file, using default value 'float32'")
    return torch.float32
