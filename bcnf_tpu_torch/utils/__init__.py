"""Utilities (port of `bcnf_tpu/utils/`; `utils/jit.py` has no counterpart:
it only sets a TPU compiler flag)."""

from bcnf_tpu_torch.utils.io import load_data, save_data
from bcnf_tpu_torch.utils.misc import (
    get_data_type,
    get_gaussian_kernel,
    inn_nll_loss,
    partconv1d,
)
from bcnf_tpu_torch.utils.prng import fold_in_step, key_from_seed, key_stream, split_like
from bcnf_tpu_torch.utils.summary import model_summary, param_tree_summary

__all__ = [
    "load_data",
    "save_data",
    "inn_nll_loss",
    "get_gaussian_kernel",
    "partconv1d",
    "get_data_type",
    "key_from_seed",
    "key_stream",
    "split_like",
    "fold_in_step",
    "model_summary",
    "param_tree_summary",
]
