"""bcnf_tpu_torch — the PyTorch/CUDA port of bcnf_tpu, for NVIDIA Hopper.

Plain tensor code is PyTorch; the JAX package's Pallas TPU kernels become
kernels written by hand for `sm_90a` (`ops/csrc/`). The port imports nothing
of JAX or of `bcnf_tpu`; its tests hold it against the JAX package.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from bcnf_tpu_torch.config import ParameterIndexMapping, load_config
from bcnf_tpu_torch.errors import TrainingDivergedError
from bcnf_tpu_torch.models import CondRealNVP, CondRealNVP_v2
from bcnf_tpu_torch import plots

__version__ = "0.1.0"

__all__ = [
    "CondRealNVP",
    "CondRealNVP_v2",
    "plots",
    "load_config",
    "ParameterIndexMapping",
    "TrainingDivergedError",
    "__version__",
]
