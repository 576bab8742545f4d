"""Training-side modules of the port (`bcnf_tpu/train/__init__.py`)."""

from bcnf_tpu_torch.train.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from bcnf_tpu_torch.train.data import DeviceDataset, TrainerDataHandler
from bcnf_tpu_torch.train.history import (
    JSONLSink,
    MetricSink,
    MultiSink,
    StdoutSink,
    TrainerParameterHistoryHandler,
    WandbSink,
)
from bcnf_tpu_torch.train.online import OnlineSimulator, train_online
from bcnf_tpu_torch.train.optim import (
    ReduceLROnPlateau,
    get_learning_rate,
    make_optimizer,
    set_learning_rate,
)
from bcnf_tpu_torch.train.trainer import Trainer, train_CondRealNVP

__all__ = [
    "Trainer",
    "train_CondRealNVP",
    "OnlineSimulator",
    "train_online",
    "TrainerDataHandler",
    "DeviceDataset",
    "TrainerParameterHistoryHandler",
    "MetricSink",
    "StdoutSink",
    "JSONLSink",
    "WandbSink",
    "MultiSink",
    "make_optimizer",
    "ReduceLROnPlateau",
    "set_learning_rate",
    "get_learning_rate",
    "save_checkpoint",
    "load_checkpoint",
    "latest_checkpoint",
]
