from dsen2_tpu_torch.train.callbacks import BestCheckpoint, LossLogger, ReduceLROnPlateau
from dsen2_tpu_torch.train.loop import TrainState, fit, restore_fit_state
from dsen2_tpu_torch.train.losses import mae, mse
from dsen2_tpu_torch.train.nadam import make_optimizer

__all__ = [
    "BestCheckpoint",
    "LossLogger",
    "ReduceLROnPlateau",
    "TrainState",
    "fit",
    "restore_fit_state",
    "mae",
    "mse",
    "make_optimizer",
]
