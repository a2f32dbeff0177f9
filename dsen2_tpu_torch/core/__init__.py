from dsen2_tpu_torch.core.bands import (
    BANDS_10M,
    BANDS_20M,
    BANDS_60M,
    INTERP_NORM,
    SCALE,
    SELECT_BANDS_20,
    SELECT_BANDS_60,
    TileSpec,
)
from dsen2_tpu_torch.core.config import (
    InferConfig,
    ModelConfig,
    TrainConfig,
    dsen2_2x,
    dsen2_6x,
)

__all__ = [
    "BANDS_10M",
    "BANDS_20M",
    "BANDS_60M",
    "INTERP_NORM",
    "SCALE",
    "SELECT_BANDS_20",
    "SELECT_BANDS_60",
    "TileSpec",
    "InferConfig",
    "ModelConfig",
    "TrainConfig",
    "dsen2_2x",
    "dsen2_6x",
]
