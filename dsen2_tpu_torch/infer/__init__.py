from dsen2_tpu_torch.infer.api import dsen2_20, dsen2_60, sr_tile
from dsen2_tpu_torch.infer.engine import sr_banded
from dsen2_tpu_torch.infer.metrics import (
    ergas,
    evaluation_table,
    per_band_rmse,
    per_band_sre,
    rmse,
    sam_deg,
    sre_db,
    uiq,
)

__all__ = [
    "dsen2_20",
    "dsen2_60",
    "sr_tile",
    "sr_banded",
    "ergas",
    "evaluation_table",
    "per_band_rmse",
    "per_band_sre",
    "rmse",
    "sam_deg",
    "sre_db",
    "uiq",
]
