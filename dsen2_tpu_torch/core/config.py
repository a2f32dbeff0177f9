"""Model, inference and training configuration dataclasses.

Copies of ModelConfig, dsen2_2x, dsen2_6x, InferConfig and TrainConfig from
dsen2_tpu/core/config.py, with the same fields and defaults. The one rename:
InferConfig.use_pallas is use_kernels here, with the same None/True/False
tri-state. tests/test_torch_core.py and tests/test_torch_train.py hold the
copies equal.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of the residual super-resolution CNN.

    reference: utils/DSen2Net.py:18-43 (s2model), :9-15 (resBlock).
    """

    in_channels: Tuple[int, ...] = (4, 6)  # (10m bands, 20m bands[, 60m bands])
    num_layers: int = 6
    feature_size: int = 128
    residual_scale: float = 0.1

    @property
    def out_channels(self) -> int:
        return self.in_channels[-1]

    @property
    def total_in_channels(self) -> int:
        return sum(self.in_channels)

    @property
    def run_60(self) -> bool:
        return len(self.in_channels) == 3


def dsen2_2x(deep: bool = False) -> ModelConfig:
    """DSen2/VDSen2 2x (20m->10m) config (reference: testing/supres.py:26,56,59)."""
    return ModelConfig(
        in_channels=(4, 6),
        num_layers=32 if deep else 6,
        feature_size=256 if deep else 128,
    )


def dsen2_6x(deep: bool = False) -> ModelConfig:
    """DSen2_60/VDSen2_60 6x (60m->10m) config (reference: testing/supres.py:46,56,59)."""
    return ModelConfig(
        in_channels=(4, 6, 2),
        num_layers=32 if deep else 6,
        feature_size=256 if deep else 128,
    )


@dataclasses.dataclass(frozen=True)
class InferConfig:
    """Patch geometry and numerics for tiled inference.

    Patch sizes/borders follow the reference inference API
    (testing/supres.py:21-22 for 2x: 128/8; :40-41 for 6x: 192/12).
    """

    patch_size: int = 128  # on the 10m (HR) grid
    border: int = 8  # on the 10m (HR) grid
    batch_size: int = 64  # patches per device step
    # Accuracy class of the residual blocks:
    #   "highest" - true f32 convs, TF32 off
    #   "high"    - bf16x3 (hi*hi + lo*hi + hi*lo), ~3e-5 relative
    #   "default" - one bf16 pass, ~6e-3 relative
    precision: str = "high"
    compute_dtype: str = "float32"
    # Route the residual blocks through the hand-written kernels
    # (ops/resblock_chain.py, ops/resblock.py). None = AUTO: on for "high"
    # and "default" wherever the tensors are on a GPU. True asks for them
    # explicitly; False runs plain convs.
    use_kernels: Optional[bool] = None
    # Mosaic output dtype: "float32"; an integer dtype such as "uint16"
    # (rounded half to even, then clipped to the dtype's range); or
    # "bfloat16" (rounded to nearest even; an ml_dtypes.bfloat16 array).
    output_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference: training/supres_train.py:23-25,130-144,203-209)."""

    lr: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    schedule_decay: float = 0.004  # Keras-2 Nadam momentum schedule decay
    batch_size: int = 128  # 8 for VDSen2 (reference :131,134)
    epochs: int = 8 * 1024
    # ReduceLROnPlateau (reference :203-209)
    plateau_factor: float = 0.5
    plateau_patience: int = 5
    plateau_cooldown: int = 20
    plateau_min_lr: float = 1e-5
    plateau_min_delta: float = 1e-6
    val_fraction: float = 0.1
    seed: int = 0
    model_nr: str = "s2_038_"
    out_dir: Optional[str] = None
    # Periodic full-state (params + Nadam moments + plateau + history)
    # checkpoint cadence, in epochs (weights/checkpoint.py); 0 disables.
    state_every: int = 25
    # Random dihedral (flip/rot90) augmentation of training samples, applied
    # identically to every input and the label; deterministic per
    # (seed, epoch), so resume keeps the trajectory.
    augment: bool = False
