"""Training loss and metric: MAE loss and MSE metric, as the reference
compiles them (training/supres_train.py:144: loss='mean_absolute_error',
metrics=['mean_squared_error']). The counterpart of dsen2_tpu/train/losses.py."""

from __future__ import annotations

import torch

__all__ = ["mae", "mse"]


def mae(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred - target))
