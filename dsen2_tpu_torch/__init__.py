"""dsen2_tpu_torch — DSen2 Sentinel-2 super-resolution in PyTorch and CUDA.

The port of the JAX package `dsen2_tpu` to an NVIDIA H100. It keeps that
package's public conventions (NHWC numpy in and out, HWIO weights, the same
configs and weight files) and never imports it or JAX. Plain tensor code is
PyTorch; the residual blocks, which the JAX package ran as Pallas TPU
kernels, run as CUDA kernels written by hand for sm_90a (`csrc/`), built at
first use. Importing the package builds and loads nothing.
"""

__version__ = "0.1.0"

from dsen2_tpu_torch.core import (
    SCALE,
    InferConfig,
    ModelConfig,
    TrainConfig,
    dsen2_2x,
    dsen2_6x,
)
from dsen2_tpu_torch.infer.api import dsen2_20, dsen2_60

__all__ = [
    "SCALE",
    "InferConfig",
    "ModelConfig",
    "TrainConfig",
    "dsen2_2x",
    "dsen2_6x",
    "dsen2_20",
    "dsen2_60",
]
