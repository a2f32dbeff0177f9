"""Resampling, tiling, the class conv and the residual-block kernels (B1, B2).

Importing this package neither builds nor loads a kernel: the CUDA library is
built at the first launch (ops/_build.py).
"""

from dsen2_tpu_torch.ops.resize import (
    apply_separable,
    matlab_imresize,
    resize_bilinear,
    upsample_patches,
    wald_downsample,
)
from dsen2_tpu_torch.ops.tiling import PatchGrid, extract_patches, recompose

__all__ = [
    "apply_separable",
    "matlab_imresize",
    "resize_bilinear",
    "upsample_patches",
    "wald_downsample",
    "PatchGrid",
    "extract_patches",
    "recompose",
]
