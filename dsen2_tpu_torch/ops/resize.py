"""Separable resampling as two true-f32 matmuls.

The counterpart of dsen2_tpu/ops/resize.py:37-93. The weight matrices come
from ops/resize_weights.py (the parity spec, copied verbatim) and are applied
as two einsums with TF32 off, the port's equivalent of Precision.HIGHEST.
`F.interpolate` computes a different map and is not used.
"""

from __future__ import annotations

import numpy as np
import torch

from dsen2_tpu_torch.core.bands import INTERP_NORM
from dsen2_tpu_torch.core.device import tf32_disabled, upload
from dsen2_tpu_torch.ops import resize_weights as rw

__all__ = [
    "apply_separable", "resize_bilinear", "upsample_patches", "matlab_imresize",
    "wald_downsample", "convert_double_to_byte",
]


def apply_separable(img: torch.Tensor, w_rows: np.ndarray, w_cols: np.ndarray) -> torch.Tensor:
    """out = W_rows @ img @ W_cols^T over the two spatial axes.

    img: [..., H, W, C]; w_rows: [H', H]; w_cols: [W', W].
    Returns [..., H', W', C] with the dtype of img.
    """
    wr = upload(w_rows, img.device, img.dtype)
    wc = upload(w_cols, img.device, img.dtype)
    with tf32_disabled():
        out = torch.einsum("ph,...hwc->...pwc", wr, img)
        return torch.einsum("qw,...pwc->...pqc", wc, out)


def resize_bilinear(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """skimage-convention bilinear resize (order=1, mode='reflect') of
    [..., H, W, C] to [..., out_h, out_w, C]."""
    h, w = img.shape[-3], img.shape[-2]
    return apply_separable(
        img, rw.bilinear_matrix(h, out_hw[0]), rw.bilinear_matrix(w, out_hw[1])
    )


def upsample_patches(patches_lr: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Per-patch bilinear LR->HR pre-interpolation with the reference's
    /30000 ... *30000 normalisation (utils/patches.py:15), batched over the
    leading patch axis. patches_lr: [N, h, w, C] -> [N, out_h, out_w, C]."""
    return resize_bilinear(patches_lr / INTERP_NORM, out_hw) * INTERP_NORM


def matlab_imresize(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """MATLAB-convention bicubic resize (antialiased when downscaling) of
    [..., H, W, C]: the reference's baseline resizer (utils/imresize.py:
    80-112), rows then columns."""
    h, w = img.shape[-3], img.shape[-2]
    return apply_separable(
        img, rw.matlab_cubic_matrix(h, out_hw[0]), rw.matlab_cubic_matrix(w, out_hw[1])
    )


def wald_downsample(img: torch.Tensor, factor: int) -> torch.Tensor:
    """Wald-protocol simulated LR: Gaussian blur (sigma = 1/factor) and
    factor x factor mean pooling (reference utils/patches.py:353-371).
    img: [..., H, W, C] with H and W divisible by factor."""
    h, w = img.shape[-3], img.shape[-2]
    return apply_separable(
        img, rw.wald_downsample_matrix(h, factor), rw.wald_downsample_matrix(w, factor)
    )


def convert_double_to_byte(img: np.ndarray) -> np.ndarray:
    """[0, 1] float image -> rounded uint8 on the host (reference
    utils/imresize.py:114-117)."""
    return np.around(255.0 * np.clip(img, 0.0, 1.0)).astype(np.uint8)
