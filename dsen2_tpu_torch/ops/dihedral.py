"""The 8 square symmetries (dihedral group D4) of [H, W, ...] rasters.

The counterpart of dsen2_tpu/ops/dihedral.py, for the inference-time
self-ensemble (infer/api.py) and training augmentation (train/). Encoding:
code in [0, 8); code % 4 quarter-turns, then a flip along axis 0 when
code >= 4. `dihedral_np` and `inverse_code` are copies; `dihedral_static` is
the tensor twin for a Python int code; `dihedral` and `dihedral_batch` take
codes as tensors on the device and apply them with one gather, so the host
never reads them.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["dihedral", "dihedral_batch", "dihedral_np", "dihedral_static", "inverse_code"]


def dihedral_static(x: torch.Tensor, code: int) -> torch.Tensor:
    """dihedral_np for a tensor on any device, with a Python int code."""
    y = torch.rot90(x, code % 4, dims=(0, 1))
    if code >= 4:
        y = torch.flip(y, dims=(0,))
    return y


def dihedral_batch(x: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Apply symmetry codes[b] to image x[b] of a square [B, H, H, C] batch.
    codes: [B] integers in [0, 8), on x's device. Each code's pixel map is
    dihedral_static of an index grid; one gather moves every pixel."""
    b, h, w, c = x.shape
    if h != w:
        raise ValueError(f"dihedral_batch needs square images, got {h}x{w}")
    grid = torch.arange(h * w, device=x.device).reshape(h, w)
    maps = torch.stack([dihedral_static(grid, k).reshape(-1) for k in range(8)])
    src = maps[codes.to(device=x.device, dtype=torch.long)]  # [B, H*W]
    out = torch.gather(x.reshape(b, h * w, c), 1, src[:, :, None].expand(b, h * w, c))
    return out.reshape(b, h, w, c)


def dihedral(x: torch.Tensor, code) -> torch.Tensor:
    """Apply symmetry `code` (an int or a tensor on x's device) to a square
    [H, H, C] image."""
    return dihedral_batch(x[None], torch.as_tensor(code, device=x.device).reshape(1))[0]


def dihedral_np(x: np.ndarray, code: int) -> np.ndarray:
    """Apply symmetry `code` to an [H, W, ...] numpy array."""
    y = np.rot90(x, code % 4, axes=(0, 1))
    if code >= 4:
        y = y[::-1]
    return np.ascontiguousarray(y)


# inverse_code[c] satisfies dihedral_np(dihedral_np(x, c), inverse_code[c]) == x.
# Rotations invert to the opposite turn; each flip-variant is an involution
# (flip o rot_k applied twice is the identity for every k).
inverse_code = (0, 3, 2, 1, 4, 5, 6, 7)
