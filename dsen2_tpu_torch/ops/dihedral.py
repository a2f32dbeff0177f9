"""The 8 square symmetries (dihedral group D4) of [H, W, ...] rasters.

The counterpart of dsen2_tpu/ops/dihedral.py for the inference-time
self-ensemble (infer/api.py). Encoding: code in [0, 8); code % 4 quarter-turns,
then a flip along axis 0 when code >= 4. `dihedral_np` and `inverse_code` are
copies; `dihedral_static` is the tensor twin. The traced-code `dihedral` and
`dihedral_batch` serve training augmentation and come with the training port.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["dihedral_np", "dihedral_static", "inverse_code"]


def dihedral_static(x: torch.Tensor, code: int) -> torch.Tensor:
    """dihedral_np for a tensor on any device, with a Python int code."""
    y = torch.rot90(x, code % 4, dims=(0, 1))
    if code >= 4:
        y = torch.flip(y, dims=(0,))
    return y


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
