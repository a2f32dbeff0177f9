"""MATLAB .mat demo-scene loader.

A copy of dsen2_tpu/data/mat.py (the reference's readh5,
testing/demoDSen2.py:14-28) for MATLAB v7.3 files, which are HDF5 and store
im10/im20/im60/imGT channel-first, so transposing yields HWC. Older MATLAB
files (v5, as scipy.io.savemat writes them) are read with scipy, which
returns MATLAB's own HWC orientation; they serve where h5py is missing.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["read_scene"]

_HDF5_SIGNATURE = b"\x89HDF\r\n\x1a\n"


def _is_hdf5(path: str) -> bool:
    """HDF5 files start with the signature, or carry it after MATLAB's
    512-byte user block."""
    with open(path, "rb") as fh:
        head = fh.read(520)
    return head[:8] == _HDF5_SIGNATURE or head[512:520] == _HDF5_SIGNATURE


def read_scene(path: str) -> Dict[str, np.ndarray]:
    """Load every raster in a demo .mat scene as float32 HWC arrays keyed by
    name (im10, im20, and when present im60, imGT)."""
    out: Dict[str, np.ndarray] = {}
    if not _is_hdf5(path):
        from scipy.io import loadmat

        for key, arr in loadmat(path).items():
            if not key.startswith("__") and np.ndim(arr) == 3:
                out[key] = np.asarray(arr, np.float32)
        return out

    import h5py

    with h5py.File(path, "r") as f:
        for key in f:
            arr = np.asarray(f[key])
            if arr.ndim == 3:
                out[key] = arr.transpose().astype(np.float32)
    return out
