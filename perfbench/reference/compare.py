"""The numbers that decide `correct`, each worked out from the program's
output and the reference's, and compared with its limit in perfbench/limits/.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def block_gap(got: Sequence[np.ndarray], want: Sequence[np.ndarray]) -> float:
    """Largest |got - want| over all blocks, as a share of the largest |want|
    (both in DN)."""
    if not want:
        return float("inf")
    top = max(float(np.max(np.abs(w))) for w in want)
    gap = max(float(np.max(np.abs(g.astype(np.float64) - w.astype(np.float64))))
              if g.shape == w.shape else float("inf") for g, w in zip(got, want))
    return gap / max(top, 1e-30)


def dn_gap(got: Sequence[np.ndarray], want: Sequence[np.ndarray]) -> float:
    """Largest |got - want| over all blocks, in DN."""
    if not want:
        return float("inf")
    return max(float(np.max(np.abs(g.astype(np.float64) - w.astype(np.float64))))
               if g.shape == w.shape else float("inf") for g, w in zip(got, want))


def round_half_even_u16(v: np.ndarray) -> np.ndarray:
    """float DN -> uint16: rounded half to even, clipped to [0, 65535]."""
    return np.clip(np.rint(v), 0, 65535).astype(np.uint16)


def leaf_norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float], names=None) -> float:
    """max over leaves of |got - want| / max(want, median of want's leaves):
    the gap between two norms, not the norm of the difference, against the
    leaf's own norm or the median leaf's, whichever is larger."""
    names = list(want) if names is None else list(names)
    if not names or any(k not in got for k in names):
        return float("inf")
    med = float(np.median([want[k] for k in want]))
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in names)


def moved_leaves(grad_norms: Dict[str, float], share: float = 1e-3):
    """Leaves whose reference gradient is at least `share` of the median
    leaf's: the others move under Adam by round-off alone."""
    med = float(np.median(list(grad_norms.values())))
    return [k for k, v in grad_norms.items() if v >= share * med]
