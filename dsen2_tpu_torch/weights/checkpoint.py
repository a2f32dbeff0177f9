"""Full training-state checkpoints with torch.save.

The counterpart of dsen2_tpu/weights/checkpoint.py, which writes orbax
directories. Here a state is a directory holding one file, `state.pt`:
params (CPU tensors), the optimizer's state_dict, the epoch and `extra`
(Python scalars, lists, dicts and tensors). It is read back with
torch.load(weights_only=True), which rebuilds tensors and containers only.
Port checkpoints are not orbax directories: weights cross between the two
packages as .npz and Keras .hdf5 (weights/__init__.py).

Crash safety as in the JAX package: the new state is written whole to a
sibling .tmp directory and swapped in with two renames; a .old left by a
crash between them is what restore_train_state reads when the path itself is
missing.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["save_train_state", "restore_train_state"]

_FILE = "state.pt"


def _plain(v: Any) -> Any:
    """`v` in the types torch.load(weights_only=True) rebuilds: numpy
    arrays become Python scalars or lists, tensors move to the CPU."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if torch.is_tensor(v):
        return v.detach().cpu()
    if isinstance(v, (np.ndarray, np.generic)):
        return v.item() if v.ndim == 0 else v.tolist()
    return v


def _write(state: Dict, path: str) -> None:
    os.makedirs(path)
    torch.save(state, os.path.join(path, _FILE))


def save_train_state(path: str, params: Dict, opt_state: Dict, epoch: int,
                     extra: Optional[Dict] = None) -> None:
    """Save params ({top: {name: tensor}}), an optimizer state_dict, the
    epoch and `extra` to the directory `path`. A crash at any point leaves
    the previous state readable by restore_train_state."""
    state = {
        "params": {top: {k: torch.as_tensor(v).detach().to("cpu", torch.float32)
                         for k, v in sub.items()} for top, sub in params.items()},
        "opt_state": opt_state,
        "epoch": int(epoch),
        "extra": _plain(extra or {}),
    }
    path = os.path.abspath(path)
    tmp, old = path + ".tmp", path + ".old"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    _write(state, tmp)
    # A stale .old may be the ONLY valid state (crash after the previous
    # save's path -> old rename): never delete it while `path` is absent.
    if os.path.exists(path):
        if os.path.exists(old):
            shutil.rmtree(old)
        os.rename(path, old)
    os.rename(tmp, path)
    if os.path.exists(old):
        shutil.rmtree(old)


def restore_train_state(path: str) -> Dict:
    """{'params', 'opt_state', 'epoch', 'extra'} from the directory `path`,
    tensors on the CPU; from `path`.old when `path` is missing (a crash
    inside save_train_state's rename window)."""
    path = os.path.abspath(path)
    if not os.path.exists(path) and os.path.exists(path + ".old"):
        path = path + ".old"
    return torch.load(os.path.join(path, _FILE), map_location="cpu", weights_only=True)
