"""Weight loading, the default-weights registry and the crossing to torch.

The counterpart of dsen2_tpu/weights/__init__.py:38-129, with the same search
order:

  1. DSEN2_TPU_WEIGHTS_DIR, when set, and nothing else (an empty override
     dir deliberately yields the fresh init);
  2. the repository's models/ directory, found from this file's location,
     never from the working directory;
  3. a fresh he_uniform init from a seeded torch.Generator, with a warning.

In each directory the reference's .hdf5 name comes before the .npz of the
same stem (the .npz alone where h5py is not installed). Params are a numpy
dict (head / blocks / tail, HWIO kernels) as in the JAX package;
`params_to_torch` carries them onto a device and `params_to_numpy` back, so
what training writes (`save_params_npz`, `save_keras_weights`) stays
readable by the JAX package and the reference.
"""

from __future__ import annotations

import importlib.util
import os
import warnings
from typing import Dict, Optional, Union

import numpy as np
import torch

from dsen2_tpu_torch.core.config import ModelConfig
from dsen2_tpu_torch.models import s2net
from dsen2_tpu_torch.weights.keras_h5 import load_keras_weights, save_keras_weights

__all__ = [
    "load_keras_weights", "save_keras_weights", "load_params_npz", "save_params_npz",
    "default_params", "reference_weight_filename", "params_to_torch", "params_to_numpy",
]

# Weight-file naming from the reference (testing/supres.py:57,60).
_WEIGHT_FILES = {
    (False, False): "s2_032_lr_1e-04.hdf5",  # DSen2 2x
    (True, False): "s2_030_lr_1e-05.hdf5",  # DSen2_60 6x
    (False, True): "s2_033_lr_1e-04.hdf5",  # VDSen2 2x
    (True, True): "s2_034_lr_1e-04.hdf5",  # VDSen2_60 6x
}

_cache: Dict[tuple, Dict] = {}


def reference_weight_filename(run_60: bool, deep: bool) -> str:
    return _WEIGHT_FILES[(run_60, deep)]


def _search_dirs() -> list[str]:
    env = os.environ.get("DSEN2_TPU_WEIGHTS_DIR")
    if env:
        return [env]
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return [os.path.join(repo, "models")]


def _resolve_weight_file(fname: str) -> Optional[str]:
    # Without h5py an .hdf5 cannot be read; its .npz twin still can.
    hdf5_ok = importlib.util.find_spec("h5py") is not None
    for d in _search_dirs():
        path = os.path.join(d, fname)
        if hdf5_ok and os.path.exists(path):
            return path
        npz_path = path.replace(".hdf5", ".npz")
        if os.path.exists(npz_path):
            return npz_path
    return None


def default_params(cfg: ModelConfig, run_60: bool, deep: bool) -> Dict:
    """The reference's weights for this network as a numpy params dict, or a
    warned fresh init when no file is found. Cached on the resolved file's
    path, mtime and size."""
    fname = reference_weight_filename(run_60, deep)
    found = _resolve_weight_file(fname)
    stamp = None
    if found is not None:
        st = os.stat(found)
        stamp = (found, st.st_mtime_ns, st.st_size)
    key = (run_60, deep, cfg.num_layers, cfg.feature_size, cfg.in_channels, stamp)
    if key in _cache:
        return _cache[key]

    if found is None:
        warnings.warn(
            f"pretrained weights {fname} not found (reference LFS blobs are "
            "absent from this snapshot); using a deterministic fresh "
            "he_uniform init — outputs are UNTRAINED",
            stacklevel=2,
        )
        params = s2net.init_params(torch.Generator().manual_seed(0), cfg)
    elif found.endswith(".npz"):
        params = load_params_npz(found)
    else:
        params = load_keras_weights(found, cfg)
    _cache[key] = params
    return params


def save_params_npz(path: str, params: Dict) -> None:
    """Flat .npz dump of the params dict (portable, dependency-free; a copy
    of dsen2_tpu's save_params_npz)."""
    flat = {}
    for top, sub in params.items():
        for name, arr in sub.items():
            flat[f"{top}.{name}"] = np.asarray(arr)
    np.savez(path, **flat)


def load_params_npz(path: str) -> Dict:
    """Read a flat 'top.name' .npz dump (dsen2_tpu's save_params_npz)."""
    out: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            top, name = key.split(".", 1)
            out.setdefault(top, {})[name] = data[key]
    return out


def params_to_torch(
    params_np: Dict, device: Union[str, torch.device], dtype: torch.dtype = torch.float32
) -> Dict[str, Dict[str, torch.Tensor]]:
    """The one crossing of parameters into the port: a {top: {name: array}}
    dict of numpy arrays (or tensors) -> the same dict of `dtype` tensors on
    `device`, layouts unchanged (HWIO kernels)."""
    return {
        top: {name: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
              .to(device=device, dtype=dtype).contiguous()
              for name, v in sub.items()}
        for top, sub in params_np.items()
    }


def params_to_numpy(params: Dict) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse of params_to_torch: a {top: {name: tensor}} dict (any
    device, with or without grad) -> the same dict of f32 numpy arrays on the
    host."""
    return {
        top: {name: (v.detach().to("cpu", torch.float32).numpy() if torch.is_tensor(v)
                     else np.asarray(v, np.float32))
              for name, v in sub.items()}
        for top, sub in params.items()
    }
