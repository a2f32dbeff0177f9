"""Loaders of the training and test patch archives.

Copies of make_val_index, _split, open_data_files and open_data_files_test
from dsen2_tpu/data/patches_dataset.py (numpy only; tests/test_torch_train.py
holds them equal). The archives are the reference's, channel-first
[N, C, H, W] float32 .npy files:

  data/train[60]/<tile>.SAFE/{data10,data20[,data60],data20_gt|data60_gt}.npy
  data/train[60]/val_index.npy  (boolean validation mask)
  data/test[60]/<tile>.SAFE/{data10,data20[,data60]}.npy + roi.json

In memory everything is NHWC. The writers (create_patches) are not ported
yet: the JAX package's writers make archives both packages read.
"""

from __future__ import annotations

import glob
import json
import os
from typing import List

import numpy as np

__all__ = ["make_val_index", "open_data_files", "open_data_files_test"]


def _to_hwc(p: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(p.transpose(0, 2, 3, 1))


def make_val_index(n_total: int, fraction: float = 0.1, seed: int = 0) -> np.ndarray:
    """Boolean validation mask over all training patch slots (reference:
    training/create_random.py — ~10% True, persisted so the split is stable)."""
    rng = np.random.default_rng(seed)
    mask = np.zeros(n_total, dtype=bool)
    mask[rng.choice(n_total, size=int(n_total * fraction), replace=False)] = True
    return mask


def _split(train: List[np.ndarray], label: np.ndarray, val_ind: np.ndarray):
    val_tr = [p[val_ind] for p in train]
    tr = [p[~val_ind] for p in train]
    return tr, label[~val_ind], val_tr, label[val_ind]


def open_data_files(path: str, run_60: bool, scale: float):
    """Load every tile's training archive under data/train[60]/, concatenate,
    divide by scale, and apply the persisted val split
    (reference: utils/patches.py:288-324 + :274-285). Returns NHWC
    (train_inputs, train_labels, val_inputs, val_labels)."""
    train_path = os.path.join(path, "train60" if run_60 else "train")
    dsets = sorted(glob.glob(os.path.join(train_path, "*SAFE")))
    if not dsets:
        raise FileNotFoundError(f"no *SAFE tile dirs under {train_path}")

    def cat(name):
        return np.concatenate([np.load(os.path.join(d, name + ".npy")) for d in dsets])

    data10 = _to_hwc(cat("data10"))
    data20 = _to_hwc(cat("data20"))
    if run_60:
        data60 = _to_hwc(cat("data60"))
        label = _to_hwc(cat("data60_gt"))
        train = [data10, data20, data60]
    else:
        label = _to_hwc(cat("data20_gt"))
        train = [data10, data20]

    if scale:
        train = [t / np.float32(scale) for t in train]
        label = label / np.float32(scale)

    val_file = os.path.join(train_path, "val_index.npy")
    try:
        val_ind = np.load(val_file)
    except OSError:
        raise FileNotFoundError(
            f"{val_file} missing: generate it with `python -m "
            "dsen2_tpu.cli.create_patches --make-val-index --save_prefix "
            f"{path}" + (" --run_60" if run_60 else "") + "`"
        )
    return _split(train, label, val_ind)


def open_data_files_test(path: str, run_60: bool, scale: float):
    """Load one tile's test-patch archive + roi.json
    (reference: utils/patches.py:327-350). Returns (inputs NHWC, image_size)."""
    scale = scale or 1
    inputs = [_to_hwc(np.load(os.path.join(path, "data10.npy"))) / np.float32(scale)]
    inputs.append(_to_hwc(np.load(os.path.join(path, "data20.npy"))) / np.float32(scale))
    if run_60:
        inputs.append(_to_hwc(np.load(os.path.join(path, "data60.npy"))) / np.float32(scale))
    with open(os.path.join(path, "roi.json")) as f:
        roi = json.load(f)
    # roi.json stores [xmin, ymin, xmax+1, ymax+1]; return (height, width).
    # NOTE: the reference returns [x-extent, y-extent] and feeds it to
    # recompose_images as (rows, cols) — misassembling non-square ROIs
    # (utils/patches.py:345 + :384-385); that conflation is fixed here.
    image_size = [roi[3] - roi[1], roi[2] - roi[0]]
    return inputs, image_size
