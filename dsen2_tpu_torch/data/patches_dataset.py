"""Training/test patch archive builders and loaders.

A copy of dsen2_tpu/data/patches_dataset.py on the port's numpy helpers
(tests/test_torch_patches.py and tests/test_torch_train.py hold the archives
and loads equal to the original's). On-disk format is bit-compatible with the
reference archives so datasets can be interchanged both ways:

  data/train[60]/<tile>.SAFE/{data10,data20[,data60],data20_gt|data60_gt}.npy
      channel-first [N, C, H, W] float32 random crops
      (reference: utils/patches.py:181-271 save_random_patches[60])
  data/test[60]/<tile>.SAFE/{data10,data20[,data60]}.npy + roi.json
      channel-first overlapping test patches INCLUDING the reference's zero
      slack slots (utils/patches.py:35,104,159-178)
  data/train[60]/val_index.npy — boolean validation mask
      (training/create_random.py)

In memory everything is NHWC; converters live at the save/load boundary
only. Everything here is host numpy: create_patches runs the Wald
downsample on the device and hands these writers host arrays.
"""

from __future__ import annotations

import glob
import json
import os
from typing import List, Optional, Tuple

import numpy as np

from dsen2_tpu_torch.core.bands import INTERP_NORM
from dsen2_tpu_torch.ops import resize_weights as rw
from dsen2_tpu_torch.ops.tiling import PatchGrid, pad_patch_slack

__all__ = [
    "interp_patches_host",
    "save_random_patches",
    "save_random_patches60",
    "save_test_patches",
    "save_test_patches60",
    "make_val_index",
    "open_data_files",
    "open_data_files_test",
    "open_data_files_test_stream",
]


def _to_chw(p: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(p.transpose(0, 3, 1, 2))


def _to_hwc(p: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(p.transpose(0, 2, 3, 1))


def interp_patches_host(patches: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Vectorised host version of the per-patch bilinear LR->HR
    pre-interpolation (utils/patches.py:11-16), f32 like the reference:
    [N,h,w,C] -> [N,H,W,C]."""
    h, w = patches.shape[1:3]
    wr = rw.bilinear_matrix(h, out_hw[0]).astype(np.float32)
    wc = rw.bilinear_matrix(w, out_hw[1]).astype(np.float32)
    x = patches.astype(np.float32) / np.float32(INTERP_NORM)
    x = np.einsum("ph,nhwc->npwc", wr, x).astype(np.float32)
    x = np.einsum("qw,npwc->npqc", wc, x).astype(np.float32)
    return x * np.float32(INTERP_NORM)


def _random_crops(
    rng: np.random.Generator, n: int, lr_shape: Tuple[int, int], patch_lr: int
) -> np.ndarray:
    hi_y = lr_shape[0] - patch_lr
    hi_x = lr_shape[1] - patch_lr
    if hi_y < 0 or hi_x < 0:
        raise ValueError(
            f"raster {lr_shape} smaller than the crop size {patch_lr}"
        )
    ys = rng.integers(0, max(hi_y, 1), size=n)
    xs = rng.integers(0, max(hi_x, 1), size=n)
    return np.stack([ys, xs], axis=1)


def save_random_patches(
    d20_gt: np.ndarray,
    d10: np.ndarray,
    d20: np.ndarray,
    out_dir: str,
    n_crops: int = 8000,
    seed: Optional[int] = None,
) -> None:
    """Random 32x32 HR / 16x16 LR training crops for the 2x network
    (reference: utils/patches.py:181-219; NR_CROP=8000).

    d20_gt: ground-truth 20m bands at the HR grid of the simulated pair;
    d10/d20: the Wald-downsampled inputs. All HWC."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    crops = _random_crops(rng, n_crops, d20.shape[:2], 16)

    p10 = np.zeros((n_crops, 32, 32, d10.shape[2]), np.float32)
    pgt = np.zeros((n_crops, 32, 32, d20_gt.shape[2]), np.float32)
    p20 = np.zeros((n_crops, 16, 16, d20.shape[2]), np.float32)
    for i, (y, x) in enumerate(crops):
        p20[i] = d20[y : y + 16, x : x + 16]
        p10[i] = d10[2 * y : 2 * y + 32, 2 * x : 2 * x + 32]
        pgt[i] = d20_gt[2 * y : 2 * y + 32, 2 * x : 2 * x + 32]

    np.save(os.path.join(out_dir, "data10.npy"), _to_chw(p10))
    np.save(os.path.join(out_dir, "data20_gt.npy"), _to_chw(pgt))
    np.save(os.path.join(out_dir, "data20.npy"), _to_chw(interp_patches_host(p20, (32, 32))))


def save_random_patches60(
    d60_gt: np.ndarray,
    d10: np.ndarray,
    d20: np.ndarray,
    d60: np.ndarray,
    out_dir: str,
    n_crops: int = 500,
    seed: Optional[int] = None,
    patch_60: int = 16,
) -> None:
    """Random crops for the 6x network, sized patch_60 on the 60 m grid
    (reference: utils/patches.py:222-271; NR_CROP=500, 96/48/16 i.e.
    patch_60=16 — the network is fully convolutional, so smaller crops are
    valid training examples for small scenes)."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    p60_s, p20_s, p10_s = patch_60, 3 * patch_60, 6 * patch_60
    crops = _random_crops(rng, n_crops, d60.shape[:2], p60_s)

    p10 = np.zeros((n_crops, p10_s, p10_s, d10.shape[2]), np.float32)
    pgt = np.zeros((n_crops, p10_s, p10_s, d60_gt.shape[2]), np.float32)
    p20 = np.zeros((n_crops, p20_s, p20_s, d20.shape[2]), np.float32)
    p60 = np.zeros((n_crops, p60_s, p60_s, d60.shape[2]), np.float32)
    for i, (y, x) in enumerate(crops):
        p60[i] = d60[y : y + p60_s, x : x + p60_s]
        p20[i] = d20[3 * y : 3 * y + p20_s, 3 * x : 3 * x + p20_s]
        p10[i] = d10[6 * y : 6 * y + p10_s, 6 * x : 6 * x + p10_s]
        pgt[i] = d60_gt[6 * y : 6 * y + p10_s, 6 * x : 6 * x + p10_s]

    np.save(os.path.join(out_dir, "data10.npy"), _to_chw(p10))
    np.save(os.path.join(out_dir, "data60_gt.npy"), _to_chw(pgt))
    np.save(os.path.join(out_dir, "data20.npy"), _to_chw(interp_patches_host(p20, (p10_s, p10_s))))
    np.save(os.path.join(out_dir, "data60.npy"), _to_chw(interp_patches_host(p60, (p10_s, p10_s))))


def _extract_all_np(img: np.ndarray, grid: PatchGrid) -> np.ndarray:
    from dsen2_tpu_torch.utils.native import pad_extract_host

    return pad_extract_host(img, grid.flat_starts(), grid.patch, grid.border)


def save_test_patches(
    d10: np.ndarray, d20: np.ndarray, out_dir: str, patch_size: int = 128, border: int = 4
) -> None:
    """Deterministic overlapping test-patch archive, 2x path, including the
    reference's zero slack slots (utils/patches.py:159-166)."""
    os.makedirs(out_dir, exist_ok=True)
    g_lr = PatchGrid(d20.shape[0], d20.shape[1], patch_size // 2, border // 2)
    p10 = _extract_all_np(d10, g_lr.scaled(2))
    p20 = interp_patches_host(_extract_all_np(d20, g_lr), (patch_size, patch_size))
    np.save(os.path.join(out_dir, "data10.npy"), _to_chw(pad_patch_slack(p10, g_lr)))
    np.save(os.path.join(out_dir, "data20.npy"), _to_chw(pad_patch_slack(p20, g_lr)))


def save_test_patches60(
    d10: np.ndarray,
    d20: np.ndarray,
    d60: np.ndarray,
    out_dir: str,
    patch_size: int = 192,
    border: int = 12,
) -> None:
    """6x test-patch archive (utils/patches.py:169-178)."""
    os.makedirs(out_dir, exist_ok=True)
    g60 = PatchGrid(d60.shape[0], d60.shape[1], patch_size // 6, border // 6)
    p10 = _extract_all_np(d10, g60.scaled(6))
    p20 = interp_patches_host(_extract_all_np(d20, g60.scaled(3)), (patch_size, patch_size))
    p60 = interp_patches_host(_extract_all_np(d60, g60), (patch_size, patch_size))
    for name, arr in (("data10", p10), ("data20", p20), ("data60", p60)):
        np.save(os.path.join(out_dir, f"{name}.npy"), _to_chw(pad_patch_slack(arr, g60)))


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
            "dsen2_tpu_torch.cli.create_patches --make-val-index --save_prefix "
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


def open_data_files_test_stream(
    path: str, run_60: bool, scale: float, batch_size: int = 8
):
    """Streaming twin of open_data_files_test: the patch archives are
    memmapped and yielded as NHWC/scale batches, so a full-tile archive
    (GBs of patches) never loads whole into RAM. Returns
    (batch generator, image_size (h, w), n_patches, patch_px)."""
    scale = scale or 1
    names = ["data10", "data20"] + (["data60"] if run_60 else [])
    mms = [
        np.load(os.path.join(path, name + ".npy"), mmap_mode="r") for name in names
    ]
    with open(os.path.join(path, "roi.json")) as f:
        roi = json.load(f)
    image_size = [roi[3] - roi[1], roi[2] - roi[0]]
    n = mms[0].shape[0]
    patch_px = int(mms[0].shape[-1])

    def gen():
        for i in range(0, n, batch_size):
            yield [
                _to_hwc(np.asarray(a[i : i + batch_size], np.float32))
                / np.float32(scale)
                for a in mms
            ]

    return gen(), image_size, n, patch_px
