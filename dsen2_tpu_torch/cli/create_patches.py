"""Dataset-builder CLI of the port: turn Sentinel-2 tiles into
training/test patch archives using the Wald protocol.

The counterpart of dsen2_tpu/cli/create_patches.py, with the same flags and
archives. Capability match for training/create_patches.py (:19-330): four
output modes (default random training patches, --test_data, --true_data,
--write_images), --run_60, ROI selection snapped to 36 px,
GNU-parallel-friendly (one tile per invocation). Inputs can be SAFE products
(via GDAL, or GDAL-free through the Pillow JP2 backend, data/safe_pil.py) or
.mat demo scenes, plus .npz files with im10/im20/im60. The Wald downsample
runs on the device (ops/resize.py::wald_downsample); the archives are
written on the host.

Usage:
  python -m dsen2_tpu_torch.cli.create_patches DATA_FILE [--roi_x_y ...]
      [--test_data] [--true_data] [--write_images] [--run_60]
      [--save_prefix ../data/] [--seed N]
  python -m dsen2_tpu_torch.cli.create_patches --make-val-index
      [--save_prefix ../data/] [--run_60] [--val-fraction 0.1] [--seed N]

The second form is the training/create_random.py (:10-22) equivalent: it
scans the already-built data/train[60]/*SAFE archives, counts the patch
slots, and persists the ~10%-True boolean validation mask as
data/train[60]/val_index.npy (the loader requires it; regenerate whenever
tiles are added/removed or patch counts change).

It runs on the GPU; main(argv, device="cpu") runs the plain versions on the
CPU."""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _crop_to_grid(d10, d20, d60, grid: int):
    """Crop HWC rasters to a `grid`-pixel multiple on the 10m axis so the
    Wald downsample divides evenly (the SAFE path gets this for free from
    ROI snapping; .mat/.npz scenes need it explicitly)."""
    h = d10.shape[0] // grid * grid
    w = d10.shape[1] // grid * grid
    d10 = d10[:h, :w]
    d20 = d20[: h // 2, : w // 2]
    if d60 is not None:
        d60 = d60[: h // 6, : w // 6]
    return d10, d20, d60


def _load_input(data_file: str, roi_x_y, run_60: bool):
    """Returns (data10, data20, data60, roi_tuple_10m, tile_name)."""
    if data_file.endswith(".mat") or data_file.endswith(".npz"):
        if data_file.endswith(".mat"):
            from dsen2_tpu_torch.data.mat import read_scene

            scene = read_scene(data_file)
        else:
            scene = dict(np.load(data_file))
        d10, d20 = scene["im10"], scene["im20"]
        d60 = scene.get("im60")
        name = os.path.splitext(os.path.basename(data_file))[0] + ".SAFE"
        d10, d20, d60 = _crop_to_grid(d10, d20, d60, 36)
        roi = (0, 0, d10.shape[1], d10.shape[0])
        return d10, d20, d60, roi, name

    from dsen2_tpu_torch.data.safe_reader import read_safe

    xml = data_file
    if os.path.isdir(data_file):
        xml = os.path.join(data_file, "MTD_MSIL1C.xml")
    tile = read_safe(xml, roi_x_y=roi_x_y, run_60=run_60, snap_grid=36)
    name = os.path.basename(data_file.rstrip("/"))
    roi = (tile.roi.xmin, tile.roi.ymin, tile.roi.xmax + 1, tile.roi.ymax + 1)
    return tile.data10, tile.data20, tile.data60, roi, name


def _save_band_png(path: str, data: np.ndarray) -> None:
    """Percentile-stretched PNG (reference: create_patches.py:200-206)."""
    try:
        import imageio
    except ImportError:
        return
    from dsen2_tpu_torch.ops.resize import convert_double_to_byte

    mi, ma = np.percentile(data, (1, 99))
    img = (np.clip(data, mi, ma) - mi) / max(ma - mi, 1e-9)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    imageio.imsave(path, convert_double_to_byte(img))


def _make_val_index_cli(args) -> int:
    """Scan data/train[60]/*SAFE archives and persist the validation mask
    (reference: training/create_random.py:10-22, which hardcodes 45*8000
    slots; here the count is read from the archives themselves so partial
    tile sets and non-default crop counts split correctly)."""
    import glob

    from dsen2_tpu_torch.data.patches_dataset import make_val_index

    train_path = os.path.join(args.save_prefix, "train60" if args.run_60 else "train")
    dsets = sorted(glob.glob(os.path.join(train_path, "*SAFE")))
    if not dsets:
        print(f"no *SAFE tile dirs under {train_path}; build training "
              "patches first", file=sys.stderr)
        return 1
    total = 0
    for d in dsets:
        arr = np.load(os.path.join(d, "data10.npy"), mmap_mode="r")
        total += arr.shape[0]
        print(f"{os.path.basename(d)}: {arr.shape[0]} patch slots")
    seed = 0 if args.seed is None else args.seed
    mask = make_val_index(total, args.val_fraction, seed=seed)
    out = os.path.join(train_path, "val_index.npy")
    np.save(out, mask)
    print(f"wrote {out}: {int(mask.sum())}/{total} validation slots "
          f"({args.val_fraction:.0%}, seed {seed})")
    return 0


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(
        description="Create DSen2 training/test patches from Sentinel-2 data "
        "(Wald protocol).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    ap.add_argument("data_file", nargs="?", default=None,
                    help="SAFE dir / MTD_MSIL1C.xml / .mat / .npz")
    ap.add_argument("--roi_x_y", default="", help="x1,y1,x2,y2 on the 10m grid")
    ap.add_argument("--test_data", action="store_true")
    ap.add_argument("--true_data", action="store_true")
    ap.add_argument("--write_images", action="store_true")
    ap.add_argument("--run_60", action="store_true")
    ap.add_argument("--save_prefix", default="../data/")
    ap.add_argument("--seed", type=int, default=None, help="crop RNG seed")
    ap.add_argument("--make-val-index", action="store_true",
                    help="write data/train[60]/val_index.npy from the built "
                    "archives (create_random.py equivalent) and exit")
    ap.add_argument("--val-fraction", type=float, default=0.1,
                    help="fraction of patch slots marked validation")
    args = ap.parse_args(argv)

    if args.make_val_index:
        return _make_val_index_cli(args)
    if args.data_file is None:
        ap.error("data_file is required (or pass --make-val-index)")

    from dsen2_tpu_torch.core.device import resolve_device, upload

    dev = resolve_device(device)
    roi_x_y = None
    if args.roi_x_y:
        roi_x_y = tuple(float(x) for x in args.roi_x_y.split(","))

    d10, d20, d60, roi, name = _load_input(args.data_file, roi_x_y, args.run_60)
    if args.run_60 and d60 is None:
        print("--run_60 requires 60m bands in the input", file=sys.stderr)
        return 1

    blank = np.sum(d10[:, :, 0] < 1)
    if blank > 0:
        print("The selected image has some blank pixels")

    from dsen2_tpu_torch.data.patches_dataset import (
        save_random_patches,
        save_random_patches60,
        save_test_patches,
        save_test_patches60,
    )
    from dsen2_tpu_torch.ops.resize import wald_downsample

    def wald(img, f):
        return wald_downsample(upload(np.asarray(img, np.float32), dev), f).cpu().numpy()

    scale = 6 if args.run_60 else 2
    if not args.true_data:
        d10_lr = wald(d10, scale)
        d20_lr = wald(d20, scale)
        d60_lr = wald(d60, scale) if (args.run_60 and d60 is not None) else None

    prefix = args.save_prefix

    def fit_patch(patch_hr: int, border_hr: int, coarse_factor: int, n_coarse: int) -> int:
        """Shrink the HR patch size (multiples of 6) until the coarse-grid
        interior fits the image; the reference geometry assumes full tiles."""
        p = patch_hr
        while p // coarse_factor - 2 * (border_hr // coarse_factor) > n_coarse and p > 6 * coarse_factor:
            p -= 6
        if p != patch_hr:
            print(f"image too small for patch {patch_hr}; using {p}")
        return p

    if args.test_data:
        sub = "test60" if args.run_60 else "test"
        out = os.path.join(prefix, sub, name)
        os.makedirs(out, exist_ok=True)
        print(f"Writing files for testing to: {out}")
        if args.run_60:
            p = fit_patch(192, 12, 6, min(d60_lr.shape[:2]))
            save_test_patches60(d10_lr, d20_lr, d60_lr, out, patch_size=p)
            roi_s = [c // scale for c in roi]
        else:
            p = fit_patch(128, 4, 2, min(d20_lr.shape[:2]))
            save_test_patches(d10_lr, d20_lr, out, patch_size=p)
            roi_s = [c // scale for c in roi]
        with open(os.path.join(out, "roi.json"), "w") as f:
            json.dump([roi_s[0], roi_s[1], roi_s[2], roi_s[3]], f)
        nt = os.path.join(out, "no_tiling")
        os.makedirs(nt, exist_ok=True)
        if args.run_60:
            np.save(os.path.join(nt, "data60_gt.npy"), d60.astype(np.float32))
            np.save(os.path.join(nt, "data60.npy"), d60_lr.astype(np.float32))
        else:
            np.save(os.path.join(nt, "data20_gt.npy"), d20.astype(np.float32))
        np.save(os.path.join(nt, "data10.npy"), d10_lr.astype(np.float32))
        np.save(os.path.join(nt, "data20.npy"), d20_lr.astype(np.float32))
    elif args.write_images:
        _save_band_png(os.path.join(prefix, "raw", "rgbs", name + "RGB.png"), d10_lr[:, :, 0:3])
        _save_band_png(os.path.join(prefix, "raw", "rgbs", name + "RGB20.png"), d20_lr[:, :, 0:3])
    elif args.true_data:
        out = os.path.join(prefix, "true", name)
        os.makedirs(out, exist_ok=True)
        print(f"Writing true-scale files to: {out}")
        save_test_patches60(d10, d20, d60, out, patch_size=384, border=12)
        with open(os.path.join(out, "roi.json"), "w") as f:
            json.dump(list(roi), f)
        nt = os.path.join(out, "no_tiling")
        os.makedirs(nt, exist_ok=True)
        for nm, arr in (("data10", d10), ("data20", d20), ("data60", d60)):
            np.save(os.path.join(nt, nm + ".npy"), arr.astype(np.float32))
    else:
        sub = "train60" if args.run_60 else "train"
        out = os.path.join(prefix, sub, name)
        os.makedirs(out, exist_ok=True)
        print(f"Writing files for training to: {out}")
        if args.run_60:
            save_random_patches60(d60, d10_lr, d20_lr, d60_lr, out, seed=args.seed)
        else:
            save_random_patches(d20, d10_lr, d20_lr, out, seed=args.seed)

    print("Success.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
