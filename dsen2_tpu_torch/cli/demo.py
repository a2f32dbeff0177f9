"""Demo / accuracy harness CLI of the port.

The counterpart of dsen2_tpu/cli/demo.py, on dsen2_tpu_torch's dsen2_20 /
dsen2_60, resizers and metrics. Capability match for testing/demoDSen2.py:
run DSen2 on demo scenes, report RMSE vs the MATLAB-bicubic baseline, save
visualisations. The reference
compares against pre-simulated ground truth shipped in GT-bearing scenes;
those are missing LFS blobs in this snapshot, so this harness can also
synthesise the Wald-protocol simulation on the fly (downsample the bundled
scene with the reference's Gaussian+mean-pool pipeline, super-resolve the
simulated inputs, and evaluate against the original as GT) — the same
protocol the reference uses to create its GT scenes
(training/create_patches.py:220-230).

Plots need matplotlib and are skipped without it.

Usage:
  python -m dsen2_tpu_torch.cli.demo [--data-dir DIR] [--deep] [--no-plots]
                                     [--weights-dir DIR] [--out-dir DIR]
                                     [--ensemble]

It runs on the GPU; run_scene(..., device="cpu") runs the plain versions.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np
import torch

from dsen2_tpu_torch.core.device import resolve_device
from dsen2_tpu_torch.infer.metrics import rmse as _rmse
from dsen2_tpu_torch.infer.metrics import sre_db as sre


def rmse(x1: np.ndarray, x2: np.ndarray) -> float:
    """Print-and-return RMSE like the reference demo
    (testing/demoDSen2.py:31-35); the math lives in infer.metrics."""
    val = _rmse(x1, x2)
    print(f"RMSE: {val:.4f}")
    return val


def _resized(fn, img: np.ndarray, arg, device) -> np.ndarray:
    """fn (matlab_imresize or wald_downsample) of a host raster, computed on
    `device`, back on the host."""
    return fn(torch.from_numpy(np.ascontiguousarray(img)).to(device), arg).cpu().numpy()


def _save_fig(path, arrays_titles):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig, axes = plt.subplots(1, len(arrays_titles), figsize=(6 * len(arrays_titles), 5))
    if len(arrays_titles) == 1:
        axes = [axes]
    for ax, (arr, title) in zip(axes, arrays_titles):
        im = ax.imshow(arr)
        ax.set_title(title)
        fig.colorbar(im, ax=ax)
    fig.savefig(path, dpi=90, bbox_inches="tight")
    plt.close(fig)


def _stretch_pair(sr_comp: np.ndarray, in_comp: np.ndarray):
    """Per-channel 1-99 percentile stretch for visualisation; limits come
    from the SR composite and are applied to both images, like the
    reference demo (testing/demoDSen2.py:131-137,150-157)."""
    out_s = np.empty(sr_comp.shape, np.float32)
    out_i = np.empty(in_comp.shape, np.float32)
    for i in range(sr_comp.shape[2]):
        a, b = np.percentile(sr_comp[:, :, i], (1, 99))
        span = max(b - a, 1e-9)
        out_s[..., i] = (np.clip(sr_comp[..., i], a, b) - a) / span
        out_i[..., i] = (np.clip(in_comp[..., i], a, b) - a) / span
    return out_s, out_i


def _save_rgb_fig(path, panels):
    """panels: list of (rgb image in [0,1], title). Side-by-side panels like
    the reference's figures 6/7 (testing/demoDSen2.py:141-165)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig, axes = plt.subplots(1, len(panels), figsize=(6 * len(panels), 6))
    if len(panels) == 1:
        axes = [axes]
    for ax, (img, title) in zip(axes, panels):
        ax.imshow(img)
        ax.set_title(title)
        ax.set_axis_off()
    fig.savefig(path, dpi=90, bbox_inches="tight")
    plt.close(fig)


def run_scene(path: str, deep: bool, plots: bool, out_dir: str,
              ensemble: bool = False, device=None) -> dict:
    """Super-resolve one scene and print its RMSE tables; runs on "cuda"
    unless `device` says otherwise."""
    from dsen2_tpu_torch.data.mat import read_scene
    from dsen2_tpu_torch.infer.api import dsen2_20, dsen2_60
    from dsen2_tpu_torch.ops.resize import matlab_imresize, wald_downsample

    dev = resolve_device(device)

    name = os.path.splitext(os.path.basename(path))[0]
    scene = read_scene(path)
    results = {"scene": name}
    print(f"\n=== {name} ===")

    im10, im20 = scene["im10"], scene["im20"]
    im60 = scene.get("im60")
    gt20 = scene.get("imGT")

    if gt20 is not None and gt20.shape[-1] == 2:
        # 60m-GT scene (reference demo's South-Africa style: imGT has the
        # two 60m bands at 10m; testing/demoDSen2.py:67-73)
        sr60 = dsen2_60(im10, im20, im60, deep=deep, ensemble=ensemble, device=dev)
        bic60 = _resized(matlab_imresize, im60, im10.shape[:2], dev)
        print("DSen2_60:")
        results["rmse_dsen2_60"] = rmse(sr60, gt20)
        print("Bicubic 6x:")
        results["rmse_bicubic_60"] = rmse(bic60, gt20)
        return results
    in20_vis = im20  # 20m input shown in the RGB comparison panels
    rgb60 = None
    if gt20 is not None:
        # Pre-simulated scene (reference demo style): inputs are already LR.
        sr20 = dsen2_20(im10, im20, deep=deep, ensemble=ensemble, device=dev)
        bic = _resized(matlab_imresize, im20, im10.shape[:2], dev)
        print("DSen2:")
        results["rmse_dsen2_20"] = rmse(sr20, gt20)
        print("Bicubic:")
        results["rmse_bicubic_20"] = rmse(bic, gt20)
        results["sre_dsen2_20"] = sre(sr20, gt20)
    else:
        # Wald-protocol simulation on the fly (same math as
        # training/create_patches.py:227-229): original 20m becomes GT.
        d10_lr = _resized(wald_downsample, im10, 2, dev)
        d20_lr = _resized(wald_downsample, im20, 2, dev)
        sr20 = dsen2_20(d10_lr, d20_lr, deep=deep, ensemble=ensemble, device=dev)
        in20_vis = d20_lr
        bic = _resized(matlab_imresize, d20_lr, im20.shape[:2], dev)
        print("DSen2 (simulated GT):")
        results["rmse_dsen2_20"] = rmse(sr20, im20)
        print("Bicubic:")
        results["rmse_bicubic_20"] = rmse(bic, im20)
        results["sre_dsen2_20"] = sre(sr20, im20)
        from dsen2_tpu_torch.core.bands import BANDS_20M
        from dsen2_tpu_torch.infer.metrics import evaluation_table

        print(evaluation_table(sr20, im20, bic, BANDS_20M, scale=2))
        gt20 = im20

        if im60 is not None:
            # Crop to a 36-px multiple on the 10m grid so the x6 Wald
            # downsample divides evenly (the reference guarantees this via
            # its 36-px ROI snapping, create_patches.py:68-71).
            h36 = im10.shape[0] // 36 * 36
            w36 = im10.shape[1] // 36 * 36
            c10 = im10[:h36, :w36]
            c20 = im20[: h36 // 2, : w36 // 2]
            c60 = im60[: h36 // 6, : w36 // 6]
            d10_lr6 = _resized(wald_downsample, c10, 6, dev)
            d20_lr6 = _resized(wald_downsample, c20, 6, dev)
            d60_lr6 = _resized(wald_downsample, c60, 6, dev)
            # Default geometry is 192/12 (testing/supres.py:40-41); for small
            # simulated scenes shrink the patch so at least one fits.
            from dsen2_tpu_torch.core.config import InferConfig

            patch = 192
            while patch // 6 - 4 > min(d60_lr6.shape[:2]) and patch > 36:
                patch -= 36
            icfg60 = InferConfig(patch_size=patch, border=12, batch_size=32)
            sr60 = dsen2_60(d10_lr6, d20_lr6, d60_lr6, deep=deep, infer_cfg=icfg60,
                            ensemble=ensemble, device=dev)
            rgb60 = (sr60, d60_lr6)
            bic60 = _resized(matlab_imresize, d60_lr6, c60.shape[:2], dev)
            print("DSen2_60 (simulated GT):")
            results["rmse_dsen2_60"] = rmse(sr60, c60)
            print("Bicubic 6x:")
            results["rmse_bicubic_60"] = rmse(bic60, c60)
            from dsen2_tpu_torch.core.bands import BANDS_60M

            print(evaluation_table(sr60, c60, bic60, BANDS_60M, scale=6))

    if plots:
        os.makedirs(out_dir, exist_ok=True)
        _save_fig(
            os.path.join(out_dir, f"{name}_b6.png"),
            [
                (gt20[:, :, 1], "GT band B6"),
                (sr20[:, :, 1], "Super-resolved B6"),
                (np.abs(sr20[:, :, 1] - gt20[:, :, 1]), "abs diff"),
            ],
        )
        # Percentile-stretched RGB comparison views, reference figures 6/7
        # (testing/demoDSen2.py:131-165): SWIR composite for the 2x net,
        # (B1,B9,B1) for the 6x net.
        comp_s, comp_i = _stretch_pair(
            sr20[:, :, [5, 3, 0]], in20_vis[:, :, [5, 3, 0]]
        )
        _save_rgb_fig(
            os.path.join(out_dir, f"{name}_rgb20.png"),
            [(comp_i, "Color composite (B12,B8a,B5)\n20m input"),
             (comp_s, "Color composite (B12,B8a,B5)\n10m super-resolution")],
        )
        if rgb60 is not None:
            sr60_vis, in60_vis = rgb60
            comp_s, comp_i = _stretch_pair(
                sr60_vis[:, :, [0, 1, 0]], in60_vis[:, :, [0, 1, 0]]
            )
            _save_rgb_fig(
                os.path.join(out_dir, f"{name}_rgb60.png"),
                [(comp_i, "Color composite (B1,B9,B1)\n60m input"),
                 (comp_s, "Color composite (B1,B9,B1)\n10m super-resolution")],
            )
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="DSen2 demo / accuracy harness")
    ap.add_argument("--data-dir", default="data")
    ap.add_argument("--deep", action="store_true", help="use VDSen2 (32x256)")
    ap.add_argument("--no-plots", action="store_true")
    ap.add_argument("--out-dir", default="demo_out")
    ap.add_argument("--weights-dir", default=None)
    ap.add_argument("--ensemble", action="store_true",
                    help="geometric self-ensemble over the 8 dihedral "
                         "transforms (8x compute; boosts accuracy for "
                         "orientation-robust weights)")
    args = ap.parse_args(argv)

    if args.weights_dir:
        os.environ["DSEN2_TPU_WEIGHTS_DIR"] = args.weights_dir

    scenes = sorted(glob.glob(os.path.join(args.data_dir, "*.mat")))
    if not scenes:
        print(f"no .mat scenes found in {args.data_dir}", file=sys.stderr)
        return 1
    all_results = []
    for path in scenes:
        all_results.append(run_scene(path, args.deep, not args.no_plots, args.out_dir,
                                     ensemble=args.ensemble))

    print("\n=== summary ===")
    for r in all_results:
        parts = [r["scene"]]
        for k in ("rmse_dsen2_20", "rmse_bicubic_20", "rmse_dsen2_60", "rmse_bicubic_60"):
            if k in r:
                parts.append(f"{k}={r[k]:.2f}")
        print("  ".join(parts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
