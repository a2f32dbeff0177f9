"""Full-tile production inference CLI of the port.

The counterpart of dsen2_tpu/cli/s2_supres.py, with the same flags and the
same printed lines. Flag-for-flag capability match with the reference CLI
(testing/s2_tiles_supres.py:14-61): read a SAFE product (or the
MTD_MSIL1C.xml inside it), select ROI/UTM/bands, run the 6x then the 2x
network, and write a georeferenced output (GTiff by default, npz fallback).

Usage:
  python -m dsen2_tpu_torch.cli.s2_supres DATA_FILE [OUTPUT_FILE]
      [--roi_lon_lat ...] [--roi_x_y ...] [--list_bands] [--run_60]
      [--list_UTM] [--select_UTM Z] [--list_output_file_formats]
      [--output_file_format GTiff] [--copy_original_bands] [--save_prefix P]
      [--deep] [--output-dtype float32|uint16|bfloat16] [--ensemble]

It runs on the GPU; main(argv, device="cpu") runs the plain versions on the
CPU. --mesh N with N > 1 shards the tile's patch grid over N GPUs
(make_mesh(data=N), which needs N visible GPUs), or with device="cpu" over
N repeats of the CPU.
"""

from __future__ import annotations

import argparse
import os
import re
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Perform super-resolution of Sentinel-2 products with the "
        "DSen2 PyTorch/CUDA port.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("data_file", help="SAFE ZIP or the MTD_MSIL1C.xml inside a SAFE dir.")
    p.add_argument("output_file", nargs="?", help="target raster file")
    p.add_argument("--roi_lon_lat", default="", help="lon_1,lat_1,lon_2,lat_2 (WGS84)")
    p.add_argument("--roi_x_y", default="", help="x_1,y_1,x_2,y_2 on the 10m grid")
    p.add_argument("--list_bands", action="store_true")
    p.add_argument("--run_60", action="store_true",
                   help="also super-resolve the 60m bands (B1, B9)")
    p.add_argument("--list_UTM", action="store_true")
    p.add_argument("--select_UTM", default="")
    p.add_argument("--list_output_file_formats", action="store_true")
    p.add_argument("--output_file_format", default="GTiff")
    p.add_argument("--copy_original_bands", action="store_true")
    p.add_argument("--save_prefix", default="")
    p.add_argument("--deep", action="store_true", help="use the VDSen2 variant")
    p.add_argument("--output-dtype", default="float32",
                   choices=("float32", "uint16", "bfloat16"),
                   help="SR readback dtype: uint16 = rounded integer "
                   "reflectance at half the device->host bytes (the "
                   "reference writer quantizes anyway, "
                   "s2_tiles_supres.py:397); float32 is the parity default")
    p.add_argument("--ensemble", action="store_true",
                   help="geometric self-ensemble over the 8 dihedral transforms "
                        "(8x compute; boosts accuracy for orientation-robust "
                        "weights). Runs device-resident: one averaged readback, "
                        "and --output-dtype quantizes only the final mean")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="shard the tile's patch grid over N GPUs; 0 or 1 runs "
                        "on one device")
    return p


def main(argv=None, device=None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_output_file_formats:
        from dsen2_tpu_torch.io.writers import list_creatable_formats

        for name in list_creatable_formats():
            print(name)
        return 0

    from dsen2_tpu_torch.data.safe_reader import scan_utm_zones

    roi_x_y = tuple(float(x) for x in re.split(",", args.roi_x_y)) if args.roi_x_y else None
    roi_lon_lat = (
        tuple(float(x) for x in re.split(",", args.roi_lon_lat)) if args.roi_lon_lat else None
    )

    if args.list_UTM:
        # Metadata-only scan: no raster reads, and an empty ROI/zone
        # combination still lists zones (reference: s2_tiles_supres.py:186-190).
        print("List of UTM zones (with ROI coverage in pixels):")
        for zone, area in scan_utm_zones(
            args.data_file, roi_x_y=roi_x_y, roi_lon_lat=roi_lon_lat
        ).items():
            print(f"{zone} ({area})")
        return 0

    from dsen2_tpu_torch.core.device import resolve_device

    # Listing bands needs no device; super-resolution runs on "cuda" unless
    # told otherwise, and fails before the product is read if there is none.
    dev = None if args.list_bands else resolve_device(device)
    mesh = None
    if dev is not None and args.mesh > 1:
        from dsen2_tpu_torch.parallel import make_mesh

        # Over the visible GPUs, or N repeats of the device the caller named.
        mesh = make_mesh(None if device is None else [dev] * args.mesh, data=args.mesh)
        dev = None

    from dsen2_tpu_torch.utils import profiling

    with profiling.span("s2_supres.main"):
        return _supres(args, roi_x_y, roi_lon_lat, dev, mesh)


def _supres(args, roi_x_y, roi_lon_lat, dev, mesh) -> int:
    """main's work from the product's read to the written output, in the
    spans s2_supres.read, s2_supres.sr (net=6x, then 2x), s2_supres.assemble
    and s2_supres.write."""
    import numpy as np

    from dsen2_tpu_torch.data.safe_reader import read_safe
    from dsen2_tpu_torch.io.writers import shifted_geotransform, write_bands
    from dsen2_tpu_torch.utils import profiling

    with profiling.span("s2_supres.read"):
        tile = read_safe(
            args.data_file,
            roi_x_y=roi_x_y,
            roi_lon_lat=roi_lon_lat,
            run_60=args.run_60,
            select_utm_zone=args.select_UTM,
            output_format=args.output_file_format,
        )

    print(f"Selected UTM Zone: {tile.utm}")
    print(
        f"Selected pixel region: xmin={tile.roi.xmin}, ymin={tile.roi.ymin}, "
        f"xmax={tile.roi.xmax}, ymax={tile.roi.ymax}"
    )
    print(f"Image size: width={tile.roi.width} x height={tile.roi.height}")

    if args.list_bands:
        for label, bands in (("10m", tile.bands10), ("20m", tile.bands20), ("60m", tile.bands60)):
            print(f"\n{label} bands:")
            for b in bands:
                print("- " + b.description)
        return 0

    output_file = args.output_file
    if not output_file:
        print("Error: you must provide the name of an output file. Using input name...")
        output_file = os.path.split(args.data_file)[1] + ".tif"
    output_file = args.save_prefix + output_file
    if args.output_file_format == "ENVI" and output_file[-4:].lower() == ".hdr":
        output_file = output_file[:-4] + ".bin"

    from dsen2_tpu_torch.core.config import InferConfig
    from dsen2_tpu_torch.infer.api import dsen2_20, dsen2_60

    icfg2 = InferConfig(patch_size=128, border=8, output_dtype=args.output_dtype)
    icfg6 = InferConfig(patch_size=192, border=12, output_dtype=args.output_dtype)

    if mesh is not None:
        print(f"Sharding the patch grid over {args.mesh} devices")

    sr60 = None
    if args.run_60 and tile.data60 is not None and tile.data20 is not None:
        print("Super-resolving the 60m data into 10m bands")
        with profiling.span("s2_supres.sr", net="6x"):
            sr60 = dsen2_60(tile.data10, tile.data20, tile.data60, deep=args.deep,
                            ensemble=args.ensemble, infer_cfg=icfg6, device=dev, mesh=mesh)

    sr20 = None
    if tile.data20 is not None:
        print("Super-resolving the 20m data into 10m bands")
        with profiling.span("s2_supres.sr", net="2x"):
            sr20 = dsen2_20(tile.data10, tile.data20, deep=args.deep,
                            ensemble=args.ensemble, infer_cfg=icfg2, device=dev, mesh=mesh)

    if sr20 is None:
        print("No super-resolution performed, exiting")
        return 0

    with profiling.span("s2_supres.assemble"):
        if args.output_dtype == "bfloat16":
            # bf16 is a readback-wire format; writers (GDAL/npz) get float32.
            sr20 = sr20.astype(np.float32)
            sr60 = sr60.astype(np.float32) if sr60 is not None else None

        if sr60 is not None:
            sr = np.concatenate((sr20, sr60), axis=2)
            sr_bands = tile.bands20 + tile.bands60
        else:
            sr = sr20
            sr_bands = tile.bands20

        bands = []
        if args.copy_original_bands:
            for i, b in enumerate(tile.bands10):
                bands.append((b.description, tile.data10[:, :, i]))
        for i, b in enumerate(sr_bands):
            bands.append(("SR" + b.description, sr[:, :, i]))

        geot = (
            shifted_geotransform(tile.geotransform, tile.roi.xmin, tile.roi.ymin)
            if tile.geotransform
            else None
        )
    with profiling.span("s2_supres.write"):
        fmt = write_bands(
            output_file, bands, args.output_file_format, geot, tile.projection
        )
    print(f"Wrote {len(bands)} bands to {output_file} ({fmt})")
    for desc, _ in bands:
        print(desc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
