"""Raster output writers: GeoTIFF (any GDAL-creatable format) with npz
fallback — capability match for the writer half of the reference CLI
(testing/s2_tiles_supres.py:350-421).

A copy of dsen2_tpu/io/writers.py, except that the built-in writer's
message tells "GDAL is missing" apart from "GDAL has no GTiff driver" and
"the driver cannot create files" (the original says "GDAL unavailable" for
all three)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["write_bands", "shifted_geotransform", "list_creatable_formats"]


def shifted_geotransform(geot: Sequence[float], xmin: int, ymin: int) -> tuple:
    """Shift a 10 m-grid geotransform's origin to the ROI corner: pixel
    offsets x 10 m (reference: s2_tiles_supres.py:399-403)."""
    g = list(geot)
    g[0] += xmin * 10
    g[3] -= ymin * 10
    return tuple(g)


def list_creatable_formats() -> List[str]:
    """Names of GDAL raster drivers that support creation
    (reference: s2_tiles_supres.py:64-79); without GDAL, the formats the
    built-in writers produce."""
    try:
        from osgeo import gdal
    except ImportError:
        return [
            "GTiff: GeoTIFF / BigTIFF (built-in pure-Python writer) (tif)",
            "npz: compressed numpy archive (fallback) (npz)",
        ]
    out = []
    for i in range(gdal.GetDriverCount()):
        drv = gdal.GetDriver(i)
        if drv is None:
            continue
        md = drv.GetMetadata()
        if md.get(gdal.DCAP_CREATE) == "YES" and md.get(gdal.DCAP_RASTER) == "YES":
            name = drv.GetDescription()
            if "DMD_LONGNAME" in md:
                name += ": " + md["DMD_LONGNAME"]
            if "DMD_EXTENSIONS" in md:
                name += " (" + md["DMD_EXTENSIONS"] + ")"
            out.append(name)
    return out


def write_bands(
    output_file: str,
    bands: List[Tuple[str, np.ndarray]],  # (description, [H,W]) in write order
    output_format: str = "GTiff",
    geotransform: Optional[tuple] = None,
    projection: Optional[str] = None,
) -> str:
    """Write named bands to `output_file`. GTiff output works WITHOUT
    GDAL: the in-tree pure-Python GeoTIFF/BigTIFF writer (io/geotiff.py)
    takes over, so the reference CLI's default format
    (s2_tiles_supres.py:396-413) is produced on GDAL-less hosts too.
    Other formats fall back to a compressed .npz keyed by description
    when their GDAL driver is unavailable (reference:
    s2_tiles_supres.py:350-360,419-420). Returns the format actually
    used."""
    driver = None
    if output_format != "npz":
        try:
            from osgeo import gdal
        except ImportError:
            why = "GDAL unavailable"
        else:
            cand = gdal.GetDriverByName(output_format)
            if cand is None:
                why = f"GDAL has no {output_format} driver"
            elif cand.GetMetadata().get(gdal.DCAP_CREATE) == "YES":
                driver = cand
            else:
                why = f"GDAL's {output_format} driver cannot create files"
        if driver is None and output_format == "GTiff":
            from dsen2_tpu_torch.io.geotiff import write_geotiff

            variant = write_geotiff(
                output_file,
                bands,
                geotransform=geotransform,
                projection_wkt=projection,
            )
            print(f"{why}; wrote {variant} with the built-in writer")
            return variant
        if driver is None:
            print(f"cannot create {output_format} files; writing npz fallback")
            output_format = "npz"

    if output_format == "npz":
        np.savez(output_file, bands={desc: arr for desc, arr in bands})
        return "npz"

    from osgeo import gdal

    h, w = bands[0][1].shape
    ds = driver.Create(output_file, w, h, len(bands), gdal.GDT_Float64)
    if geotransform is not None:
        ds.SetGeoTransform(geotransform)
    if projection is not None:
        ds.SetProjection(projection)
    for i, (desc, arr) in enumerate(bands, start=1):
        band = ds.GetRasterBand(i)
        band.SetDescription(desc)
        band.WriteArray(arr)
    ds.FlushCache()
    return output_format
