"""Sentinel-2 SAFE / MTD_MSIL1C.xml tile ingestion.

Capability match for the GDAL reader halves of the reference
(testing/s2_tiles_supres.py:97-330 and its near-duplicate in
training/create_patches.py:32-196), redesigned as an importable, testable
API instead of script-level globals:

  - pure logic (ROI snapping, UTM-zone selection by coverage, band
    validation, read-window math) lives in plain functions operating on
    light dataclasses -> unit-testable without GDAL
  - GDAL itself is an optional dependency, imported lazily; environments
    without it (like this one) still get every non-SAFE path of the
    framework and a clear error message here

Geo I/O is inherently host work: the reader feeds host numpy arrays into
the device pipeline (SURVEY.md §2.3).

A copy of dsen2_tpu/data/safe_reader.py on the port's safe_pil, geo and io
modules (tests/test_torch_safe.py holds its reads equal to the original's).
"""

from __future__ import annotations

import dataclasses
import re
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "BandInfo",
    "SubdatasetInfo",
    "Roi",
    "TileData",
    "snap_roi_to_grid",
    "classify_subdatasets",
    "select_utm",
    "validate_bands",
    "read_safe",
    "have_gdal",
]


def have_gdal() -> bool:
    try:
        from osgeo import gdal  # noqa: F401

        return True
    except ImportError:
        return False


def _backend(data_file: str, what: str):
    """The raster backend for one product: real GDAL when importable,
    else the Pillow JPEG-2000 SAFE backend (data/safe_pil.py — same
    dataset duck type, so every downstream step is shared). Raises the
    historical ImportError when neither can read `data_file`."""
    try:
        from osgeo import gdal

        return gdal
    except ImportError as e:
        from dsen2_tpu_torch.data import safe_pil

        if safe_pil.looks_like_safe(data_file):
            if not safe_pil.available():
                raise ImportError(
                    f"{what} requires GDAL (osgeo) or Pillow with "
                    "JPEG-2000 support; neither is available"
                ) from e
            return safe_pil.open_product(data_file)[0]
        raise ImportError(
            f"{what} requires GDAL (osgeo); this environment does not "
            "provide it, and the path is not a SAFE-layout product the "
            "built-in Pillow backend could read. Use the .mat/.npy "
            "ingestion paths instead."
        ) from e


@dataclasses.dataclass(frozen=True)
class SubdatasetInfo:
    name: str  # GDAL subdataset name (openable)
    description: str  # contains "NNm resolution" and the UTM zone


@dataclasses.dataclass(frozen=True)
class BandInfo:
    index: int  # 0-based band index within its subdataset
    shortname: str  # e.g. "B8A"
    description: str  # validated long description


@dataclasses.dataclass(frozen=True)
class Roi:
    """Pixel ROI on the 10 m grid, inclusive bounds like the reference."""

    xmin: int
    ymin: int
    xmax: int
    ymax: int

    @property
    def width(self) -> int:
        return self.xmax - self.xmin + 1

    @property
    def height(self) -> int:
        return self.ymax - self.ymin + 1

    @property
    def empty(self) -> bool:
        return self.xmax < self.xmin or self.ymax < self.ymin


@dataclasses.dataclass
class TileData:
    """The loaded ROI: HWC float arrays + georeferencing for the writer."""

    data10: np.ndarray
    data20: Optional[np.ndarray]
    data60: Optional[np.ndarray]
    bands10: List[BandInfo]
    bands20: List[BandInfo]
    bands60: List[BandInfo]
    roi: Roi
    geotransform: Optional[tuple]
    projection: Optional[str]
    descriptions: Dict[str, str]
    utm: str = ""
    utm_coverage: Dict[str, int] = dataclasses.field(default_factory=dict)


def snap_roi_to_grid(
    x1: float, y1: float, x2: float, y2: float, xsize: int, ysize: int, grid: int = 6
) -> Roi:
    """Clamp an arbitrary pixel ROI to the raster and enlarge it outward to
    `grid`-pixel boundaries so the 10/20/60 m rasters stay aligned
    (reference: s2_tiles_supres.py:126-134 with grid=6;
    create_patches.py:63-71 with grid=36)."""
    xmin = max(min(x1, x2, xsize - 1), 0)
    xmax = min(max(x1, x2, 0), xsize - 1)
    ymin = max(min(y1, y2, ysize - 1), 0)
    ymax = min(max(y1, y2, 0), ysize - 1)
    return Roi(
        xmin=int(xmin / grid) * grid,
        xmax=int((xmax + 1) / grid) * grid - 1,
        ymin=int(ymin / grid) * grid,
        ymax=int((ymax + 1) / grid) * grid - 1,
    )


def classify_subdatasets(
    subdatasets: Sequence[Tuple[str, str]],
) -> Dict[str, List[SubdatasetInfo]]:
    """Split GDAL subdatasets by resolution keyword in their description
    (reference: s2_tiles_supres.py:100-113)."""
    out: Dict[str, List[SubdatasetInfo]] = {"10m": [], "20m": [], "60m": [], "unknown": []}
    for name, desc in subdatasets:
        if "10m resolution" in desc:
            out["10m"].append(SubdatasetInfo(name, desc))
        elif "20m resolution" in desc:
            out["20m"].append(SubdatasetInfo(name, desc))
        elif "60m resolution" in desc:
            out["60m"].append(SubdatasetInfo(name, desc))
        else:
            out["unknown"].append(SubdatasetInfo(name, desc))
    return out


def utm_of(description: str) -> str:
    return description[description.find("UTM") :]


def select_utm(
    candidates: Sequence[Tuple[SubdatasetInfo, Roi]],
    requested: str = "",
) -> Tuple[int, str, Roi, Dict[str, int]]:
    """Pick the UTM zone: the requested one, else the zone whose dataset
    covers the largest ROI area (reference: s2_tiles_supres.py:115-190).
    Returns (index, utm, roi, {utm: coverage})."""
    coverage: Dict[str, int] = defaultdict(int)
    best_idx, best_utm, best_roi, best_area = 0, "", Roi(0, 0, -1, -1), -1
    req: Optional[Tuple[int, str, Roi]] = None
    for idx, (info, roi) in enumerate(candidates):
        area = roi.width * roi.height if not roi.empty else 0
        zone = utm_of(info.description)
        coverage[zone] = max(coverage[zone], area)
        if requested and zone == requested and req is None:
            req = (idx, zone, roi)
        if area > best_area:
            best_idx, best_utm, best_roi, best_area = idx, zone, roi, area
    if req is not None:
        return req[0], req[1], req[2], dict(coverage)
    return best_idx, best_utm, best_roi, dict(coverage)


def validate_description(description: str, output_format: str = "GTiff") -> str:
    """Normalise a band description (reference: s2_tiles_supres.py:223-231):
    'B4, central wavelength 665 nm' -> 'B4 (665 nm)'; strip commas for ENVI."""
    m = re.match(r"(.*?), central wavelength (\d+) nm", description)
    if m:
        return f"{m.group(1)} ({m.group(2)} nm)"
    if output_format == "ENVI" and "," in description:
        pos = description.find(",")
        return description[:pos] + description[pos + 1 :]
    return description


def band_short_name(description: str) -> str:
    """(reference: s2_tiles_supres.py:247-252)"""
    for sep in (",", " "):
        if sep in description:
            return description[: description.find(sep)]
    return description[:3]


def validate_bands(
    descriptions: Sequence[str], wanted: Sequence[str], output_format: str = "GTiff"
) -> List[BandInfo]:
    """Match a subdataset's band descriptions against the selection list,
    preserving dataset order (reference: s2_tiles_supres.py:255-293)."""
    remaining = list(wanted)
    out = []
    for idx, desc in enumerate(descriptions):
        v = validate_description(desc, output_format)
        short = band_short_name(v)
        if short in remaining:
            remaining.remove(short)
            out.append(BandInfo(index=idx, shortname=short, description=v))
    return out


def _lonlat_to_pixel(ds, lon1, lat1, lon2, lat2) -> Tuple[float, float, float, float]:
    """WGS84 lon/lat corners -> pixel coords via the dataset CRS + inverse
    geotransform (reference: s2_tiles_supres.py:141-161). Projection via
    OSR when GDAL is present; otherwise the built-in UTM transverse
    Mercator (dsen2_tpu_torch/geo/utm.py) — every Sentinel-2 CRS is a UTM zone,
    so lon/lat ROIs work GDAL-free too."""
    xoff, a, b, yoff, d, e = ds.GetGeoTransform()

    def xy_to_pixel(xp, yp):
        xp -= xoff
        yp -= yoff
        det_inv = 1.0 / (a * e - d * b)
        return (e * xp - b * yp) * det_inv, (-d * xp + a * yp) * det_inv

    try:
        from osgeo import osr

        srs = osr.SpatialReference()
        srs.ImportFromWkt(ds.GetProjection())
        srs_ll = osr.SpatialReference()
        srs_ll.SetWellKnownGeogCS("WGS84")
        # GDAL 3 honours CRS authority axis order (lat, lon for WGS84);
        # force the traditional (lon, lat) order the reference's
        # GDAL-2-era math uses.
        for s in (srs, srs_ll):
            if hasattr(s, "SetAxisMappingStrategy"):
                s.SetAxisMappingStrategy(osr.OAMS_TRADITIONAL_GIS_ORDER)
        ct = osr.CoordinateTransformation(srs_ll, srs)

        def to_xy(lon, lat):
            xp, yp, _ = ct.TransformPoint(lon, lat, 0.0)
            return xy_to_pixel(xp, yp)

    except ImportError:
        from dsen2_tpu_torch.geo.utm import utm_forward, zone_from_epsg
        from dsen2_tpu_torch.io.geotiff import epsg_from_wkt

        epsg = epsg_from_wkt(ds.GetProjection())
        if epsg is None:
            raise ImportError(
                "lon/lat ROIs without GDAL/OSR need a UTM CRS with an "
                "EPSG code in the dataset projection"
            )
        zone, north = zone_from_epsg(epsg)

        def to_xy(lon, lat):
            return xy_to_pixel(*utm_forward(lon, lat, zone, north))

    x1, y1 = to_xy(lon1, lat1)
    x2, y2 = to_xy(lon2, lat2)
    return x1, y1, x2, y2


def _candidate_rois(
    gdal,
    infos: Sequence[SubdatasetInfo],
    roi_x_y: Optional[Tuple[float, float, float, float]],
    roi_lon_lat: Optional[Tuple[float, float, float, float]],
    snap_grid: int,
) -> list[Tuple[SubdatasetInfo, Roi]]:
    """Per-10m-subdataset snapped ROI (the shared first half of
    s2_tiles_supres.py:123-170): pixel ROI, lon/lat ROI via OSR, or the
    full raster. Unopenable subdatasets are skipped with a warning."""
    import warnings

    out = []
    for info in infos:
        ds = gdal.Open(info.name)
        if ds is None:
            warnings.warn(f"subdataset unreadable, skipping: {info.name}")
            continue
        if roi_x_y is not None:
            x1, y1, x2, y2 = roi_x_y
            roi = snap_roi_to_grid(x1, y1, x2, y2, ds.RasterXSize, ds.RasterYSize, snap_grid)
        elif roi_lon_lat is not None:
            x1, y1, x2, y2 = _lonlat_to_pixel(ds, *roi_lon_lat)
            roi = snap_roi_to_grid(
                int(x1), int(y1), int(x2), int(y2), ds.RasterXSize, ds.RasterYSize, snap_grid
            )
        else:
            roi = Roi(0, 0, ds.RasterXSize - 1, ds.RasterYSize - 1)
        out.append((info, roi))
    return out


def scan_utm_zones(
    data_file: str,
    roi_x_y: Optional[Tuple[float, float, float, float]] = None,
    roi_lon_lat: Optional[Tuple[float, float, float, float]] = None,
    snap_grid: int = 6,
) -> Dict[str, int]:
    """UTM zones present in a product with their ROI coverage in 10 m pixels
    (reference: s2_tiles_supres.py:186-190), WITHOUT reading any raster
    data and without failing on an empty ROI/zone combination."""
    gdal = _backend(data_file, "scanning SAFE products")

    raster = gdal.Open(data_file)
    if raster is None:
        raise FileNotFoundError(data_file)
    groups = classify_subdatasets(raster.GetSubDatasets())
    infos = groups["10m"] + groups["unknown"]
    if not infos:
        raise ValueError(f"{data_file}: no 10m subdatasets found (not a SAFE product?)")
    candidates = _candidate_rois(gdal, infos, roi_x_y, roi_lon_lat, snap_grid)
    _, _, _, coverage = select_utm(candidates)
    return coverage


def read_safe(
    data_file: str,
    roi_x_y: Optional[Tuple[float, float, float, float]] = None,
    roi_lon_lat: Optional[Tuple[float, float, float, float]] = None,
    run_60: bool = False,
    select_utm_zone: str = "",
    snap_grid: int = 6,
    select_bands: Optional[Sequence[str]] = None,
    output_format: str = "GTiff",
) -> TileData:
    """Read the selected ROI of a SAFE product into HWC arrays.

    Mirrors the reference pipeline end to end: subdataset classification,
    UTM-zone selection by coverage, ROI snap, band validation, windowed
    ReadAsArray at /1, /2, /6 offsets (s2_tiles_supres.py:97-329).

    Works without GDAL for SAFE-layout products: the Pillow JPEG-2000
    backend (data/safe_pil.py) presents the same dataset surface, so the
    whole pipeline below is backend-agnostic, including lon/lat ROIs
    (projected via OSR under GDAL, via dsen2_tpu_torch/geo/utm.py without)."""
    gdal = _backend(data_file, "reading SAFE products")

    from dsen2_tpu_torch.core.bands import SELECT_BANDS_20, SELECT_BANDS_60

    if select_bands is None:
        select_bands = SELECT_BANDS_60 if run_60 else SELECT_BANDS_20

    raster = gdal.Open(data_file)
    if raster is None:
        raise FileNotFoundError(data_file)
    groups = classify_subdatasets(raster.GetSubDatasets())
    tens = groups["10m"] + groups["unknown"]
    if not tens:
        raise ValueError(f"{data_file}: no 10m subdatasets found (not a SAFE product?)")

    candidates = _candidate_rois(gdal, tens, roi_x_y, roi_lon_lat, snap_grid)
    if not candidates:
        raise ValueError(f"{data_file}: no readable 10m subdatasets")

    idx, utm, roi, coverage = select_utm(candidates, select_utm_zone)
    if roi.empty:
        raise ValueError("Invalid region of interest / UTM zone combination")

    def pick(group: List[SubdatasetInfo]) -> Optional[SubdatasetInfo]:
        for info in group:
            if utm in info.description:
                return info
        return group[idx] if idx < len(group) else (group[0] if group else None)

    sel10 = candidates[idx][0]
    sel20 = pick(groups["20m"])
    sel60 = pick(groups["60m"])

    ds10 = gdal.Open(sel10.name)
    descs10 = [ds10.GetRasterBand(b + 1).GetDescription() for b in range(ds10.RasterCount)]
    bands10 = validate_bands(descs10, select_bands, output_format)
    used = [b.shortname for b in bands10]
    remaining = [b for b in select_bands if b not in used]

    bands20: List[BandInfo] = []
    bands60: List[BandInfo] = []
    ds20 = ds60 = None
    if sel20 is not None:
        ds20 = gdal.Open(sel20.name)
        descs20 = [ds20.GetRasterBand(b + 1).GetDescription() for b in range(ds20.RasterCount)]
        bands20 = validate_bands(descs20, remaining, output_format)
        used += [b.shortname for b in bands20]
        remaining = [b for b in remaining if b not in used]
    if sel60 is not None:
        ds60 = gdal.Open(sel60.name)
        descs60 = [ds60.GetRasterBand(b + 1).GetDescription() for b in range(ds60.RasterCount)]
        bands60 = validate_bands(descs60, remaining, output_format)

    def window(ds, indices: List[int], div: int) -> Optional[np.ndarray]:
        if not indices:
            return None
        arr = ds.ReadAsArray(
            xoff=roi.xmin // div,
            yoff=roi.ymin // div,
            xsize=roi.width // div,
            ysize=roi.height // div,
            buf_xsize=roi.width // div,
            buf_ysize=roi.height // div,
        )
        return np.moveaxis(arr, 0, -1)[:, :, indices]

    data10 = window(ds10, [b.index for b in bands10], 1)
    data20 = window(ds20, [b.index for b in bands20], 2) if ds20 else None
    data60 = window(ds60, [b.index for b in bands60], 6) if ds60 else None

    descriptions = {b.shortname: b.description for b in bands10 + bands20 + bands60}
    return TileData(
        data10=data10,
        data20=data20,
        data60=data60,
        bands10=bands10,
        bands20=bands20,
        bands60=bands60,
        roi=roi,
        geotransform=tuple(ds10.GetGeoTransform()),
        projection=ds10.GetProjection(),
        descriptions=descriptions,
        utm=utm,
        utm_coverage=coverage,
    )
