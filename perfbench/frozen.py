"""Frozen copies of the smoke script's data makers and host-side helpers.

The benchmark never imports chip_smoke.py, which later changes may edit:
what decides the inputs of a cell lives here and does not move with the
program. Copied from chip_smoke.py: synthetic_scene, tiled_scene,
product_rasters, the in-memory GDAL stand-in (gdal_product, installed_gdal),
timed_calls, training_set and smi. Nothing here imports dsen2_tpu_torch.
"""

from __future__ import annotations

import contextlib
import subprocess
import sys
import time
import types

import numpy as np

# The reflectance scale the nets divide by (the reference's testing/supres.py).
SCALE = 2000.0


def smi() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"
    return out.strip().splitlines()[0] if out.strip() else "nvidia-smi printed nothing"


def synthetic_scene(seed: int, h10: int):
    """A seeded uint16 scene on the 10/20/60 m grids: smooth fields of
    reflectance-like DN plus noise."""
    rng = np.random.default_rng(seed)

    def raster(h, c):
        coarse = rng.uniform(300, 6000, size=(h // 24 + 2, h // 24 + 2, c))
        field = np.repeat(np.repeat(coarse, 24, axis=0), 24, axis=1)[:h, :h]
        noise = rng.normal(0, 150, size=(h, h, c))
        return np.clip(field + noise, 0, 65535).astype(np.uint16)

    return raster(h10, 4), raster(h10 // 2, 6), raster(h10 // 6, 2)


def tiled_scene(seed: int, h10: int, base: int):
    """A seeded uint16 scene of h10 x h10 px (h10 a multiple of `base`),
    tiled from synthetic_scene(seed, base) so that no float64 temporary of
    the whole tile exists."""
    reps = h10 // base
    return tuple(np.tile(r, (reps, reps, 1)) for r in synthetic_scene(seed, base))


# An L1C product's bands per resolution, in the order and with the
# descriptions of GDAL's SENTINEL2 driver.
PRODUCT_BANDS = {10: ("B4", "B3", "B2", "B8"), 20: ("B5", "B6", "B7", "B8A", "B11", "B12"),
                 60: ("B1", "B9", "B10")}
WAVELENGTH_NM = {"B1": 443, "B2": 490, "B3": 560, "B4": 665, "B5": 705, "B6": 740, "B7": 783,
                 "B8": 842, "B8A": 865, "B9": 945, "B10": 1375, "B11": 1610, "B12": 2190}
PRODUCT_EPSG, PRODUCT_ULX, PRODUCT_ULY = 32633, 399960.0, 5000040.0


def product_rasters(seed: int, h10: int, base: int = 0):
    """Seeded uint16 rasters of an L1C product: 4, 6 and 3 bands on the 10,
    20 and 60 m grids, tiled from a `base` px scene when base is given."""
    d10, d20, d60 = tiled_scene(seed, h10, base) if base else synthetic_scene(seed, h10)
    return d10, d20, np.concatenate([d60, d60[:, :, :1]], axis=2)


class _MemoryBand:
    def __init__(self, desc: str):
        self._desc = desc

    def GetDescription(self) -> str:
        return self._desc


class _MemoryRaster:
    """One resolution of the product, a GDAL dataset's read surface over an
    [H, W, C] array."""

    def __init__(self, arr: np.ndarray, res: int):
        self._chw = np.moveaxis(arr, -1, 0)
        self._res = res
        self.RasterCount, self.RasterYSize, self.RasterXSize = self._chw.shape

    def GetRasterBand(self, i: int) -> _MemoryBand:
        b = PRODUCT_BANDS[self._res][i - 1]
        return _MemoryBand(f"{b}, central wavelength {WAVELENGTH_NM[b]} nm")

    def GetGeoTransform(self) -> tuple:
        return (PRODUCT_ULX, float(self._res), 0.0, PRODUCT_ULY, 0.0, -float(self._res))

    def GetProjection(self) -> str:
        return f'PROJCS["WGS 84 / UTM zone 33N",AUTHORITY["EPSG","{PRODUCT_EPSG}"]]'

    def ReadAsArray(self, xoff, yoff, xsize, ysize, buf_xsize=None, buf_ysize=None):
        return self._chw[:, yoff:yoff + ysize, xoff:xoff + xsize]


def gdal_product(d10, d20, d60):
    """A stand-in `osgeo.gdal` module serving (d10, d20, d60) as an L1C
    product with three resolution subdatasets, as GDAL's SENTINEL2 driver
    presents one, and with no GTiff driver, so that write_bands takes the
    built-in GeoTIFF writer. Returns (module, product name)."""
    name = "MEMORY_MTD_MSIL1C.xml"
    subs = {f"SENTINEL2_L1C:{name}:{res}m:EPSG_{PRODUCT_EPSG}": (
        f"Bands {', '.join(PRODUCT_BANDS[res])} with {res}m resolution, UTM 33N",
        _MemoryRaster(arr, res)) for res, arr in ((10, d10), (20, d20), (60, d60))}
    product = types.SimpleNamespace(
        GetSubDatasets=lambda: [(k, desc) for k, (desc, _) in subs.items()])
    gdal = types.ModuleType("osgeo.gdal")
    gdal.Open = lambda n: product if n == name else subs[n][1] if n in subs else None
    gdal.GetDriverByName = lambda n: None
    gdal.DCAP_CREATE = "DCAP_CREATE"
    return gdal, name


@contextlib.contextmanager
def installed_gdal(gdal):
    """Make `gdal` the importable osgeo.gdal inside the block."""
    osgeo = types.ModuleType("osgeo")
    osgeo.gdal = gdal
    saved = {k: sys.modules.get(k) for k in ("osgeo", "osgeo.gdal")}
    sys.modules["osgeo"], sys.modules["osgeo.gdal"] = osgeo, gdal
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


@contextlib.contextmanager
def timed_calls(*targets):
    """Wrap each (module, name) function so that the wall seconds of its
    calls are appended to the yielded dict under `name`; restore them after."""
    times, saved = {}, []
    for mod, name in targets:
        fn = getattr(mod, name)

        def wrapper(*a, _fn=fn, _name=name, **kw):
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            times.setdefault(_name, []).append(time.perf_counter() - t0)
            return out

        saved.append((mod, name, fn))
        setattr(mod, name, wrapper)
    try:
        yield times
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def training_set(seed: int, n: int, hw: int, in_channels):
    """Seeded crops at the reference's shapes, divided by SCALE as the CLI
    does: reflectance-like DN in [0, 10000) for every input, and a label
    that is a fixed smooth function of them (the last input plus a tanh of
    a fixed mix of the first), so that the loss has something to learn."""
    rng = np.random.default_rng(seed)
    xs = [(rng.random((n, hw, hw, c), dtype=np.float32) * 10000 / SCALE).astype(np.float32)
          for c in in_channels]
    mix = np.random.default_rng(1000).standard_normal((in_channels[0], in_channels[-1]))
    label = xs[-1] + 0.25 * np.tanh(xs[0] @ mix.astype(np.float32) - 2.5)
    return xs, label.astype(np.float32)
