"""GDAL-free Sentinel-2 SAFE backend: JPEG-2000 via Pillow + MTD_TL.xml.

The reference reads SAFE products exclusively through GDAL's SENTINEL2
driver (testing/s2_tiles_supres.py:97-329). This backend provides the
SAME dataset surface — `Open()` on the product XML returning subdatasets
with `GetSubDatasets / RasterXSize / GetRasterBand / GetGeoTransform /
GetProjection / ReadAsArray` — built from the product's own files with
the standard library + Pillow (whose OpenJPEG codec decodes the L1C
JP2 band files losslessly):

  - granules found structurally (GRANULE/*/IMG_DATA/*_Bxx.jp2)
  - geocoding from each granule's MTD_TL.xml (<Geoposition>: ULX/ULY +
    XDIM/YDIM; <HORIZONTAL_CS_CODE>: the EPSG code)
  - band order per resolution mirrors GDAL's SENTINEL2 driver exactly
    (10 m: B4,B3,B2,B8; 20 m: B5,B6,B7,B8A,B11,B12; 60 m: B1,B9,B10),
    with the driver's description strings, so `read_safe`'s
    classification / UTM-selection / band-validation logic is shared
    verbatim between the two backends

data/safe_reader.py::read_safe falls back to this backend automatically
when GDAL is absent, which makes the production CLI fully functional on
a GDAL-less host: SAFE in (real JP2 decode) -> GeoTIFF out
(io/geotiff.py). Lon/lat ROIs are projected with the built-in UTM
transverse Mercator (dsen2_tpu_torch/geo/utm.py); pixel ROIs and full-tile
reads need no projection at all.

A copy of dsen2_tpu/data/safe_pil.py with two repairs: ReadAsArray raises
ValueError for a window that is negative or reaches past the raster (the
original let numpy's negative-index slicing pick other pixels), and it
keeps no decoded plane once its window is copied out (the original cached
every plane for the product's life: about 1.3 GB on a 10980^2 product).
"""

from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["available", "open_product", "GdalLikeShim", "looks_like_safe"]

# GDAL SENTINEL2-driver band order per resolution (B10 is present in the
# 60 m subdataset; the CLI's whitelists simply never select it —
# reference s2_tiles_supres.py:81-87).
_RES_BANDS = {
    10: ("B4", "B3", "B2", "B8"),
    20: ("B5", "B6", "B7", "B8A", "B11", "B12"),
    60: ("B1", "B9", "B10"),
}

# central wavelengths (nm) for the driver-style band descriptions
_WAVELENGTH = {
    "B1": 443, "B2": 490, "B3": 560, "B4": 665, "B5": 705, "B6": 740,
    "B7": 783, "B8": 842, "B8A": 865, "B9": 945, "B10": 1375,
    "B11": 1610, "B12": 2190,
}


def available() -> bool:
    try:
        from PIL import features

        return bool(features.check("jpg_2000"))
    except ImportError:
        return False


def looks_like_safe(data_file: str) -> bool:
    """True when `data_file` is a SAFE product root or its MTD_MSIL1C.xml."""
    root = _product_root(data_file)
    return root is not None and bool(_find_granules(root))


def _product_root(data_file: str) -> Optional[str]:
    p = os.path.abspath(data_file)
    if os.path.isdir(p):
        return p if os.path.isdir(os.path.join(p, "GRANULE")) else None
    name = os.path.basename(p)
    if name.startswith("MTD_MSIL") and name.endswith(".xml") and os.path.isfile(p):
        root = os.path.dirname(p)
        return root if os.path.isdir(os.path.join(root, "GRANULE")) else None
    return None


def _find_granules(root: str) -> List[str]:
    gdir = os.path.join(root, "GRANULE")
    if not os.path.isdir(gdir):
        return []
    return sorted(
        os.path.join(gdir, d)
        for d in os.listdir(gdir)
        if os.path.isdir(os.path.join(gdir, d, "IMG_DATA"))
    )


def _band_files(granule: str) -> Dict[str, str]:
    """Map short band name -> JP2 path (L1C layout: IMG_DATA/*_Bxx.jp2).
    File names zero-pad single digits (B02...B09); short names do not."""
    img = os.path.join(granule, "IMG_DATA")
    out = {}
    for fn in sorted(os.listdir(img)):
        m = re.search(r"_(B\d{1,2}A?)\.jp2$", fn)
        if m:
            b = m.group(1)
            if re.fullmatch(r"B0\d", b):
                b = "B" + b[2]
            out[b] = os.path.join(img, fn)
    return out


class _TlMeta:
    """The slice of MTD_TL.xml the reader needs: per-resolution geoposition
    + sizes and the horizontal CRS."""

    def __init__(self, granule: str):
        cands = [
            os.path.join(granule, f)
            for f in os.listdir(granule)
            if f.startswith("MTD_TL") and f.endswith(".xml")
        ]
        if not cands:
            raise FileNotFoundError(f"{granule}: no MTD_TL.xml")
        tree = ET.parse(cands[0])
        txt = lambda el: (el.text or "").strip()  # noqa: E731

        self.epsg: Optional[int] = None
        self.cs_name = ""
        for el in tree.iter():
            tag = el.tag.rsplit("}", 1)[-1]
            if tag == "HORIZONTAL_CS_CODE":
                m = re.search(r"(\d+)", txt(el))
                if m:
                    self.epsg = int(m.group(1))
            elif tag == "HORIZONTAL_CS_NAME":
                self.cs_name = txt(el)

        self.geo: Dict[int, Tuple[float, float, float, float]] = {}
        self.size: Dict[int, Tuple[int, int]] = {}
        for el in tree.iter():
            tag = el.tag.rsplit("}", 1)[-1]
            res = el.get("resolution")
            if tag == "Geoposition" and res:
                vals = {c.tag.rsplit("}", 1)[-1]: float(txt(c)) for c in el}
                self.geo[int(res)] = (
                    vals["ULX"], vals["ULY"], vals["XDIM"], vals["YDIM"]
                )
            elif tag == "Size" and res:
                vals = {c.tag.rsplit("}", 1)[-1]: int(txt(c)) for c in el}
                self.size[int(res)] = (vals["NROWS"], vals["NCOLS"])

    @property
    def utm_label(self) -> str:
        """'UTM 33N'-style label matching the GDAL driver's description
        suffix (safe_reader.utm_of keys on the 'UTM' substring)."""
        if self.cs_name:
            m = re.search(r"UTM\s*zone\s*(\d+[A-Z]?)", self.cs_name, re.I)
            if m:
                return f"UTM {m.group(1)}"
        if self.epsg and 32600 < self.epsg <= 32760:
            zone = self.epsg % 100
            hemi = "N" if self.epsg < 32700 else "S"
            return f"UTM {zone}{hemi}"
        return f"EPSG {self.epsg}" if self.epsg else "UTM ?"

    def wkt(self) -> str:
        name = self.cs_name or (f"EPSG:{self.epsg}" if self.epsg else "unknown")
        auth = f',AUTHORITY["EPSG","{self.epsg}"]' if self.epsg else ""
        return f'PROJCS["{name}"{auth}]'


class _Band:
    def __init__(self, desc: str):
        self._desc = desc

    def GetDescription(self) -> str:
        return self._desc


class _PilSubdataset:
    """One (granule, resolution) raster stack, GDAL-dataset duck type."""

    def __init__(self, granule: str, res: int, meta: _TlMeta):
        self._files = _band_files(granule)
        self._res = res
        self._meta = meta
        self._bands = [b for b in _RES_BANDS[res] if b in self._files]
        if res in meta.size:
            self.RasterYSize, self.RasterXSize = meta.size[res]
        else:
            from PIL import Image

            with Image.open(self._files[self._bands[0]]) as im:
                self.RasterXSize, self.RasterYSize = im.size
        self.RasterCount = len(self._bands)

    def GetRasterBand(self, i: int) -> _Band:
        b = self._bands[i - 1]
        return _Band(f"{b}, central wavelength {_WAVELENGTH[b]} nm")

    def GetGeoTransform(self) -> tuple:
        ulx, uly, xdim, ydim = self._meta.geo.get(
            self._res, (0.0, 0.0, float(self._res), -float(self._res))
        )
        return (ulx, xdim, 0.0, uly, 0.0, ydim)

    def GetProjection(self) -> str:
        return self._meta.wkt()

    def _plane(self, band: str) -> np.ndarray:
        """One band's whole decoded plane; the caller drops it."""
        from PIL import Image

        with Image.open(self._files[band]) as im:
            return np.asarray(im)

    def ReadAsArray(self, xoff=0, yoff=0, xsize=None, ysize=None,
                    buf_xsize=None, buf_ysize=None) -> np.ndarray:
        xsize = self.RasterXSize - xoff if xsize is None else xsize
        ysize = self.RasterYSize - yoff if ysize is None else ysize
        if (buf_xsize not in (None, xsize)) or (buf_ysize not in (None, ysize)):
            raise ValueError("safe_pil does not resample on read")
        if (xoff < 0 or yoff < 0 or xsize < 1 or ysize < 1
                or xoff + xsize > self.RasterXSize or yoff + ysize > self.RasterYSize):
            raise ValueError(
                f"window x {xoff}+{xsize}, y {yoff}+{ysize} is outside the "
                f"{self.RasterXSize} x {self.RasterYSize} raster"
            )
        # Decode one plane at a time and drop it once its window is copied:
        # at most one whole plane is alive.
        out = None
        for i, b in enumerate(self._bands):
            win = self._plane(b)[yoff : yoff + ysize, xoff : xoff + xsize]
            if out is None:
                out = np.empty((len(self._bands),) + win.shape, win.dtype)
            out[i] = win
            del win
        return out


class _PilProduct:
    def __init__(self, root: str):
        self._subs: List[Tuple[str, str, _PilSubdataset]] = []
        for granule in _find_granules(root):
            meta = _TlMeta(granule)
            files = _band_files(granule)
            for res in (10, 20, 60):
                bands = [b for b in _RES_BANDS[res] if b in files]
                if not bands:
                    continue
                name = f"SAFE_PIL:{granule}:{res}m"
                desc = (
                    f"Bands {', '.join(bands)} with {res}m resolution, "
                    f"{meta.utm_label}"
                )
                self._subs.append((name, desc, _PilSubdataset(granule, res, meta)))

    def GetSubDatasets(self) -> List[Tuple[str, str]]:
        return [(name, desc) for name, desc, _ in self._subs]

    def dataset(self, name: str) -> Optional[_PilSubdataset]:
        for n, _, ds in self._subs:
            if n == name:
                return ds
        return None


class GdalLikeShim:
    """The `gdal`-module duck type `read_safe` drives: Open() on the
    product path or a subdataset name. One shim instance is bound to one
    product so subdataset names resolve without re-parsing."""

    def __init__(self, root: str):
        self._root = root
        self._product = _PilProduct(root)

    def Open(self, name: str):
        if name.startswith("SAFE_PIL:"):
            return self._product.dataset(name)
        if _product_root(name) == self._root:
            return self._product
        return None


def open_product(data_file: str) -> Tuple[GdalLikeShim, str]:
    """(shim, normalized product path) for a SAFE product readable without
    GDAL. Raises with a clear message when the path is not a SAFE layout
    or Pillow lacks JPEG-2000."""
    root = _product_root(data_file)
    if root is None:
        raise FileNotFoundError(
            f"{data_file}: not a SAFE product (no GRANULE/ next to it)"
        )
    if not available():
        raise ImportError(
            "reading SAFE JP2 imagery without GDAL requires Pillow with "
            "JPEG-2000 support"
        )
    return GdalLikeShim(root), data_file
