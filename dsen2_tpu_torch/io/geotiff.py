"""Dependency-free GeoTIFF writer (classic TIFF + BigTIFF).

A copy of dsen2_tpu/io/geotiff.py (tests/test_torch_io.py holds the files
it writes byte-identical), except that an EPSG code outside 1..65535, which
the GeoKeyDirectory's 16-bit slot cannot hold, raises instead of wrapping
into another CRS's code.

The reference CLI's default output is a GDAL-created GeoTIFF
(testing/s2_tiles_supres.py:396-413); without GDAL this framework used to
degrade to an .npz. This module writes a real georeferenced GeoTIFF with
the standard library only, so the production CLI emits the
reference-faithful format on GDAL-less hosts too:

  - baseline uncompressed striped TIFF, little-endian; BigTIFF
    automatically when the payload approaches the classic 4 GB offset
    limit (a full 10980^2 12-band float64 tile is ~11.6 GB)
  - multi-band as SamplesPerPixel=N with PlanarConfiguration=2
    (plane-separate strips — what GDAL itself writes for band-interleaved
    rasters), per-sample BitsPerSample/SampleFormat
  - georeferencing via ModelPixelScaleTag + ModelTiepointTag (north-up
    geotransforms — Sentinel-2 L1C grids have no rotation terms) and a
    GeoKeyDirectoryTag carrying the EPSG code (parsed from the
    projection WKT's AUTHORITY nodes when not given explicitly)
  - band descriptions in the GDAL_METADATA ASCII tag (the encoding GDAL
    reads back as band descriptions)

Readers: GDAL/QGIS/rasterio/libtiff consume this layout directly; the
test suite carries its own independent TIFF parser
(tests/test_geotiff.py) since no TIFF reader ships in this image.
"""

from __future__ import annotations

import re
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["write_geotiff", "epsg_from_wkt"]

# TIFF data type codes
_ASCII, _SHORT, _LONG, _DOUBLE, _LONG8 = 2, 3, 4, 12, 16
_TYPE_SIZE = {_ASCII: 1, _SHORT: 2, _LONG: 4, _DOUBLE: 8, _LONG8: 8}

# tag ids
_T_WIDTH, _T_HEIGHT, _T_BPS, _T_COMPRESSION, _T_PHOTOMETRIC = 256, 257, 258, 259, 262
_T_STRIP_OFFSETS, _T_SAMPLES, _T_ROWS_PER_STRIP, _T_STRIP_COUNTS = 273, 277, 278, 279
_T_PLANAR, _T_EXTRASAMPLES, _T_SAMPLE_FORMAT = 284, 338, 339
_T_PIXEL_SCALE, _T_TIEPOINT, _T_GEO_KEYS, _T_GDAL_META = 33550, 33922, 34735, 42112

_SAMPLE_FORMAT = {"u": 1, "i": 2, "f": 3}


def epsg_from_wkt(wkt: Optional[str]) -> Optional[int]:
    """The EPSG code of a WKT CRS: the LAST AUTHORITY (WKT1) or ID (WKT2)
    EPSG node is the code of the whole CRS (earlier ones describe the
    datum/axes)."""
    if not wkt:
        return None
    m = re.findall(
        r'(?:AUTHORITY|ID)\[\s*"EPSG"\s*,\s*"?(\d+)"?\s*\]', wkt
    )
    return int(m[-1]) if m else None


def _xml_escape(s: str) -> str:
    return s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")


def _geokeys(epsg: int) -> np.ndarray:
    """Minimal GeoKeyDirectory: model type + raster type + the CRS code.
    EPSG 4xxx are geographic CRS (GeographicTypeGeoKey); everything the
    Sentinel-2 pipeline emits (UTM 326xx/327xx) is projected."""
    if not 1 <= epsg <= 65535:
        raise ValueError(
            f"EPSG code {epsg} does not fit the GeoKeyDirectory's 16-bit "
            "slot (1..65535); pass the projection without an EPSG code"
        )
    geographic = 4000 <= epsg < 5000
    keys = [
        (1024, 0, 1, 2 if geographic else 1),  # GTModelType
        (1025, 0, 1, 1),  # GTRasterType = PixelIsArea
        (2048 if geographic else 3072, 0, 1, epsg),
    ]
    header = (1, 1, 0, len(keys))
    return np.asarray([header] + keys, np.uint16).reshape(-1)


def write_geotiff(
    path: str,
    bands: Sequence[Tuple[str, np.ndarray]],
    geotransform: Optional[Sequence[float]] = None,
    projection_wkt: Optional[str] = None,
    epsg: Optional[int] = None,
    rows_per_strip: Optional[int] = None,
    bigtiff: Optional[bool] = None,
) -> str:
    """Write (description, [H, W]) bands as one multi-band GeoTIFF.

    Bands are upcast to their common numpy type (per-sample formats are
    legal TIFF but poorly supported by readers; the reference writes
    everything Float64 for the same reason). bigtiff=None auto-selects
    BigTIFF when the classic format's 32-bit offsets could not address
    the strips. Returns "GTiff" / "BigTIFF" (the variant written)."""
    if not bands:
        raise ValueError("write_geotiff: no bands")
    descs = [d for d, _ in bands]
    arrs = [np.asarray(a) for _, a in bands]
    h, w = arrs[0].shape
    for d, a in zip(descs, arrs):
        if a.shape != (h, w):
            raise ValueError(f"band {d!r}: shape {a.shape} != {(h, w)}")
    dtype = np.result_type(*arrs)
    if dtype.kind not in _SAMPLE_FORMAT:
        raise ValueError(f"unsupported band dtype {dtype}")
    if dtype == np.float16:
        # half floats are legal TIFF but unreadable by most tools
        dtype = np.dtype(np.float32)
    dtype = dtype.newbyteorder("<")
    arrs = [np.ascontiguousarray(a.astype(dtype, copy=False)) for a in arrs]

    n = len(arrs)
    bps = dtype.itemsize * 8
    row_bytes = w * dtype.itemsize
    if rows_per_strip is None:
        rows_per_strip = max(1, min(h, (8 << 20) // max(1, row_bytes)))
    strips_per_plane = -(-h // rows_per_strip)
    nstrips = strips_per_plane * n

    counts = []
    for _p in range(n):
        for s in range(strips_per_plane):
            r0 = s * rows_per_strip
            counts.append((min(h, r0 + rows_per_strip) - r0) * row_bytes)
    total_data = sum(counts)
    if bigtiff is None:
        bigtiff = total_data + (1 << 20) > (1 << 32) - 1

    off_t = _LONG8 if bigtiff else _LONG
    off_fmt = "<Q" if bigtiff else "<I"
    inline = 8 if bigtiff else 4

    if epsg is None:
        epsg = epsg_from_wkt(projection_wkt)

    def shorts(vals):
        return np.asarray(vals, "<u2").tobytes()

    def longs(vals):
        return np.asarray(vals, "<u4").tobytes()

    def doubles(vals):
        return np.asarray(vals, "<f8").tobytes()

    # (tag, type, count, payload) — ascending tag order (TIFF requirement)
    entries: List[Tuple[int, int, int, bytes]] = [
        (_T_WIDTH, _LONG, 1, longs([w])),
        (_T_HEIGHT, _LONG, 1, longs([h])),
        (_T_BPS, _SHORT, n, shorts([bps] * n)),
        (_T_COMPRESSION, _SHORT, 1, shorts([1])),
        (_T_PHOTOMETRIC, _SHORT, 1, shorts([1])),  # BlackIsZero
        (_T_STRIP_OFFSETS, off_t, nstrips, b""),  # payload filled below
        (_T_SAMPLES, _SHORT, 1, shorts([n])),
        (_T_ROWS_PER_STRIP, _LONG, 1, longs([rows_per_strip])),
        (_T_STRIP_COUNTS, off_t, nstrips,
         np.asarray(counts, "<u8" if bigtiff else "<u4").tobytes()),
        (_T_PLANAR, _SHORT, 1, shorts([2])),
    ]
    if n > 1:
        entries.append((_T_EXTRASAMPLES, _SHORT, n - 1, shorts([0] * (n - 1))))
    entries.append(
        (_T_SAMPLE_FORMAT, _SHORT, n, shorts([_SAMPLE_FORMAT[dtype.kind]] * n))
    )
    if geotransform is not None:
        g = list(geotransform)
        if g[2] or g[4]:
            raise ValueError(
                "write_geotiff supports north-up geotransforms only "
                f"(rotation terms {g[2]}, {g[4]} are nonzero)"
            )
        entries.append((_T_PIXEL_SCALE, _DOUBLE, 3, doubles([g[1], -g[5], 0.0])))
        entries.append(
            (_T_TIEPOINT, _DOUBLE, 6, doubles([0, 0, 0, g[0], g[3], 0]))
        )
    if epsg is not None:
        gk = _geokeys(int(epsg))
        entries.append((_T_GEO_KEYS, _SHORT, gk.size, gk.astype("<u2").tobytes()))
    if any(descs):
        items = "".join(
            f'<Item name="DESCRIPTION" sample="{i}" role="description">'
            f"{_xml_escape(d)}</Item>"
            for i, d in enumerate(descs)
        )
        meta = f"<GDALMetadata>{items}</GDALMetadata>\n\x00".encode()
        entries.append((_T_GDAL_META, _ASCII, len(meta), meta))

    # ---- layout ----
    if bigtiff:
        header_size, entry_size = 16, 20
        ifd_size = 8 + len(entries) * entry_size + 8
    else:
        header_size, entry_size = 8, 12
        ifd_size = 2 + len(entries) * entry_size + 4

    # out-of-line payloads follow the IFD, in entry order, 2-byte aligned
    blob_off = header_size + ifd_size
    blob_offsets = {}
    for tag, typ, cnt, payload in entries:
        size = cnt * _TYPE_SIZE[typ]
        if size > inline:
            blob_off += blob_off % 2
            blob_offsets[tag] = blob_off
            blob_off += size
    data_start = blob_off + blob_off % 2

    strip_offsets = []
    pos = data_start
    for c in counts:
        strip_offsets.append(pos)
        pos += c
    so_payload = np.asarray(strip_offsets, "<u8" if bigtiff else "<u4").tobytes()
    entries = [
        (t, ty, c, so_payload if t == _T_STRIP_OFFSETS else p)
        for t, ty, c, p in entries
    ]

    with open(path, "wb") as f:
        if bigtiff:
            f.write(struct.pack("<2sHHHQ", b"II", 43, 8, 0, header_size))
            f.write(struct.pack("<Q", len(entries)))
        else:
            f.write(struct.pack("<2sHI", b"II", 42, header_size))
            f.write(struct.pack("<H", len(entries)))
        for tag, typ, cnt, payload in entries:
            size = cnt * _TYPE_SIZE[typ]
            if size <= inline:
                val = payload.ljust(inline, b"\x00")
                off_field = val
            else:
                off_field = struct.pack(off_fmt, blob_offsets[tag])
            if bigtiff:
                f.write(struct.pack("<HHQ", tag, typ, cnt) + off_field)
            else:
                f.write(struct.pack("<HHI", tag, typ, cnt) + off_field)
        f.write(struct.pack(off_fmt, 0))  # no next IFD
        # out-of-line payloads
        for tag, typ, cnt, payload in entries:
            size = cnt * _TYPE_SIZE[typ]
            if size > inline:
                if f.tell() % 2:
                    f.write(b"\x00")
                assert f.tell() == blob_offsets[tag], (tag, f.tell())
                f.write(payload)
        if f.tell() % 2:
            f.write(b"\x00")
        assert f.tell() == data_start
        # strip data, plane-major
        for a in arrs:
            for s in range(strips_per_plane):
                r0 = s * rows_per_strip
                f.write(a[r0 : min(h, r0 + rows_per_strip)].tobytes())
    return "BigTIFF" if bigtiff else "GTiff"
