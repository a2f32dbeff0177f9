"""A frozen copy of the repository's independent TIFF/BigTIFF test reader.

The benchmark reads back the GeoTIFFs that s2_supres writes with this copy,
so that a later change to the reader the test suite uses cannot move the
yardstick. Written from the TIFF 6.0 / BigTIFF specs, not from the writer.
Unlike the test reader it maps the file instead of reading it whole: a
plane whose strips lie one after the other is a view of the mapping, so a
check that reads a few blocks of a large file touches only those.
"""
from __future__ import annotations

import mmap
import re
import struct

import numpy as np

_TYPE = {
    1: ("B", 1),   # BYTE
    2: ("c", 1),   # ASCII
    3: ("H", 2),   # SHORT
    4: ("I", 4),   # LONG
    12: ("d", 8),  # DOUBLE
    16: ("Q", 8),  # LONG8
}


def read_tiff(path):
    with open(path, "rb") as f:
        data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    order, magic = struct.unpack("<2sH", data[:4])
    assert order == b"II", "test reader handles little-endian only"
    if magic == 42:
        (ifd_off,) = struct.unpack_from("<I", data, 4)
        count_fmt, count_size, entry_size, off_fmt = "<H", 2, 12, "<I"
        inline = 4
    elif magic == 43:
        size, zero, ifd_off = struct.unpack_from("<HHQ", data, 4)
        assert size == 8 and zero == 0
        count_fmt, count_size, entry_size, off_fmt = "<Q", 8, 20, "<Q"
        inline = 8
    else:
        raise AssertionError(f"not a TIFF: magic {magic}")

    (n_entries,) = struct.unpack_from(count_fmt, data, ifd_off)
    tags = {}
    pos = ifd_off + count_size
    for _ in range(n_entries):
        if magic == 42:
            tag, typ, cnt = struct.unpack_from("<HHI", data, pos)
            val_off = pos + 8
        else:
            tag, typ, cnt = struct.unpack_from("<HHQ", data, pos)
            val_off = pos + 12
        code, tsize = _TYPE[typ]
        total = cnt * tsize
        if total <= inline:
            payload = data[val_off : val_off + total]
        else:
            (off,) = struct.unpack_from(off_fmt, data, val_off)
            payload = data[off : off + total]
        if typ == 2:
            values = payload
        else:
            values = list(struct.unpack("<" + code * cnt, payload))
        tags[tag] = (typ, values)
        pos += entry_size
    (next_ifd,) = struct.unpack_from(off_fmt, data, pos)
    assert next_ifd == 0, "test reader handles single-IFD files only"

    def vals(tag, default=None):
        return tags[tag][1] if tag in tags else default

    w = vals(256)[0]
    h = vals(257)[0]
    n = vals(277, [1])[0]
    bps = vals(258)
    fmt = vals(339, [1] * n)
    assert vals(259, [1])[0] == 1, "compressed TIFF unsupported"
    planar = vals(284, [1])[0]
    rows_per_strip = vals(278, [h])[0]
    offsets = vals(273)
    counts = vals(279)
    assert len(set(bps)) == 1 and len(set(fmt)) == 1
    kind = {1: "u", 2: "i", 3: "f"}[fmt[0]]
    dtype = np.dtype(f"<{kind}{bps[0] // 8}")

    def rows_of(strips, width):
        """The strips' rows as one [rows, width] array: a view of the
        mapping where they follow each other in the file, else a copy."""
        if all(offsets[a] + counts[a] == offsets[b] for a, b in zip(strips, strips[1:])):
            total = sum(counts[i] for i in strips) // dtype.itemsize
            return np.frombuffer(data, dtype, total, offsets[strips[0]]).reshape(-1, width)
        return np.concatenate([np.frombuffer(data, dtype, counts[i] // dtype.itemsize,
                                             offsets[i]).reshape(-1, width) for i in strips])

    strips_per_plane = -(-h // rows_per_strip)
    planes = []
    if planar == 2:
        assert len(offsets) == strips_per_plane * n
        for p in range(n):
            planes.append(rows_of(range(p * strips_per_plane, (p + 1) * strips_per_plane), w))
            assert planes[-1].shape == (h, w)
    else:
        chunk = rows_of(range(len(offsets)), w * n).reshape(h, w, n)
        planes = [chunk[:, :, p] for p in range(n)]

    descs = [""] * n
    if 42112 in tags:
        xml = tags[42112][1].decode("utf-8", "replace")
        for m in re.finditer(
            r'<Item name="DESCRIPTION" sample="(\d+)"[^>]*>([^<]*)</Item>', xml
        ):
            descs[int(m.group(1))] = m.group(2)

    geokeys = {}
    if 34735 in tags:
        g = tags[34735][1]
        nkeys = g[3]
        for k in range(nkeys):
            kid, loc, cnt_, val = g[4 + 4 * k : 8 + 4 * k]
            if loc == 0:
                geokeys[kid] = val

    return {
        "bigtiff": magic == 43,
        "width": w,
        "height": h,
        "n": n,
        "dtype": dtype,
        "bands": {d or f"band{i}": a for i, (d, a) in enumerate(zip(descs, planes))},
        "descriptions": descs,
        "pixel_scale": vals(33550),
        "tiepoint": vals(33922),
        "geokeys": geokeys,
    }
