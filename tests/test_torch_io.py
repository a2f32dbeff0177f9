"""The port's host I/O copies against dsen2_tpu's: geo/utm.py, io/geotiff.py
and io/writers.py give the same numbers and byte-identical files, apart from
the two repairs (an EPSG code the GeoKeyDirectory cannot hold raises; the
writer's messages tell a missing GDAL from a driver that cannot create);
cli/convert_weights.py writes the JAX CLI's arrays; utils/profiling.py's
hooks time, trace and name spans."""

import sys
import types

import numpy as np
import pytest

from dsen2_tpu.geo import utm as jutm
from dsen2_tpu.io import geotiff as jgeotiff
from dsen2_tpu.io import writers as jwriters
from dsen2_tpu_torch.geo import utm as tutm
from dsen2_tpu_torch.io import geotiff as tgeotiff
from dsen2_tpu_torch.io import writers as twriters

from tiff_reader import read_tiff

WKT = ('PROJCS["WGS 84 / UTM zone 33N",GEOGCS["WGS 84",AUTHORITY["EPSG","4326"]],'
       'AUTHORITY["EPSG","32633"]]')
GEOT = (399960.0, 10.0, 0.0, 5000040.0, 0.0, -10.0)


def test_utm_is_a_verbatim_copy():
    with open(jutm.__file__, "rb") as a, open(tutm.__file__, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("lon,lat,zone,north", [
    (15.0, 45.0, 33, True), (12.3, 55.6, 33, True), (-70.6, -33.4, 19, False),
    (179.9, 0.1, 60, True), (2.35, 48.85, 31, True),
])
def test_utm_round_trip_equal(lon, lat, zone, north):
    e, n = tutm.utm_forward(lon, lat, zone, north)
    assert (e, n) == jutm.utm_forward(lon, lat, zone, north)
    assert tutm.utm_inverse(e, n, zone, north) == jutm.utm_inverse(e, n, zone, north)
    assert tutm.zone_from_epsg(32600 + zone) == jutm.zone_from_epsg(32600 + zone)


@pytest.mark.parametrize("wkt", [WKT, None, "", 'GEOGCS["x",ID["EPSG",4326]]', "LOCAL_CS[]"])
def test_epsg_from_wkt_equal(wkt):
    assert tgeotiff.epsg_from_wkt(wkt) == jgeotiff.epsg_from_wkt(wkt)


def _bands(dtype, n=3, h=37, w=23, seed=0):
    rng = np.random.default_rng(seed)
    return [(f"B{i}, <{i}> & co" if i else "", (rng.random((h, w)) * 9000).astype(dtype))
            for i in range(n)]


@pytest.mark.parametrize("dtype,kw", [
    (np.uint16, dict(geotransform=GEOT, projection_wkt=WKT)),
    (np.float32, dict(geotransform=GEOT, epsg=32633, rows_per_strip=5)),
    (np.float64, dict(projection_wkt=WKT, bigtiff=True)),
    (np.int16, dict(epsg=4326, rows_per_strip=1)),
    (np.float16, dict()),
])
def test_geotiff_files_byte_identical(tmp_path, dtype, kw):
    bands = _bands(dtype)
    a, b = tmp_path / "jax.tif", tmp_path / "port.tif"
    assert tgeotiff.write_geotiff(str(b), bands, **kw) == jgeotiff.write_geotiff(
        str(a), bands, **kw)
    assert a.read_bytes() == b.read_bytes()
    t = read_tiff(str(b))
    for (_, want), got in zip(bands, t["bands"].values()):
        np.testing.assert_array_equal(got, want.astype(got.dtype))


def test_geotiff_rejects_what_the_original_rejects(tmp_path):
    for kw in (dict(bands=[]), dict(bands=[("a", np.zeros((2, 2))), ("b", np.zeros((2, 3)))]),
               dict(bands=_bands(np.float32), geotransform=(0, 10, 1, 0, 0, -10))):
        for mod in (jgeotiff, tgeotiff):
            with pytest.raises(ValueError):
                mod.write_geotiff(str(tmp_path / "x.tif"), **kw)


@pytest.mark.parametrize("epsg", [102100, 0, -5])
def test_epsg_outside_the_geokey_range_raises(tmp_path, epsg):
    """The port raises a ValueError and writes no file. The original writes
    a GeoKeyDirectory that claims EPSG 0, or the code modulo 2^16 (another
    CRS) where numpy casts it, or fails in the cast with an OverflowError."""
    bands = _bands(np.float32, n=1)
    with pytest.raises(ValueError, match="GeoKeyDirectory"):
        tgeotiff.write_geotiff(str(tmp_path / "port.tif"), bands, epsg=epsg)
    assert not (tmp_path / "port.tif").exists()
    try:
        jgeotiff.write_geotiff(str(tmp_path / "jax.tif"), bands, epsg=epsg)
    except OverflowError:
        return
    assert read_tiff(str(tmp_path / "jax.tif"))["geokeys"][3072] == epsg % 65536


def test_writers_helpers_equal():
    assert twriters.shifted_geotransform(GEOT, 36, 72) == jwriters.shifted_geotransform(
        GEOT, 36, 72)
    assert twriters.list_creatable_formats() == jwriters.list_creatable_formats()


@pytest.mark.parametrize("fmt", ["GTiff", "npz", "ENVI"])
def test_write_bands_equal_without_gdal(tmp_path, capsys, fmt):
    bands = _bands(np.float32)
    outs = {}
    for name, mod in (("jax", jwriters), ("port", twriters)):
        path = tmp_path / f"{name}.out"
        used = mod.write_bands(str(path), bands, fmt, GEOT, WKT)
        outs[name] = (used, capsys.readouterr().out)
    assert outs["port"] == outs["jax"]
    if fmt == "GTiff":
        assert (tmp_path / "jax.out").read_bytes() == (tmp_path / "port.out").read_bytes()
    else:
        a = np.load(tmp_path / "jax.out.npz", allow_pickle=True)["bands"].item()
        b = np.load(tmp_path / "port.out.npz", allow_pickle=True)["bands"].item()
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


class _Driver:
    def __init__(self, create):
        self._create = create

    def GetMetadata(self):
        return {"DCAP_CREATE": "YES"} if self._create else {}


@pytest.mark.parametrize("driver,port_says", [
    (None, "GDAL has no GTiff driver"),
    (_Driver(create=False), "GDAL's GTiff driver cannot create files"),
])
def test_writer_message_tells_gdal_missing_from_driver_unable(tmp_path, capsys, monkeypatch,
                                                              driver, port_says):
    """With GDAL importable but its GTiff driver absent or unable to create,
    the original says "GDAL unavailable"; the port names the real cause.
    Both write the same file with the built-in writer."""
    gdal = types.ModuleType("osgeo.gdal")
    gdal.GetDriverByName = lambda name: driver
    gdal.DCAP_CREATE = "DCAP_CREATE"
    osgeo = types.ModuleType("osgeo")
    osgeo.gdal = gdal
    monkeypatch.setitem(sys.modules, "osgeo", osgeo)
    monkeypatch.setitem(sys.modules, "osgeo.gdal", gdal)
    bands = _bands(np.uint16)
    jwriters.write_bands(str(tmp_path / "jax.tif"), bands, "GTiff", GEOT, WKT)
    assert capsys.readouterr().out.startswith("GDAL unavailable;")
    twriters.write_bands(str(tmp_path / "port.tif"), bands, "GTiff", GEOT, WKT)
    assert capsys.readouterr().out == f"{port_says}; wrote GTiff with the built-in writer\n"
    assert (tmp_path / "jax.tif").read_bytes() == (tmp_path / "port.tif").read_bytes()


@pytest.mark.parametrize("src,dst,flags", [
    ("s2_032_lr_1e-04.npz", "out.npz", ()), ("s2_032_lr_1e-04.hdf5", "out.npz", ()),
    ("s2_030_lr_1e-05.npz", "out.hdf5", ("--run_60",)),
])
def test_convert_weights_matches_the_jax_cli(tmp_path, capsys, src, dst, flags):
    """Both CLIs convert the shipped DSen2 weights to the same arrays and
    print the same line; the port's .hdf5 is what the JAX package reads."""
    import os

    from dsen2_tpu.cli import convert_weights as j_cli
    from dsen2_tpu.core.config import dsen2_2x, dsen2_6x
    from dsen2_tpu.weights import load_keras_weights, load_params_npz
    from dsen2_tpu_torch.cli import convert_weights as t_cli

    models = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "models")
    outs, params = {}, {}
    for name, mod in (("jax", j_cli), ("port", t_cli)):
        out = tmp_path / f"{name}_{dst}"
        assert mod.main([os.path.join(models, src), str(out), *flags]) == 0
        outs[name] = capsys.readouterr().out.replace(str(out), "OUT")
        cfg = (dsen2_6x if flags else dsen2_2x)(False)
        params[name] = (load_params_npz(str(out)) if dst.endswith(".npz")
                        else load_keras_weights(str(out), cfg))
    assert outs["port"] == outs["jax"] and "params)" in outs["port"]
    for top, sub in params["jax"].items():
        for k, v in sub.items():
            np.testing.assert_array_equal(np.asarray(params["port"][top][k]), np.asarray(v))


def test_profiling_hooks(tmp_path, capsys):
    import glob
    import os

    import torch

    from dsen2_tpu_torch.utils.profiling import Timer, block_and_time, span, trace

    with Timer("t") as t:
        pass
    assert t.elapsed >= 0 and "Elapsed time:" in capsys.readouterr().out
    out, secs = block_and_time(lambda x: x * 2, torch.ones((8, 8)), repeats=2)
    assert secs > 0 and out[0, 0].item() == 2.0
    with trace(str(tmp_path)) as got:
        with span("region"):
            float(torch.ones((16, 16)).sum())
    files = [p for p in glob.glob(str(tmp_path / "**" / "*"), recursive=True)
             if os.path.isfile(p) and os.path.getsize(p) > 0]
    assert files == [got["path"]] and "region" in open(files[0]).read()
