"""The port's SAFE reader and production CLI against dsen2_tpu's, on real
synthetic products (tests/safe_product.py: JP2 band files and MTD_TL.xml):
read_safe gives bit-equal arrays, ROI, geotransform and projection through
the Pillow backend, single- and two-zone; s2_supres at full DSen2 width agrees
with the JAX CLI within the mosaic parity and prints the same lines; and the
two safe_pil repairs (window checks, no plane kept after its window is read)."""

import dataclasses
import gc
import os
import weakref

import numpy as np
import pytest
import torch

from dsen2_tpu.cli import s2_supres as j_cli
from dsen2_tpu.data import safe_pil as jsafe_pil
from dsen2_tpu.data import safe_reader as jreader
from dsen2_tpu.geo.utm import utm_inverse
from dsen2_tpu_torch.cli import s2_supres as t_cli
from dsen2_tpu_torch.data import safe_pil as tsafe_pil
from dsen2_tpu_torch.data import safe_reader as treader

from safe_product import add_granule, build_safe
from tiff_reader import read_tiff

pytestmark = pytest.mark.skipif(not jsafe_pil.available(), reason="Pillow lacks JPEG-2000")


@pytest.fixture(scope="module")
def product(tmp_path_factory):
    mtd, arrays = build_safe(tmp_path_factory.mktemp("safe"), np.random.default_rng(850), h10=360)
    return mtd, arrays


@pytest.fixture(scope="module")
def two_zone(tmp_path_factory):
    """A multi-granule product over two UTM zones of different sizes."""
    rng = np.random.default_rng(851)
    mtd, _ = build_safe(tmp_path_factory.mktemp("safe2"), rng, h10=360, epsg=32633)
    add_granule(os.path.dirname(mtd), rng, h10=120, epsg=32634, tile="T34VCH",
                ulx=300000.0, uly=6200040.0, stamp="20170527T101032")
    return mtd


def _lonlat(x1, y1, x2, y2):
    """WGS84 corners of half-pixel offsets on the product's 10 m grid."""
    ulx, uly = 399960.0, 5000040.0
    return (*utm_inverse(ulx + (x1 + 0.5) * 10, uly - (y1 + 0.5) * 10, 33, True),
            *utm_inverse(ulx + (x2 + 0.5) * 10, uly - (y2 + 0.5) * 10, 33, True))


def _assert_tiles_equal(a, b):
    for name in ("data10", "data20", "data60"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
    for name in ("bands10", "bands20", "bands60"):
        assert [dataclasses.asdict(v) for v in getattr(a, name)] == [
            dataclasses.asdict(v) for v in getattr(b, name)], name
    assert dataclasses.asdict(a.roi) == dataclasses.asdict(b.roi)
    for name in ("geotransform", "projection", "descriptions", "utm", "utm_coverage"):
        assert getattr(a, name) == getattr(b, name), name


READS = {
    "full": dict(),
    "roi": dict(roi_x_y=(6, 6, 101, 101), run_60=True),
    "roi_clamped_grid36": dict(roi_x_y=(-40, 10, 500, 250), snap_grid=36),
    "lonlat": dict(roi_lon_lat=_lonlat(12, 12, 131, 101), run_60=True),
    "bands": dict(select_bands=["B2", "B8A", "B9"], run_60=True),
}


@pytest.mark.parametrize("case", sorted(READS))
def test_read_safe_bit_equal(product, case):
    mtd, _ = product
    _assert_tiles_equal(treader.read_safe(mtd, **READS[case]), jreader.read_safe(mtd, **READS[case]))


@pytest.mark.parametrize("kw", [dict(), dict(select_utm_zone="UTM 34N", run_60=True),
                                dict(select_utm_zone="UTM 35N"), dict(roi_x_y=(0, 0, 59, 59))])
def test_read_safe_two_zones_bit_equal(two_zone, kw):
    t, j = treader.read_safe(two_zone, **kw), jreader.read_safe(two_zone, **kw)
    _assert_tiles_equal(t, j)
    if kw.get("select_utm_zone") == "UTM 34N":
        assert t.utm == "UTM 34N" and t.data10.shape == (120, 120, 4)


@pytest.mark.parametrize("kw", [dict(), dict(roi_x_y=(0, 0, 100, 100)),
                                dict(roi_lon_lat=_lonlat(0, 0, 50, 50))])
def test_scan_utm_zones_equal(two_zone, kw):
    assert treader.scan_utm_zones(two_zone, **kw) == jreader.scan_utm_zones(two_zone, **kw)


def test_subdatasets_and_errors_equal(product, tmp_path):
    mtd, _ = product
    subs = tsafe_pil.open_product(mtd)[0].Open(mtd).GetSubDatasets()
    assert subs == jsafe_pil.open_product(mtd)[0].Open(mtd).GetSubDatasets()
    assert tsafe_pil.looks_like_safe(mtd) and not tsafe_pil.looks_like_safe(str(tmp_path))
    for mod in (jreader, treader):
        with pytest.raises(ImportError, match="requires GDAL"):
            mod.read_safe(str(tmp_path / "scene.tif"))


def _ds10(mod, mtd):
    shim, _ = mod.open_product(mtd)
    name = next(n for n, d in shim.Open(mtd).GetSubDatasets() if "10m" in d)
    return shim.Open(name)


@pytest.mark.parametrize("window", [(-1, 0, 10, 10), (0, -6, 10, 10), (350, 0, 20, 10),
                                    (0, 355, 10, 10)])
def test_window_outside_the_raster_raises(product, window):
    """GDAL refuses such windows; the original slices with numpy instead and
    returns other pixels or another shape. The port raises."""
    mtd, _ = product
    xoff, yoff, xsize, ysize = window
    with pytest.raises(ValueError, match="outside"):
        _ds10(tsafe_pil, mtd).ReadAsArray(xoff, yoff, xsize, ysize)
    got = _ds10(jsafe_pil, mtd).ReadAsArray(xoff, yoff, xsize, ysize)
    assert got.shape != (4, ysize, xsize)


def test_window_inside_the_raster_equal(product):
    mtd, arrays = product
    got = _ds10(tsafe_pil, mtd).ReadAsArray(12, 30, 300, 330)
    np.testing.assert_array_equal(got, _ds10(jsafe_pil, mtd).ReadAsArray(12, 30, 300, 330))
    np.testing.assert_array_equal(got[0], arrays["B4"][30:, 12:312])
    with pytest.raises(ValueError, match="outside"):
        _ds10(tsafe_pil, mtd).ReadAsArray(0, 0, 0, 5)


def _planes_alive_at_each_decode(mod, reader, mtd, monkeypatch):
    """read_safe with every decoded plane tracked: for each decode, how many
    earlier planes are still alive."""
    refs, alive = [], []
    decode = mod._PilSubdataset._plane

    def tracked(self, band):
        gc.collect()
        alive.append(sum(r() is not None for r in refs))
        plane = decode(self, band)
        refs.append(weakref.ref(plane))
        return plane

    monkeypatch.setattr(mod._PilSubdataset, "_plane", tracked)
    reader.read_safe(mtd, roi_x_y=(0, 0, 35, 35), run_60=True)
    return alive


def test_planes_are_released_once_their_window_is_read(product, monkeypatch):
    """The original keeps all 13 decoded planes while it reads (on a 10980^2
    product about 1.3 GB); the port keeps none once its window is copied."""
    mtd, _ = product
    assert _planes_alive_at_each_decode(tsafe_pil, treader, mtd, monkeypatch) == [0] * 13
    assert _planes_alive_at_each_decode(jsafe_pil, jreader, mtd, monkeypatch) == list(range(13))


def _cli(mod, argv, where, monkeypatch, capsys, **kw):
    os.makedirs(where, exist_ok=True)
    monkeypatch.chdir(where)
    assert mod.main([str(a) for a in argv], **kw) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("mesh", [(), ("--mesh", "2")])
def test_s2_supres_matches_the_jax_cli_at_full_width(product, tmp_path, monkeypatch, capsys,
                                                     mesh):
    """The same JP2 product at a 240^2 ROI with --run_60, DSen2 at full
    width with the shipped weights: the same printed lines, the same
    georeferencing, SR bands within the mosaic parity (rtol 2e-4, 0.5 DN).
    With --mesh 2 the port shards over two repeats of the CPU, the JAX CLI
    over two of its virtual CPU devices."""
    mtd, _ = product
    argv = [mtd, "out.tif", "--roi_x_y", "0,0,239,239", "--run_60", *mesh]
    want_out = _cli(j_cli, argv, tmp_path / "jax", monkeypatch, capsys)
    got_out = _cli(t_cli, argv, tmp_path / "port", monkeypatch, capsys, device="cpu")
    assert got_out == want_out
    want, got = read_tiff(str(tmp_path / "jax" / "out.tif")), read_tiff(
        str(tmp_path / "port" / "out.tif"))
    for key in ("bigtiff", "width", "height", "n", "dtype", "descriptions", "pixel_scale",
                "tiepoint", "geokeys"):
        assert got[key] == want[key], key
    assert got["geokeys"][3072] == 32633 and got["n"] == 8
    for name, w in want["bands"].items():
        np.testing.assert_allclose(got["bands"][name], w, rtol=2e-4, atol=0.5, err_msg=name)


@pytest.mark.parametrize("flags", [("--list_bands", "--run_60"), ("--list_UTM",),
                                   ("--list_UTM", "--roi_x_y", "0,0,100,100"),
                                   ("--list_bands", "--select_UTM", "UTM 34N", "--mesh", "1"),
                                   ("--list_output_file_formats",)])
def test_listings_equal(two_zone, tmp_path, monkeypatch, capsys, flags):
    """Listing needs no device: the port runs it without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [two_zone, *flags]
    want = _cli(j_cli, argv, tmp_path, monkeypatch, capsys)
    assert _cli(t_cli, argv, tmp_path, monkeypatch, capsys) == want


def test_mesh_raises_naming_a12(product, tmp_path, monkeypatch):
    """--mesh 2 on a machine with one GPU and no device= raises the JAX
    package's too-few-devices error, before the product is read."""
    import jax

    from dsen2_tpu.parallel import make_mesh as j_make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(treader, "read_safe", None)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError) as mine:
        t_cli.main([product[0], "out.tif", "--mesh", "2"])
    with pytest.raises(ValueError) as theirs:
        j_make_mesh(jax.devices()[:1], data=2)
    assert str(mine.value) == str(theirs.value) == "mesh 2x1 needs 2 devices, have 1"


def test_s2_supres_needs_a_gpu_unless_told(product, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_cli.main([product[0], "out.tif", "--roi_x_y", "0,0,239,239"])
    assert not (tmp_path / "out.tif").exists()
