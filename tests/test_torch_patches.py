"""The port's patch-archive path against dsen2_tpu's: utils/native.py (the
native library and its numpy fallback), ops/tiling.recompose and
pad_patch_slack, the archive writers of data/patches_dataset.py, and the
create_patches CLI on a seeded .mat scene and a JP2 product. Archives match
bit for bit where the path is numpy only, and within rtol 1e-5 where the
Wald downsample runs (on the device in the port, through XLA in JAX)."""

import filecmp
import functools
import os

import h5py
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dsen2_tpu.cli import create_patches as j_cli
from dsen2_tpu.data import patches_dataset as jpd
from dsen2_tpu.data import safe_pil as jsafe_pil
from dsen2_tpu.ops import tiling as jtiling
from dsen2_tpu.utils import native as jnative
from dsen2_tpu_torch.cli import create_patches as t_cli
from dsen2_tpu_torch.data import patches_dataset as tpd
from dsen2_tpu_torch.ops import tiling as ttiling
from dsen2_tpu_torch.utils import native as tnative

from safe_product import build_safe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_native_library_builds_under_build_not_beside_the_source():
    assert tnative._SRC == jnative._SRC
    assert tnative._SO == os.path.join(REPO, "build", "native", "libdsen2_host.so")
    if tnative.get_lib() is not None:
        assert os.path.isfile(tnative._SO)


@pytest.fixture(params=["native", "numpy"])
def native_mode(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(tnative, "get_lib", lambda: None)
    return request.param


@pytest.mark.parametrize("hwc,patch,border", [((37, 29, 3), 16, 4), ((12, 12, 6), 12, 0),
                                              ((40, 52, 4), 20, 6)])
def test_native_host_ops_equal(native_mode, hwc, patch, border):
    rng = np.random.default_rng(3)
    img = rng.random(hwc, dtype=np.float32)
    grid = ttiling.PatchGrid(hwc[0], hwc[1], patch, border)
    starts = grid.flat_starts()
    np.testing.assert_array_equal(tnative.symmetric_pad(img, border),
                                  jnative.symmetric_pad(img, border))
    got = tnative.pad_extract_host(img, starts, patch, border)
    np.testing.assert_array_equal(got, jnative.pad_extract_host(img, starts, patch, border))
    padded = jnative.symmetric_pad(img, border)
    np.testing.assert_array_equal(tnative.extract_patches_host(padded, starts, patch), got)
    pos = ttiling.recompose_positions(hwc[:2], patch - 2 * border)
    np.testing.assert_array_equal(
        tnative.recompose_host(got, border, hwc[:2], pos),
        jnative.recompose_host(got, border, hwc[:2], pos))


@pytest.mark.parametrize("hw,p,border,c,extra", [
    ((50, 50), 16, 4, 3, 0),   # edge-flush patches overlap the last column and row
    ((24, 40), 12, 2, 2, 5),   # non-square, with trailing slack slots
    ((16, 16), 16, 0, 4, 0),   # one interior exactly covering the image
    ((8, 8), 8, 0, 1, 0),      # the single-patch short circuit
])
def test_recompose_equals_jax(hw, p, border, c, extra):
    s = p - 2 * border
    n = len(ttiling.recompose_positions(hw, s)) + extra
    patches = np.random.default_rng(4).random((n, p, p, c), dtype=np.float32)
    want = np.asarray(jtiling.recompose(jnp.asarray(patches), border, hw))
    got = ttiling.recompose(torch.from_numpy(patches), border, hw)
    np.testing.assert_array_equal(got.numpy(), want)
    base = np.full(hw + (c,), 7.0, np.float32)
    out = torch.from_numpy(base.copy())
    got = ttiling.recompose(torch.from_numpy(patches), border, hw, out=out)
    want = np.asarray(jtiling.recompose(jnp.asarray(patches), border, hw, out=jnp.asarray(base)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("hw,p,border,n", [((10, 10), 16, 2, 1), ((50, 50), 16, 4, 3)])
def test_recompose_raises_like_jax(hw, p, border, n):
    patches = np.zeros((n, p, p, 1), np.float32)
    with pytest.raises(ValueError, match="recompose") as want:
        jtiling.recompose(jnp.asarray(patches), border, hw)
    with pytest.raises(ValueError, match="recompose") as got:
        ttiling.recompose(torch.from_numpy(patches), border, hw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("geom", [(60, 54, 32, 4), (48, 48, 16, 2), (13, 29, 8, 1)])
def test_pad_patch_slack_equals_jax(geom):
    tg, jg = ttiling.PatchGrid(*geom), jtiling.PatchGrid(*geom)
    assert tg.slack_patches == jg.slack_patches
    patches = np.random.default_rng(5).random((tg.num_patches, 3, 3, 2), dtype=np.float32)
    got, want = ttiling.pad_patch_slack(patches, tg), jtiling.pad_patch_slack(patches, jg)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_interp_and_random_crops_equal():
    patches = np.random.default_rng(6).random((5, 16, 16, 6), dtype=np.float32) * 9000
    np.testing.assert_array_equal(tpd.interp_patches_host(patches, (32, 32)),
                                  jpd.interp_patches_host(patches, (32, 32)))
    for seed in (0, 9):
        np.testing.assert_array_equal(
            tpd._random_crops(np.random.default_rng(seed), 50, (40, 33), 16),
            jpd._random_crops(np.random.default_rng(seed), 50, (40, 33), 16))
    for mod in (tpd, jpd):
        with pytest.raises(ValueError, match="smaller than the crop size"):
            mod._random_crops(np.random.default_rng(0), 1, (8, 40), 16)


def _scene(h10, seed):
    rng = np.random.default_rng(seed)
    return tuple((rng.random((h10 // f, h10 // f, c)) * 9000).astype(np.float32)
                 for f, c in ((1, 4), (2, 6), (6, 2)))


def _assert_trees_equal(a, b, exact=lambda rel: True):
    """Every file under `a` is under `b`: .npy arrays bit-equal where
    exact(relative path), else within rtol 1e-5; other files byte-equal."""
    names = sorted(os.path.relpath(os.path.join(r, f), a) for r, _, fs in os.walk(a) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(r, f), b)
                           for r, _, fs in os.walk(b) for f in fs)
    assert names
    for rel in names:
        x, y = os.path.join(a, rel), os.path.join(b, rel)
        if not rel.endswith(".npy"):
            assert filecmp.cmp(x, y, shallow=False), rel
            continue
        want, got = np.load(x), np.load(y)
        assert (got.dtype, got.shape) == (want.dtype, want.shape), rel
        if exact(rel):
            np.testing.assert_array_equal(got, want, err_msg=rel)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0, err_msg=rel)


def test_writers_bit_equal(tmp_path):
    d10, d20, d60 = _scene(216, 7)
    for name, mod in (("jax", jpd), ("port", tpd)):
        out = tmp_path / name
        mod.save_random_patches(d20, d10, d20[:54, :54], str(out / "r2"), n_crops=40, seed=3)
        mod.save_random_patches60(d10[:, :, :2], d10, d20, d60, str(out / "r6"), n_crops=12,
                                  seed=4, patch_60=6)
        mod.save_test_patches(d10, d20, str(out / "t2"), patch_size=64, border=4)
        mod.save_test_patches60(d10, d20, d60, str(out / "t6"), patch_size=96, border=12)
    _assert_trees_equal(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_open_data_files_test_stream_equal(tmp_path):
    d10, d20, d60 = _scene(216, 8)
    jpd.save_test_patches60(d10, d20, d60, str(tmp_path), patch_size=96, border=12)
    (tmp_path / "roi.json").write_text("[0, 0, 216, 180]")
    for batch in (1, 7):
        t = tpd.open_data_files_test_stream(str(tmp_path), True, 2000, batch_size=batch)
        j = jpd.open_data_files_test_stream(str(tmp_path), True, 2000, batch_size=batch)
        assert t[1:] == j[1:]
        tb, jb = list(t[0]), list(j[0])
        assert len(tb) == len(jb)
        for x, y in zip(tb, jb):
            for a, b in zip(x, y):
                np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def mat_scene(tmp_path_factory):
    """A seeded MATLAB v7.3 (HDF5) scene of 576^2 px, which both packages
    read: channel-first on disk, as MATLAB writes it."""
    path = tmp_path_factory.mktemp("mat") / "SYNTH_T00XXX.mat"
    with h5py.File(path, "w") as f:
        for name, arr in zip(("im10", "im20", "im60"), _scene(576, 9)):
            f[name] = arr.transpose()
    return str(path)


@pytest.fixture
def fewer_crops(monkeypatch):
    """The CLI draws the reference's 8000 (2x) and 500 (6x) random crops per
    tile; both packages draw 400 and 60 here, from the same code."""
    for mod in (jpd, tpd):
        monkeypatch.setattr(mod, "save_random_patches",
                            functools.partial(mod.save_random_patches, n_crops=400))
        monkeypatch.setattr(mod, "save_random_patches60",
                            functools.partial(mod.save_random_patches60, n_crops=60))


def _both(argv, tmp_path, capsys):
    outs = {}
    for name, main, kw in (("jax", j_cli.main, {}), ("port", t_cli.main, {"device": "cpu"})):
        prefix = str(tmp_path / name) + "/"
        assert main([str(a) for a in argv] + ["--save_prefix", prefix], **kw) == 0
        outs[name] = capsys.readouterr().out.replace(prefix, "PREFIX/")
    assert outs["port"] == outs["jax"]
    return str(tmp_path / "jax"), str(tmp_path / "port")


def _gt_only(rel):
    return os.path.basename(rel).endswith("_gt.npy")


@pytest.mark.parametrize("flags", [(), ("--run_60",)])
def test_create_patches_train_and_val_index(mat_scene, tmp_path, capsys, fewer_crops, flags):
    """Random training crops (the same crops: the labels, cut from the
    original rasters, are bit-equal), then --make-val-index."""
    a, b = _both([mat_scene, "--seed", "5", *flags], tmp_path, capsys)
    _assert_trees_equal(a, b, exact=_gt_only)
    for name, main, kw in (("jax", j_cli.main, {}), ("port", t_cli.main, {})):
        assert main(["--make-val-index", "--save_prefix", str(tmp_path / name) + "/",
                     "--seed", "2", *flags], **kw) == 0
    assert capsys.readouterr().out.count("validation slots") == 2
    _assert_trees_equal(a, b, exact=lambda rel: _gt_only(rel) or rel.endswith("val_index.npy"))


@pytest.mark.parametrize("flags", [("--test_data",), ("--test_data", "--run_60")])
def test_create_patches_test_archives(mat_scene, tmp_path, capsys, flags):
    a, b = _both([mat_scene, *flags], tmp_path, capsys)
    _assert_trees_equal(a, b, exact=_gt_only)


def test_create_patches_true_data_is_bit_equal(mat_scene, tmp_path, capsys):
    """--true_data runs no Wald downsample: numpy only, bit for bit."""
    a, b = _both([mat_scene, "--true_data"], tmp_path, capsys)
    _assert_trees_equal(a, b)


def test_create_patches_write_images(mat_scene, tmp_path, capsys):
    pytest.importorskip("imageio")
    import imageio.v2 as imageio

    a, b = _both([mat_scene, "--write_images"], tmp_path, capsys)
    for name in ("SYNTH_T00XXX.SAFERGB.png", "SYNTH_T00XXX.SAFERGB20.png"):
        want = imageio.imread(os.path.join(a, "raw", "rgbs", name)).astype(int)
        got = imageio.imread(os.path.join(b, "raw", "rgbs", name)).astype(int)
        assert got.shape == want.shape and np.abs(got - want).max() <= 1


@pytest.mark.skipif(not jsafe_pil.available(), reason="Pillow lacks JPEG-2000")
@pytest.mark.parametrize("flags", [("--test_data",), ("--seed", "1")])
def test_create_patches_from_a_jp2_product(tmp_path, capsys, fewer_crops, flags):
    mtd, _ = build_safe(tmp_path / "in", np.random.default_rng(852), h10=360)
    a, b = _both([os.path.dirname(mtd), "--roi_x_y", "0,0,287,287", *flags], tmp_path, capsys)
    _assert_trees_equal(a, b, exact=_gt_only)


def test_create_patches_needs_a_gpu_unless_told(mat_scene, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_cli.main([mat_scene, "--save_prefix", str(tmp_path) + "/"])
    assert not os.listdir(tmp_path)
