"""The operation and byte counts against counts made by hand."""

import pytest

from perfbench import counts, harness

DSEN2 = harness.load_cell("dsen2.tile").config["nets"]
VDSEN2 = harness.load_cell("vdsen2.roi").config["nets"]["2x"]


def test_patch_grids():
    # 2x: the 20 m raster is 5490 px, patch 64, border 4, stride 56:
    # 98 strides and an edge-flush patch per axis.
    assert counts.tile_patches(10980, 10980, DSEN2["2x"]) == 99 * 99
    # 6x: the 60 m raster is 1830 px, patch 32, border 2, stride 28: 65 + 1.
    assert counts.tile_patches(10980, 10980, DSEN2["6x"]) == 66 * 66
    # VDSen2 on a 3660 px ROI: 1830 px at 20 m, stride 56: 32 + 1.
    assert counts.tile_patches(3660, 3660, VDSEN2) == 33 * 33
    assert counts.grid_cells(112, 64, 4) == 2 and counts.grid_cells(113, 64, 4) == 3


def test_model_flops():
    # 2 * 9 * (10*128 + 12*128*128 + 128*6) per pixel.
    assert counts.conv_flops_per_px(DSEN2["2x"]) == 18 * (1280 + 196608 + 768) == 3575808
    assert counts.conv_flops_per_px(DSEN2["6x"]) == 18 * (12 * 128 + 196608 + 256)
    assert counts.tile_model_flops(10980, 10980, DSEN2["2x"]) == 9801 * 128 * 128 * 3575808
    # VDSen2: 2 * 9 * (10*256 + 64*256*256 + 256*6).
    assert counts.conv_flops_per_px(VDSEN2) == 18 * (2560 + 64 * 65536 + 1536)
    assert counts.train_step_flops(DSEN2["2x"], 128, 32) == 3 * 128 * 1024 * 3575808


def test_b1_work():
    flops, nbytes = counts.b1_work(10980, 10980, DSEN2["2x"], "high")
    per_patch = 128 * 128 * 2 * 9 * 128 * 128 * 2 * 6
    assert flops == 9801 * per_patch * 3
    weights = 6 * 2 * (9 * 128 * 128 + 128) * 4
    assert nbytes == 9801 * 2 * 128 * 128 * 128 * 4 + 154 * weights  # ceil(9801 / 64) calls
    assert counts.b1_work(10980, 10980, DSEN2["2x"], "default")[0] == flops // 3


def test_bound():
    t, by = counts.bound_s(989e12, 1.0)
    assert t == pytest.approx(1.0) and by == "operations"
    t, by = counts.bound_s(1.0, 3.35e12)
    assert t == pytest.approx(1.0) and by == "bytes"
