"""The port's banded engine against dsen2_tpu's, on the CPU, at a tiny width
(2 blocks x 16 features) and precision "highest"."""

import inspect

import numpy as np
import pytest
import torch

from dsen2_tpu.core.config import InferConfig as JInferConfig
from dsen2_tpu.core.config import ModelConfig as JModelConfig
from dsen2_tpu.infer import api as japi
from dsen2_tpu.infer import engine as jengine
from dsen2_tpu.ops import tiling as jtiling
from dsen2_tpu_torch.core.config import InferConfig, ModelConfig
from dsen2_tpu_torch.infer import api, engine
from dsen2_tpu_torch.models import s2net
from dsen2_tpu_torch.ops.tiling import PatchGrid
from dsen2_tpu_torch.parallel.inference import plan_shard_bands
from dsen2_tpu_torch.utils.profiling import counters

CFG = ModelConfig(in_channels=(4, 6), num_layers=2, feature_size=16)
JCFG = JModelConfig(in_channels=(4, 6), num_layers=2, feature_size=16)
KW = dict(patch_size=32, border=4, batch_size=4, precision="highest")


def _params(seed):
    return s2net.init_params(torch.Generator().manual_seed(seed), CFG)


def _scene(seed, h, w, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [(rng.random((h, w, 4)) * 8000).astype(dtype),
            (rng.random((h // 2, w // 2, 6)) * 8000).astype(dtype)]


def _assert_close(got, want):
    """float32 at rtol 2e-4, atol 0.5 DN; integers within one quantum
    (values that straddle a half can round one DN apart)."""
    g, w = got.astype(np.float64), want.astype(np.float64)
    if np.issubdtype(got.dtype, np.integer):
        np.testing.assert_allclose(g, w, rtol=0, atol=1.0)
        assert np.mean(g == w) > 0.99
    else:
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=0.5)


@pytest.mark.parametrize("rows_per_band", [1, 2, 3, 5, 16, 100])
def test_plan_bands_and_windows_equal_jax(rows_per_band):
    for ny in range(1, 40):
        assert engine.plan_bands(ny, rows_per_band) == jengine.plan_bands(ny, rows_per_band)
    for geom in ((120, 96, 32, 4), (53, 40, 16, 2), (300, 30, 64, 8)):
        g, jg = PatchGrid(*geom), jtiling.PatchGrid(*geom)
        for r0, r1 in engine.plan_bands(len(g.starts_i), rows_per_band):
            assert engine.band_window_rows(g, r0, r1) == jengine.band_window_rows(jg, r0, r1)


def test_plan_bands_rejects_zero_rows():
    with pytest.raises(ValueError, match="rows_per_band"):
        engine.plan_bands(4, 0)


def _grid_case(head, flush):
    """Zero rasters, lr_factor, ModelConfig and InferConfig of a 2x or 6x
    tile whose grid does (flush) or does not end in an edge-flush row."""
    if head == "2x":
        h, w, lr, chans, patch, border = (152 if flush else 144), 72, 2, (4, 6), 32, 4
    else:
        h, w, lr, chans, patch, border = (228 if flush else 216), 108, 6, (4, 6, 2), 48, 6
    downs = (1, 2, 6)[: len(chans)]
    rasters = [np.zeros((h // d, w // d, c), np.uint16) for d, c in zip(downs, chans)]
    icfg = InferConfig(patch_size=patch, border=border, batch_size=5)
    return rasters, lr, ModelConfig(in_channels=chans, num_layers=2, feature_size=16), icfg


@pytest.mark.parametrize("planner,k", [("plan_bands", 1), ("plan_bands", 2), ("plan_bands", 16),
                                       ("plan_shard_bands", 1), ("plan_shard_bands", 3),
                                       ("plan_shard_bands", 8)])
@pytest.mark.parametrize("flush", [False, True])
@pytest.mark.parametrize("head", ["2x", "6x"])
def test_bands_tile_the_one_shot_schedule(head, flush, planner, k):
    """The bands of the engine's and the mesh's row splits, each put back at
    its y0 and its windows' w0, give the whole tile's schedule in order;
    each band's output rows end where the next band's begin, and the last
    band's at the tile's end."""
    rasters, lr, cfg, icfg = _grid_case(head, flush)
    plan = engine.plan_tile(rasters, lr, cfg, icfg)
    assert (plan.ny * plan.interior > plan.out_hw[0]) == flush
    n_in, batch = len(plan.grids), icfg.batch_size
    whole = plan.band(0, plan.ny, batch, windowed=False)
    want_starts = whole.starts.reshape(-1, n_in, 2)[: plan.ny * plan.nx]
    want_pos = whole.positions.reshape(-1, 2)[: plan.ny * plan.nx]
    if planner == "plan_bands":
        rows = engine.plan_bands(plan.ny, k)
    else:
        rows = plan_shard_bands(plan.ny, plan.interior, plan.out_hw[0], k)
    got_starts, got_pos, y_end = [], [], 0
    for r0, r1 in rows:
        band = plan.band(r0, r1, batch, windowed=True)
        if r0 == r1:
            assert band.band_h == 0 and band.starts is None
            continue
        m = (r1 - r0) * plan.nx
        assert band.starts.shape == (-(-m // batch), batch, n_in, 2)
        st, ps = band.starts.reshape(-1, n_in, 2), band.positions.reshape(-1, 2)
        assert (st[m:] == st[m - 1]).all() and (ps[m:] == ps[m - 1]).all()
        assert band.windows == tuple(engine.band_window_rows(g, r0, r1) for g in plan.grids)
        for i, (g, (w0, w1)) in enumerate(zip(plan.grids, band.windows)):
            assert st[:m, i, 0].min() == 0 and st[:m, i, 0].max() + g.patch == w1 - w0
        got_starts.append(st[:m] + np.asarray([[w0, 0] for w0, _ in band.windows]))
        got_pos.append(ps[:m] + np.asarray([band.y0, 0]))
        assert band.y0 == y_end
        y_end = band.y0 + band.band_h
    assert y_end == plan.out_hw[0]
    np.testing.assert_array_equal(np.concatenate(got_starts), want_starts)
    np.testing.assert_array_equal(np.concatenate(got_pos), want_pos)


@pytest.mark.parametrize("dtype", [np.uint16, np.float64])
@pytest.mark.parametrize("band", ["top", "interior", "bottom", "whole"])
def test_stage_window_is_the_padded_slice(dtype, band):
    rng = np.random.default_rng(5)
    raster = (rng.random((53, 37, 3)) * 60000).astype(dtype)
    grid = PatchGrid(53, 37, 16, 3)
    ny = len(grid.starts_i)
    r0, r1 = {"top": (0, 2), "interior": (1, 3), "bottom": (ny - 2, ny),
              "whole": (0, ny)}[band]
    w0, w1 = engine.band_window_rows(grid, r0, r1)
    got = engine.stage_window(raster, grid, w0, w1, torch.device("cpu"))
    want = np.pad(raster, ((3, 3), (3, 3), (0, 0)), mode="symmetric")[w0:w1]
    want = want.astype(api.staging_dtype(dtype))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("out_dtype", ["float32", "uint16"])
@pytest.mark.parametrize("rows_per_band,lookahead", [(2, 2), (2, 0), (1, 1), (100, 2)])
def test_sr_banded_matches_jax(out_dtype, rows_per_band, lookahead):
    """152 rows / 24 px interiors leave an edge-flush grid row, which
    rows_per_band=2 merges into the last band."""
    d10, d20 = _scene(11, 152, 96, np.uint16)
    params = _params(1)
    kw = dict(KW, output_dtype=out_dtype)
    want = jengine.sr_banded([d10, d20], 2, JCFG, params, JInferConfig(**kw),
                             rows_per_band=rows_per_band, stage_lookahead=lookahead)
    got = engine.sr_banded([d10, d20], 2, CFG, params, InferConfig(**kw),
                           rows_per_band=rows_per_band, stage_lookahead=lookahead,
                           device="cpu")
    assert got.shape == want.shape == (152, 96, 6) and got.dtype == want.dtype
    _assert_close(got, want)
    one_shot = api._run([d10, d20], 2, CFG, params, InferConfig(**kw), device="cpu")
    np.testing.assert_array_equal(got, one_shot)


def test_tensor_rasters_take_the_whole_raster_path():
    d10, d20 = _scene(12, 120, 72)
    params = _params(2)
    host = engine.sr_banded([d10, d20], 2, CFG, params, InferConfig(**KW), rows_per_band=2,
                            device="cpu")
    before = counters().get("engine.h2d_bytes", 0)
    tens = engine.sr_banded([torch.from_numpy(d10), torch.from_numpy(d20)], 2, CFG, params,
                            InferConfig(**KW), rows_per_band=2, device="cpu")
    assert counters().get("engine.h2d_bytes", 0) == before  # no window staged
    np.testing.assert_array_equal(tens, host)


def test_transfer_bytes_count_windows_and_bands():
    d10, d20 = _scene(13, 96, 72, np.uint16)
    params = _params(3)
    icfg = InferConfig(**KW, output_dtype="uint16")
    before = counters()
    out = engine.sr_banded([d10, d20], 2, CFG, params, icfg, rows_per_band=1, device="cpu")
    moved = {k: counters()[f"engine.{k}_bytes"] - before.get(f"engine.{k}_bytes", 0)
             for k in ("h2d", "d2h")}
    assert moved["d2h"] == out.nbytes == 96 * 72 * 6 * 2
    grids = api.build_grids([d10.shape, d20.shape], 2, icfg)
    want_h2d = sum(
        (w1 - w0) * (g.width + 2 * g.border) * r.shape[2] * 2
        for r, g in zip((d10, d20), grids)
        for w0, w1 in (engine.band_window_rows(g, r0, r1)
                       for r0, r1 in engine.plan_bands(len(g.starts_i), 1)))
    assert moved["h2d"] == want_h2d


def test_device_output_is_a_lazy_generator_that_reassembles(monkeypatch):
    calls = []
    orig = engine.sr_tile

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(engine, "sr_tile", spy)
    d10, d20 = _scene(14, 160, 96)
    params = _params(4)
    bands = engine.sr_banded([d10, d20], 2, CFG, params, InferConfig(**KW), rows_per_band=1,
                             device_output=True, device="cpu")
    assert inspect.isgenerator(bands) and calls == []
    first = next(bands)
    assert len(calls) == 2 and first[1] == 0  # band 0 and band 1 queued, no more
    rest = list(bands)
    assert len(rest) + 1 == len(calls)
    want = api._run([d10, d20], 2, CFG, params, InferConfig(**KW), device="cpu")
    out = np.full_like(want, np.nan)
    for band, y0, h in [first, *rest]:
        assert torch.is_tensor(band)
        out[y0 : y0 + h] = band.numpy()
    np.testing.assert_array_equal(out, want)


def test_stager_exception_propagates(monkeypatch):
    calls = []

    def boom(raster, grid, w0, w1, device):
        calls.append(1)
        raise RuntimeError("staging failed")

    monkeypatch.setattr(engine, "stage_window", boom)
    d10, d20 = _scene(15, 160, 96)
    with pytest.raises(RuntimeError, match="staging failed"):
        engine.sr_banded([d10, d20], 2, CFG, _params(5), InferConfig(**KW), rows_per_band=2,
                         device="cpu")
    assert calls


@pytest.mark.parametrize("out_dtype", ["float32", "uint16"])
def test_run_routes_large_host_outputs_to_sr_banded(monkeypatch, out_dtype):
    d10, d20 = _scene(16, 120, 96, np.uint16)
    params = _params(6)
    icfg = InferConfig(**KW, output_dtype=out_dtype)
    whole = api._run([d10, d20], 2, CFG, params, icfg, device="cpu")
    routed = []
    orig = engine.sr_banded
    monkeypatch.setattr(engine, "sr_banded", lambda *a, **kw: routed.append(1) or orig(*a, **kw))
    monkeypatch.setattr(api, "_BANDED_THRESHOLD_PX", 120 * 96)
    got = api._run([d10, d20], 2, CFG, params, icfg, device="cpu")
    assert routed == [1]
    np.testing.assert_array_equal(got, whole)
    # device output never goes banded
    dev = api._run([d10, d20], 2, CFG, params, icfg, device="cpu", device_output=True)
    assert routed == [1] and torch.is_tensor(dev)
    assert japi._BANDED_THRESHOLD_PX == 3000 * 3000


def test_pad_inputs_false_takes_prepadded_windows():
    """sr_tile with pad_inputs=False on the padded rasters and padded-space
    starts gives the mosaic sr_tile computes from the bare rasters."""
    d10, d20 = _scene(17, 96, 72)
    params = _params(7)
    icfg = InferConfig(**KW)
    plan = engine.plan_tile([d10, d20], 2, CFG, icfg)
    grids = plan.grids
    band = plan.band(0, plan.ny, 4, windowed=False)
    starts, pos = band.starts, band.positions
    tparams = api.params_to_torch(params, "cpu")
    common = dict(cfg=CFG, infer_cfg=icfg, grids=grids, out_hw=(96, 72))
    bare = api.sr_tile(tparams, (torch.from_numpy(d10), torch.from_numpy(d20)), starts, pos,
                       **common)
    padded = tuple(torch.from_numpy(np.pad(r, ((g.border,) * 2, (g.border,) * 2, (0, 0)),
                                           mode="symmetric"))
                   for r, g in zip((d10, d20), grids))
    pre = api.sr_tile(tparams, padded, starts, pos, pad_inputs=False, **common)
    np.testing.assert_array_equal(pre.numpy(), bare.numpy())


def test_integer_mosaic_is_two_bytes_wide():
    d10, d20 = _scene(18, 64, 64, np.uint16)
    icfg = InferConfig(**KW, output_dtype="uint16")
    dev = api._run([d10, d20], 2, CFG, _params(8), icfg, device="cpu", device_output=True)
    assert dev.dtype == torch.int16 and dev.element_size() == 2
    host = api._run([d10, d20], 2, CFG, _params(8), icfg, device="cpu")
    np.testing.assert_array_equal(host, dev.numpy().view(np.uint16))


@pytest.mark.parametrize("out_dtype", [np.uint16, np.int16, np.uint8, np.uint32, np.int32])
def test_quantize_then_host_view_round_trips(out_dtype):
    """Values above the signed range survive the narrow signed mosaic."""
    info = np.iinfo(out_dtype)
    v = np.float32([-3.0, 0.5, 1.5, 2.5, 127.5, 32767.5, 40000.0, 65534.5, 7e4, 3e9])
    got = api._host_view(api._quantize(torch.from_numpy(v), np.dtype(out_dtype)),
                         np.dtype(out_dtype))
    want = np.clip(np.round(v.astype(np.float64)), info.min, info.max).astype(out_dtype)
    assert got.dtype == out_dtype
    np.testing.assert_array_equal(got, want)


def test_engine_needs_a_gpu_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d10, d20 = _scene(19, 64, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.sr_banded([d10, d20], 2, CFG, _params(9), InferConfig(**KW))


def test_rows_per_band_validated_like_jax():
    d10, d20 = _scene(20, 64, 64)
    with pytest.raises(ValueError, match="rows_per_band"):
        engine.sr_banded([d10, d20], 2, CFG, _params(10), InferConfig(**KW), rows_per_band=0,
                         device="cpu")
