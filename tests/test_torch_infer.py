"""The port's inference API and weights against dsen2_tpu's, on the CPU, with
the shipped DSen2 weights."""

import os
import warnings

import numpy as np
import pytest
import torch

import dsen2_tpu
from dsen2_tpu.core.config import InferConfig as JInferConfig
from dsen2_tpu.infer import api as japi
from dsen2_tpu.weights import load_keras_weights as j_load_keras
from dsen2_tpu.weights import load_params_npz as j_load_npz
from dsen2_tpu.weights import save_params_npz as j_save_npz
from dsen2_tpu_torch import dsen2_20, dsen2_60
from dsen2_tpu_torch.core.config import InferConfig, dsen2_2x, dsen2_6x
from dsen2_tpu_torch.infer import api, engine
from dsen2_tpu_torch.models import s2net
from dsen2_tpu_torch import weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "models")
NPZ_2X = os.path.join(MODELS, "s2_032_lr_1e-04.npz")
NPZ_6X = os.path.join(MODELS, "s2_030_lr_1e-05.npz")


def _scene(rng, h10, n_lr, dtype):
    shapes = [(h10, h10, 4), (h10 // 2, h10 // 2, 6), (h10 // 6, h10 // 6, 2)][:n_lr]
    return [(rng.random(s) * 9000).astype(dtype) for s in shapes]


def _assert_close(got, want):
    """f32 convs and mosaic against JAX's, values O(9000): rtol 2e-4, atol
    0.5 DN (tests/test_infer.py:67). Integer output rounds both: values
    that agree within that can round one DN apart where they straddle a
    half, so the bound there is one quantum, and nearly all are equal."""
    g, w = got.astype(np.float64), want.astype(np.float64)
    if np.issubdtype(got.dtype, np.integer):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=1.0)
        assert np.mean(g == w) > 0.99
    else:
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=0.5)


@pytest.mark.parametrize("out_dtype", ["float32", "uint16"])
@pytest.mark.parametrize("in_dtype", [np.float32, np.uint16])
def test_dsen2_20_matches_jax_highest(rng, out_dtype, in_dtype):
    d10, d20 = _scene(rng, 56, 2, in_dtype)
    params = weights.load_params_npz(NPZ_2X)
    kw = dict(patch_size=32, border=4, batch_size=3, precision="highest", output_dtype=out_dtype)
    want = dsen2_tpu.dsen2_20(d10, d20, params=params, infer_cfg=JInferConfig(**kw))
    got = dsen2_20(d10, d20, params=params, infer_cfg=InferConfig(**kw), device="cpu")
    assert got.shape == want.shape == (56, 56, 6) and got.dtype == want.dtype
    _assert_close(got, want)


@pytest.mark.parametrize("out_dtype", ["float32", "uint16"])
def test_dsen2_60_matches_jax_highest(rng, out_dtype):
    d10, d20, d60 = _scene(rng, 72, 3, np.uint16)
    params = weights.load_params_npz(NPZ_6X)
    kw = dict(patch_size=48, border=6, batch_size=2, precision="highest", output_dtype=out_dtype)
    want = dsen2_tpu.dsen2_60(d10, d20, d60, params=params, infer_cfg=JInferConfig(**kw))
    got = dsen2_60(d10, d20, d60, params=params, infer_cfg=InferConfig(**kw), device="cpu")
    assert got.shape == want.shape == (72, 72, 2) and got.dtype == want.dtype
    _assert_close(got, want)


def test_bf16_compute_dtype_tracks_jax(rng):
    """compute_dtype="bfloat16" casts params and activations to bf16 in both
    packages; bf16 keeps ~3 significant digits, so hold them within 2 % of
    the output's magnitude."""
    d10, d20 = _scene(rng, 56, 2, np.uint16)
    params = weights.load_params_npz(NPZ_2X)
    kw = dict(patch_size=32, border=4, batch_size=4, precision="highest",
              compute_dtype="bfloat16")
    want = dsen2_tpu.dsen2_20(d10, d20, params=params, infer_cfg=JInferConfig(**kw))
    got = dsen2_20(d10, d20, params=params, infer_cfg=InferConfig(**kw), device="cpu")
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())


def test_integer_output_rounds_half_to_even_then_clips(rng, monkeypatch):
    """uint16 output: round half to even (as jnp.round), then clip."""
    cands = np.arange(-3, 12, dtype=np.float32) + np.float32(0.5)
    preds = cands / np.float32(2000.0)
    exact = cands[preds * np.float32(2000.0) == cands]  # products that stay at .5
    values = np.concatenate([exact, np.float32([70000.0, -9.0])])

    def fake_apply(params, net_in, cfg, **kw):
        b, p = net_in[0].shape[:2]
        flat = np.resize(values / np.float32(2000.0), (b, p, p, cfg.out_channels))
        return torch.from_numpy(flat.astype(np.float32))

    monkeypatch.setattr(api.s2net, "apply", fake_apply)
    d10, d20 = _scene(rng, 16, 2, np.uint16)
    params = s2net.init_params(torch.Generator(), dsen2_2x())
    cfg = InferConfig(patch_size=16, border=0, batch_size=1, output_dtype="uint16")
    got = dsen2_20(d10, d20, params=params, infer_cfg=cfg, device="cpu")
    want = np.clip(np.round(np.resize(values, (16, 16, 6)).astype(np.float32)), 0, 65535)
    np.testing.assert_array_equal(got, want.astype(np.uint16))
    assert np.any(exact % 2 == 0.5) and got.dtype == np.uint16


def test_schedule_and_grids_match(rng):
    shapes = [(120, 108, 4), (60, 54, 6)]
    for cfg in (InferConfig(patch_size=64, border=8), InferConfig(patch_size=32, border=4)):
        jcfg = JInferConfig(patch_size=cfg.patch_size, border=cfg.border)
        tg, jg = api.build_grids(shapes, 2, cfg), japi.build_grids(shapes, 2, jcfg)
        assert [g.__dict__ for g in tg] == [g.__dict__ for g in jg]
        interior = cfg.patch_size - 2 * cfg.border
        plan = engine.plan_tile([np.zeros(s, np.float32) for s in shapes], 2, dsen2_2x(), cfg)
        assert [g.__dict__ for g in plan.grids] == [g.__dict__ for g in jg]
        for batch in (1, 3, 64):
            a = plan.band(0, plan.ny, batch, windowed=False)
            b = japi._prepare_schedule(jg, (120, 108), interior, batch)
            np.testing.assert_array_equal(a.starts, b[0])
            np.testing.assert_array_equal(a.positions, b[1])
            assert a.starts.shape[0] == a.positions.shape[0] == b[2]
            assert (a.y0, a.band_h, a.windows) == (0, 120, None)


def test_staging_keeps_compact_dtypes():
    for dt in (np.uint8, np.int8, np.uint16, np.int16, np.float16, np.float32, np.float64,
               np.int32):
        assert api.staging_dtype(dt) == japi.staging_dtype(dt), dt
    r = np.array([[[0, 1, 65535]]], np.uint16)
    staged = api.stage_raster(r, "cpu")
    assert staged.dtype == torch.uint16
    np.testing.assert_array_equal(api._cast(staged, torch.float32).numpy(), r.astype(np.float32))


@pytest.mark.parametrize("case", ["bands", "align", "small", "rank"])
def test_validate_inputs_rejects_like_jax(case):
    d10, d20 = np.zeros((48, 48, 4), np.float32), np.zeros((24, 24, 6), np.float32)
    cfg = InferConfig(patch_size=32, border=4)
    if case == "bands":
        d20 = np.zeros((24, 24, 5), np.float32)
    elif case == "align":
        d20 = np.zeros((25, 24, 6), np.float32)
    elif case == "small":
        cfg = InferConfig(patch_size=128, border=8)
    else:
        d10 = d10[..., 0]
    with pytest.raises(ValueError) as mine:
        api._validate_inputs([d10, d20], 2, dsen2_2x(), cfg)
    with pytest.raises(ValueError) as theirs:
        japi._validate_inputs([d10, d20], 2, dsen2_tpu.dsen2_2x(),
                              JInferConfig(patch_size=cfg.patch_size, border=cfg.border))
    assert str(mine.value).split(":")[0] == str(theirs.value).split(":")[0]


def test_unported_options_raise():
    """An output_dtype outside the port's set raises, and so does a device=
    that is not the mesh's first device."""
    from dsen2_tpu_torch.parallel import make_mesh

    d10, d20 = np.zeros((48, 48, 4), np.float32), np.zeros((24, 24, 6), np.float32)
    with pytest.raises(NotImplementedError, match="output_dtype"):
        dsen2_20(d10, d20, infer_cfg=InferConfig(patch_size=32, border=4,
                                                 output_dtype="complex64"), device="cpu")
    with pytest.raises(ValueError, match="mesh's first device"):
        dsen2_20(d10, d20, mesh=make_mesh([torch.device("cpu")] * 2), device="meta")


def _bf16_run(d10, d20, params, out_dtype="bfloat16"):
    kw = dict(patch_size=32, border=4, batch_size=3, precision="highest", output_dtype=out_dtype)
    want = dsen2_tpu.dsen2_20(d10, d20, params=params, infer_cfg=JInferConfig(**kw))
    got = dsen2_20(d10, d20, params=params, infer_cfg=InferConfig(**kw), device="cpu")
    return got, want


def test_bfloat16_output_bit_equal_to_jax(rng):
    """Zero kernels, random biases and 20 m values in {0, 30000, 60000}
    (multiples of INTERP_NORM) make every f32 step exact in both packages
    (the bilinear sums hold few bits; the rest is elementwise), so the
    bfloat16 mosaics, rounded to nearest even from f32, agree bit for bit."""
    ml_dtypes = pytest.importorskip("ml_dtypes")
    d10 = (rng.random((56, 56, 4)) * 9000).astype(np.uint16)
    d20 = (rng.integers(0, 3, (28, 28, 6)) * 30000).astype(np.uint16)
    shipped = weights.load_params_npz(NPZ_2X)
    params = {top: {k: np.zeros_like(v) if k.startswith("w") else
                    rng.standard_normal(v.shape).astype(np.float32)
                    for k, v in sub.items()} for top, sub in shipped.items()}
    got, want = _bf16_run(d10, d20, params)
    assert got.dtype == want.dtype == np.dtype(ml_dtypes.bfloat16) and got.shape == (56, 56, 6)
    assert len(np.unique(got)) > 100
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))


def test_bfloat16_output_rounds_the_float32_mosaic(rng):
    """With the shipped weights the two packages' f32 mosaics agree within
    rtol 2e-4 and atol 0.5 DN (_assert_close), so their bfloat16 roundings
    may differ by one bfloat16 step (at most 2**-7 of the value) where a
    value straddles a rounding boundary; the port's bfloat16 mosaic is its
    own f32 mosaic rounded to nearest even, bit for bit."""
    ml_dtypes = pytest.importorskip("ml_dtypes")
    d10, d20 = _scene(rng, 56, 2, np.uint16)
    params = weights.load_params_npz(NPZ_2X)
    got, want = _bf16_run(d10, d20, params)
    f32, _ = _bf16_run(d10, d20, params, "float32")
    np.testing.assert_array_equal(got.view(np.uint16),
                                  f32.astype(ml_dtypes.bfloat16).view(np.uint16))
    g, w = got.astype(np.float64), want.astype(np.float64)
    np.testing.assert_allclose(g, w, rtol=2 ** -7 + 2e-4, atol=0.5)
    assert np.mean(g == w) > 0.99


def test_entry_points_need_a_gpu_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d10, d20 = np.zeros((48, 48, 4), np.float32), np.zeros((24, 24, 6), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        dsen2_20(d10, d20, infer_cfg=InferConfig(patch_size=32, border=4))


def test_npz_and_hdf5_load_like_jax():
    for path, cfg in ((NPZ_2X, dsen2_2x()), (NPZ_6X, dsen2_6x())):
        a, b = weights.load_params_npz(path), j_load_npz(path)
        h5 = path.replace(".npz", ".hdf5")
        c, d = weights.load_keras_weights(h5, cfg), j_load_keras(h5, dsen2_tpu.ModelConfig(
            in_channels=cfg.in_channels, num_layers=cfg.num_layers,
            feature_size=cfg.feature_size))
        for top in b:
            for name in b[top]:
                np.testing.assert_array_equal(a[top][name], b[top][name])
                np.testing.assert_array_equal(c[top][name], np.asarray(d[top][name]))


def test_default_params_search_order(tmp_path, monkeypatch):
    cfg = dsen2_2x()
    # models/ beside the package, found from any working directory; .hdf5 first
    monkeypatch.delenv("DSEN2_TPU_WEIGHTS_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    shipped = weights.default_params(cfg, run_60=False, deep=False)
    np.testing.assert_array_equal(
        shipped["tail"]["w"],
        weights.load_keras_weights(NPZ_2X.replace(".npz", ".hdf5"), cfg)["tail"]["w"])
    # the override is exclusive: an .npz there wins, an empty dir gives the init
    own = {k: {n: v + 1 for n, v in sub.items()} for k, sub in shipped.items()}
    j_save_npz(str(tmp_path / "s2_032_lr_1e-04.npz"), own)
    monkeypatch.setenv("DSEN2_TPU_WEIGHTS_DIR", str(tmp_path))
    got = weights.default_params(cfg, run_60=False, deep=False)
    np.testing.assert_array_equal(got["tail"]["w"], own["tail"]["w"])
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("DSEN2_TPU_WEIGHTS_DIR", str(empty))
    with pytest.warns(UserWarning, match="UNTRAINED"):
        fresh = weights.default_params(cfg, run_60=False, deep=False)
    assert fresh["blocks"]["w1"].shape == (6, 3, 3, 128, 128)


def test_npz_serves_where_h5py_is_missing(monkeypatch):
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "h5py" else real(name, *a))
    monkeypatch.delenv("DSEN2_TPU_WEIGHTS_DIR", raising=False)
    assert weights._resolve_weight_file("s2_032_lr_1e-04.hdf5") == NPZ_2X


def test_vdsen2_weights_come_only_from_the_override_dir(tmp_path, monkeypatch):
    """The VDSen2 checkpoints are not in models/: deep=True warns and falls
    back to the fresh init unless DSEN2_TPU_WEIGHTS_DIR holds them."""
    monkeypatch.delenv("DSEN2_TPU_WEIGHTS_DIR", raising=False)
    assert weights._resolve_weight_file(weights.reference_weight_filename(False, True)) is None
    assert weights._resolve_weight_file(weights.reference_weight_filename(True, True)) is None


def test_params_to_torch_keeps_layout():
    p = weights.load_params_npz(NPZ_2X)
    t = weights.params_to_torch(p, "cpu", torch.bfloat16)
    assert t["blocks"]["w1"].dtype == torch.bfloat16
    assert tuple(t["head"]["w"].shape) == p["head"]["w"].shape == (3, 3, 10, 128)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again = weights.params_to_torch(t, "cpu")
    assert again["tail"]["b"].dtype == torch.float32
