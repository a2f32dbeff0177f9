"""The port's accuracy harness (resizers, metrics, .mat reader, demo) against
dsen2_tpu's, on the CPU."""

import dataclasses

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

import dsen2_tpu.weights as jweights
from dsen2_tpu.cli import demo as jdemo
from dsen2_tpu.data import mat as jmat
from dsen2_tpu.infer import api as japi
from dsen2_tpu.infer import metrics as jmetrics
from dsen2_tpu.ops import resize as jresize
from dsen2_tpu_torch.cli import demo
from dsen2_tpu_torch.core import config
from dsen2_tpu_torch.data import mat
from dsen2_tpu_torch.infer import api, metrics
from dsen2_tpu_torch.models import s2net
from dsen2_tpu_torch.ops import resize


@pytest.mark.parametrize("hw,out_hw", [((12, 18), (24, 36)), ((8, 8), (48, 48)),
                                       ((36, 24), (12, 8))])
def test_matlab_imresize_matches_jax(hw, out_hw):
    x = (np.random.default_rng(1).random((*hw, 3)) * 9000).astype(np.float32)
    want = np.asarray(jresize.matlab_imresize(jnp.asarray(x), out_hw))
    got = resize.matlab_imresize(torch.from_numpy(x), out_hw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("factor", [2, 6])
def test_wald_downsample_matches_jax(factor):
    x = (np.random.default_rng(factor).random((2, 36, 24, 4)) * 9000).astype(np.float32)
    want = np.asarray(jresize.wald_downsample(jnp.asarray(x), factor))
    got = resize.wald_downsample(torch.from_numpy(x), factor).numpy()
    assert got.shape == (2, 36 // factor, 24 // factor, 4)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3)


def test_convert_double_to_byte_equal():
    x = np.random.default_rng(2).uniform(-0.2, 1.2, (9, 7, 3))
    np.testing.assert_array_equal(resize.convert_double_to_byte(x),
                                  jresize.convert_double_to_byte(x))


def test_metrics_is_a_verbatim_copy():
    with open(jmetrics.__file__, "rb") as a, open(metrics.__file__, "rb") as b:
        assert a.read() == b.read()


def _scene(seed, h10):
    rng = np.random.default_rng(seed)
    base = rng.uniform(500, 5000, (h10 // 6, h10 // 6, 1))

    def raster(h, c):
        f = np.repeat(np.repeat(base, h // base.shape[0], 0), h // base.shape[1], 1)
        return (f + rng.normal(0, 100, (h, h, c))).astype(np.float32)

    return {"im10": raster(h10, 4), "im20": raster(h10 // 2, 6), "im60": raster(h10 // 6, 2)}


def _write_v73(path, scene):
    """MATLAB v7.3 stores arrays column-major: HDF5 sees them transposed."""
    with h5py.File(path, "w") as f:
        for k, v in scene.items():
            f.create_dataset(k, data=v.transpose())


def test_read_scene_equals_jax_and_reads_v5(tmp_path):
    scene = _scene(3, 36)
    _write_v73(tmp_path / "a.mat", scene)
    scipy.io.savemat(tmp_path / "b.mat", {**scene, "note": np.zeros((2, 2))})
    want = jmat.read_scene(str(tmp_path / "a.mat"))
    for name in ("a.mat", "b.mat"):
        got = mat.read_scene(str(tmp_path / name))
        assert sorted(got) == sorted(want) == ["im10", "im20", "im60"]
        for k in want:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k])


def test_run_scene_matches_jax(tmp_path, monkeypatch):
    """Both demos on a 288^2 Wald-simulated scene with the same tiny nets
    (2 blocks x 16 features) report the same RMSE and SRE."""
    tiny = {}
    for run_60, make in ((False, config.dsen2_2x), (True, config.dsen2_6x)):
        cfg = dataclasses.replace(make(False), num_layers=2, feature_size=16)
        tiny[run_60] = (cfg, s2net.init_params(torch.Generator().manual_seed(int(run_60)), cfg))
    for mod in (api, japi):
        monkeypatch.setattr(mod, "dsen2_2x", lambda deep=False: tiny[False][0])
        monkeypatch.setattr(mod, "dsen2_6x", lambda deep=False: tiny[True][0])
    monkeypatch.setattr(api, "default_params", lambda cfg, run_60, deep: tiny[run_60][1])
    monkeypatch.setattr(jweights, "default_params", lambda cfg, run_60, deep: tiny[run_60][1])

    path = tmp_path / "synthetic.mat"
    _write_v73(path, _scene(4, 288))
    want = jdemo.run_scene(str(path), deep=False, plots=False, out_dir=str(tmp_path))
    got = demo.run_scene(str(path), deep=False, plots=False, out_dir=str(tmp_path), device="cpu")
    assert sorted(got) == sorted(want)
    assert {"rmse_dsen2_20", "rmse_bicubic_20", "sre_dsen2_20", "rmse_dsen2_60",
            "rmse_bicubic_60"} <= set(got)
    for k in want:
        if k == "scene":
            assert got[k] == want[k]
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4, err_msg=k)


def test_demo_main_reports_missing_scenes(tmp_path, capsys):
    assert demo.main(["--data-dir", str(tmp_path), "--no-plots"]) == 1
    assert "no .mat scenes" in capsys.readouterr().err
