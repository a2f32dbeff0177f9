"""The port's dihedral ops and self-ensemble against dsen2_tpu's, on the CPU,
at a tiny width (2 blocks x 16 features) and precision "highest"."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsen2_tpu.core.config import InferConfig as JInferConfig
from dsen2_tpu.core.config import ModelConfig as JModelConfig
from dsen2_tpu.infer import api as japi
from dsen2_tpu.ops import dihedral as jdihedral
from dsen2_tpu_torch import dsen2_20
from dsen2_tpu_torch.core.config import InferConfig, ModelConfig
from dsen2_tpu_torch.infer import api
from dsen2_tpu_torch.models import s2net
from dsen2_tpu_torch.ops import dihedral
from dsen2_tpu_torch.parallel import make_mesh

CFG = ModelConfig(in_channels=(4, 6), num_layers=2, feature_size=16)
JCFG = JModelConfig(**dataclasses.asdict(CFG))
KW = dict(patch_size=32, border=4, batch_size=4, precision="highest")


def _scene(seed, h, w):
    rng = np.random.default_rng(seed)
    return [(rng.random((h, w, 4)) * 8000).astype(np.uint16),
            (rng.random((h // 2, w // 2, 6)) * 8000).astype(np.uint16)]


def _params(seed):
    return s2net.init_params(torch.Generator().manual_seed(seed), CFG)


@pytest.mark.parametrize("code", range(8))
def test_dihedral_matches_jax(code):
    x = np.random.default_rng(code).standard_normal((5, 7, 3)).astype(np.float32)
    want = jdihedral.dihedral_np(x, code)
    np.testing.assert_array_equal(dihedral.dihedral_np(x, code), want)
    np.testing.assert_array_equal(dihedral.dihedral_static(torch.from_numpy(x), code).numpy(),
                                  want)
    np.testing.assert_array_equal(
        np.asarray(jdihedral.dihedral_static(jnp.asarray(x), code)), want)
    back = dihedral.dihedral_np(want, dihedral.inverse_code[code])
    np.testing.assert_array_equal(back, x)
    assert dihedral.inverse_code == jdihedral.inverse_code


@pytest.mark.parametrize("hw", [(12, 12), (12, 17)])
@pytest.mark.parametrize("code", range(8))
def test_accumulate_bands_matches_jax(code, hw):
    """Bands of the transformed mosaic, of unequal heights, the last one a
    row taller (a merged flush row), fold into the output-space sum as the
    inverse transform of the whole transformed mosaic, and as JAX's fold."""
    h, w = hw
    rng = np.random.default_rng(100 + code)
    rows_tr, cols_tr = (h, w) if code % 2 == 0 else (w, h)
    mosaic_tr = rng.standard_normal((rows_tr, cols_tr, 3)).astype(np.float32)
    cuts = [0, 3, 7, rows_tr]
    bands = [(mosaic_tr[a:b], a, b - a) for a, b in zip(cuts, cuts[1:])]
    base = rng.standard_normal((h, w, 3)).astype(np.float32)

    got = api._ens_accumulate_bands(torch.from_numpy(base.copy()),
                                    [(torch.from_numpy(b), y0, bh) for b, y0, bh in bands], code)
    want = japi._ens_accumulate_bands(jnp.asarray(base),
                                      [(jnp.asarray(b), y0, bh) for b, y0, bh in bands], code)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    direct = base + dihedral.dihedral_np(mosaic_tr, dihedral.inverse_code[code])
    np.testing.assert_array_equal(got.numpy(), direct)


@pytest.mark.parametrize("route", ["whole-tile", "banded"])
@pytest.mark.parametrize("hw", [(96, 96), (96, 72)])
def test_run_ensembled_matches_jax(monkeypatch, route, hw):
    if route == "banded":
        monkeypatch.setattr(api, "_BANDED_THRESHOLD_PX", 1)
        monkeypatch.setattr(japi, "_BANDED_THRESHOLD_PX", 1)
    d10, d20 = _scene(7, *hw)
    params = _params(1)
    want = japi._run_ensembled([d10, d20], 2, JCFG, params, JInferConfig(**KW))
    got = api._run_ensembled([d10, d20], 2, CFG, params, InferConfig(**KW), device="cpu")
    assert got.shape == want.shape == (*hw, 6) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=0.5)


@pytest.mark.parametrize("route", ["whole-tile", "banded"])
def test_uint16_ensemble_quantised_once(monkeypatch, route):
    """uint16 is the rounded, clipped mean of the float32 sum: one rounding,
    not eight."""
    if route == "banded":
        monkeypatch.setattr(api, "_BANDED_THRESHOLD_PX", 1)
        monkeypatch.setattr(japi, "_BANDED_THRESHOLD_PX", 1)
    d10, d20 = _scene(8, 72, 72)
    params = _params(2)
    f32 = api._run_ensembled([d10, d20], 2, CFG, params, InferConfig(**KW), device="cpu")
    u16_cfg = dict(KW, output_dtype="uint16")
    got = api._run_ensembled([d10, d20], 2, CFG, params, InferConfig(**u16_cfg), device="cpu")
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, np.clip(np.round(f32), 0, 65535).astype(np.uint16))
    want = japi._run_ensembled([d10, d20], 2, JCFG, params, JInferConfig(**u16_cfg))
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1 and np.mean(diff == 0) > 0.99


def test_entry_points_take_ensemble(monkeypatch):
    d10, d20 = _scene(9, 64, 64)
    params = _params(3)
    calls = []
    orig = api._run_ensembled
    monkeypatch.setattr(api, "_run_ensembled",
                        lambda *a, **kw: calls.append(kw.get("mesh")) or orig(*a, **kw))
    monkeypatch.setattr(api, "dsen2_2x", lambda deep=False: CFG)
    got = dsen2_20(d10, d20, params=params, infer_cfg=InferConfig(**KW), ensemble=True,
                   device="cpu")
    assert calls == [None] and got.shape == (64, 64, 6)
    mesh = make_mesh([torch.device("cpu")] * 2)
    on_mesh = dsen2_20(d10, d20, params=params, infer_cfg=InferConfig(**KW), ensemble=True,
                       mesh=mesh)
    assert calls == [None, mesh]
    np.testing.assert_allclose(on_mesh, got, rtol=1e-5, atol=0.05)


def test_ensemble_needs_a_gpu_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d10, d20 = _scene(10, 64, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        api._run_ensembled([d10, d20], 2, CFG, _params(4), InferConfig(**KW))
