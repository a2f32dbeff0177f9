"""The port's meshes and mesh-parallel inference against dsen2_tpu.parallel,
on the CPU: the port on a mesh of repeated CPU devices ([cpu] * 8, or data 4
x model 2), JAX on its 8 virtual CPU devices (tests/conftest.py), at 2
blocks x 16 features and precision "highest". Case for case the cases of
tests/test_parallel.py; port-against-port sharded-vs-single is bit-equal
where JAX's is, and port-against-JAX mosaics agree within the parity of
the existing tests (rtol 2e-4, atol 0.5 DN)."""

import dataclasses
import os
import sys
import threading

import numpy as np
import pytest
import torch

import dsen2_tpu
from dsen2_tpu import parallel as jpar
from dsen2_tpu.core.config import InferConfig as JInferConfig
from dsen2_tpu.core.config import ModelConfig as JModelConfig
from dsen2_tpu.infer import api as japi
from dsen2_tpu.parallel import inference as jinf
from dsen2_tpu_torch import dsen2_20, dsen2_60
from dsen2_tpu_torch.core.config import InferConfig, ModelConfig
from dsen2_tpu_torch.infer import api
from dsen2_tpu_torch.models import s2net
from dsen2_tpu_torch.ops import resblock, resblock_chain
from dsen2_tpu_torch.parallel import batch_sharding, make_mesh, replicated
from dsen2_tpu_torch.parallel import inference as pinf
from dsen2_tpu_torch.weights import load_params_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ_2X = os.path.join(REPO, "models", "s2_032_lr_1e-04.npz")
NPZ_6X = os.path.join(REPO, "models", "s2_030_lr_1e-05.npz")
CPU = torch.device("cpu")
CFG = ModelConfig(in_channels=(4, 6), num_layers=2, feature_size=16)
CFG6 = ModelConfig(in_channels=(4, 6, 2), num_layers=2, feature_size=16)
KW = dict(patch_size=32, border=4, batch_size=4, precision="highest")
KW6 = dict(patch_size=48, border=6, batch_size=4, precision="highest")


def _j(cfg):
    return (JModelConfig if isinstance(cfg, ModelConfig) else JInferConfig)(
        **dataclasses.asdict(cfg))


def _jicfg(icfg):
    kw = dataclasses.asdict(icfg)
    kw["use_pallas"] = kw.pop("use_kernels")
    return JInferConfig(**kw)


def _mesh(n=8, **kw):
    return make_mesh([CPU] * n, **kw)


def _params(seed, cfg=CFG):
    return s2net.init_params(torch.Generator().manual_seed(seed), cfg)


def _scene(rng, h, w, c=(4, 6), scale=5000, dtype=np.float32, factors=(1, 2, 6)):
    return [(rng.random((h // f, w // f, ci)) * scale).astype(dtype)
            for ci, f in zip(c, factors)]


def _assert_parity(got, want):
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=0.5)


class TestMesh:
    def test_make_mesh_shapes(self):
        for kw in (dict(), dict(data=4, model=2), dict(data=2, model=1)):
            m, jm = _mesh(**kw), jpar.make_mesh(**kw)
            assert m.shape == dict(jm.shape) and m.axis_names == jm.axis_names
            assert m.devices.shape == jm.devices.shape
            assert all(d == CPU for d in m.devices.flat)
        assert _mesh(data=2).devices.size == 2
        assert _mesh(data=4, model=2).data_devices == [CPU] * 4

    def test_too_many_devices_raises(self):
        with pytest.raises(ValueError) as mine:
            _mesh(data=16, model=1)
        with pytest.raises(ValueError) as theirs:
            jpar.make_mesh(data=16, model=1)
        assert str(mine.value) == str(theirs.value)

    def test_batch_sharding_spec(self):
        for ndim, axis in ((4, 0), (4, 2), (1, 0)):
            s = batch_sharding(_mesh(), ndim, axis)
            assert s.spec == tuple(jpar.batch_sharding(jpar.make_mesh(), ndim, axis).spec)
        assert replicated(_mesh()).spec == tuple(jpar.replicated(jpar.make_mesh()).spec)

    def test_placements_place_per_data_shard(self):
        a = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
        parts = batch_sharding(_mesh(data=4, model=2), 2).place(a)
        assert [p.tolist() for p in parts] == [a[2 * i : 2 * i + 2].tolist() for i in range(4)]
        t = torch.from_numpy(a)
        assert all(p is t for p in replicated(_mesh(4)).place(t))
        with pytest.raises(ValueError, match="divide"):
            batch_sharding(_mesh(3), 2).place(a)

    def test_default_mesh_needs_a_gpu_or_devices(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="devices="):
            make_mesh()

    def test_make_mesh_default_indexes_every_gpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        m = make_mesh()
        assert m.shape == {"data": 2, "model": 1}
        assert list(m.devices.flat) == [torch.device("cuda", 0), torch.device("cuda", 1)]


class TestMultiTileInference:
    def test_sharded_tiles_match_single(self, rng):
        params = _params(0)
        icfg = InferConfig(**KW)
        n = 8
        d10s = (rng.random((n, 48, 48, 4)) * 5000).astype(np.float32)
        d20s = (rng.random((n, 24, 24, 6)) * 5000).astype(np.float32)
        got = pinf.sr_tiles_sharded(params, [d10s, d20s], 2, CFG, icfg, _mesh())
        assert got.shape == (n, 48, 48, 6) and got.dtype == np.float32
        for i in range(0, n, 3):
            want = api._run([d10s[i], d20s[i]], 2, CFG, params, icfg, device="cpu")
            np.testing.assert_array_equal(got[i], want)
        jgot = jinf.sr_tiles_sharded(params, [d10s, d20s], 2, _j(CFG), _jicfg(icfg),
                                     jpar.make_mesh(data=8))
        _assert_parity(got, jgot)

    def test_sharded_tiles_uint16_inputs_bit_identical(self, rng):
        params = _params(0)
        icfg = InferConfig(**KW)
        n = 8
        d10s = (rng.random((n, 48, 48, 4)) * 12000).astype(np.uint16)
        d20s = (rng.random((n, 24, 24, 6)) * 12000).astype(np.uint16)
        got = pinf.sr_tiles_sharded(params, [d10s, d20s], 2, CFG, icfg, _mesh())
        want = pinf.sr_tiles_sharded(
            params, [d10s.astype(np.float32), d20s.astype(np.float32)], 2, CFG, icfg, _mesh())
        np.testing.assert_array_equal(got, want)

    def test_indivisible_batch_raises(self):
        cfg = ModelConfig(in_channels=(4, 6), num_layers=1, feature_size=8)
        d10s = np.zeros((6, 48, 48, 4), np.float32)
        d20s = np.zeros((6, 24, 24, 6), np.float32)
        with pytest.raises(ValueError, match="divide"):
            pinf.sr_tiles_sharded(_params(0, cfg), [d10s, d20s], 2, cfg,
                                  InferConfig(patch_size=32, border=4, batch_size=4), _mesh())

    @pytest.mark.parametrize("run_60", [False, True])
    def test_entry_point_tiles_match_jax_at_full_width(self, rng, run_60):
        """dsen2_20_tiles / dsen2_60_tiles with the shipped DSen2 weights, 4
        tiles over 4 shards."""
        n, h = 4, 48
        rasters = [np.stack(r) for r in zip(*(_scene(rng, h, h, (4, 6, 2), 9000)
                                               for _ in range(n)))]
        if run_60:
            kw = dict(patch_size=48, border=6, batch_size=3, precision="highest")
            args, params = rasters, load_params_npz(NPZ_6X)
            got = pinf.dsen2_60_tiles(*args, _mesh(4), params=params,
                                      infer_cfg=InferConfig(**kw))
            want = jinf.dsen2_60_tiles(*args, jpar.make_mesh(data=4), params=params,
                                       infer_cfg=JInferConfig(**kw))
        else:
            kw = dict(patch_size=32, border=4, batch_size=3, precision="highest")
            args, params = rasters[:2], load_params_npz(NPZ_2X)
            got = pinf.dsen2_20_tiles(*args, _mesh(4), params=params,
                                      infer_cfg=InferConfig(**kw))
            want = jinf.dsen2_20_tiles(*args, jpar.make_mesh(data=4), params=params,
                                       infer_cfg=JInferConfig(**kw))
        assert got.shape == want.shape == (n, h, h, 2 if run_60 else 6)
        _assert_parity(got, want)


PLAN_GRID = [(ny, interior, out_h, ndev)
             for ny, interior in ((1, 8), (2, 8), (2, 24), (5, 8), (9, 8), (12, 24), (99, 112))
             for out_h in (ny * interior, ny * interior - 2, (ny - 1) * interior + 1)
             for ndev in (1, 2, 3, 4, 8) if out_h >= interior]


@pytest.mark.parametrize("ny,interior,out_h,ndev", PLAN_GRID)
def test_plan_shard_bands_copy_equal(ny, interior, out_h, ndev):
    """The copy against the original over a grid with and without a flush
    row, empty leading bands (ny 2, flush) and fewer rows than shards."""
    got = pinf.plan_shard_bands(ny, interior, out_h, ndev)
    assert got == jinf.plan_shard_bands(ny, interior, out_h, ndev)
    assert got[0][0] == 0 and max(r1 for _, r1 in got) == ny


class TestSingleTileSharded:
    def _setup(self, seed=3):
        return _params(seed), InferConfig(**KW)

    def test_plan_shard_bands(self):
        assert pinf.plan_shard_bands(9, 8, 72, 8) == [
            (0, 2), (2, 3), (3, 4), (4, 5), (5, 6), (6, 7), (7, 8), (8, 9)]
        bands = pinf.plan_shard_bands(9, 8, 70, 8)
        assert bands[-1] == (7, 9) and bands[-2] == (7, 7) and bands[0] == (0, 2)
        assert pinf.plan_shard_bands(2, 8, 16, 8)[:2] == [(0, 1), (1, 2)]
        assert all(r0 == r1 for r0, r1 in pinf.plan_shard_bands(2, 8, 16, 8)[2:])
        assert pinf.plan_shard_bands(5, 8, 40, 1) == [(0, 5)]

    def test_sharded_tile_matches_single_2x(self, rng):
        params, icfg = self._setup()
        # 70x66 on the 10m grid: flush row AND flush column both exercised
        d10, d20 = _scene(rng, 70, 66)
        want = api._run([d10, d20], 2, CFG, params, icfg, device="cpu")
        got = pinf.sr_tile_sharded(params, [d10, d20], 2, CFG, icfg, _mesh())
        np.testing.assert_array_equal(got, want)
        jgot = jinf.sr_tile_sharded(params, [d10, d20], 2, _j(CFG), _jicfg(icfg),
                                    jpar.make_mesh(data=8))
        _assert_parity(got, jgot)

    def test_sharded_tile_matches_single_6x(self, rng):
        params = _params(5, CFG6)
        icfg = InferConfig(**KW6)
        d10, d20, d60 = _scene(rng, 144, 108, (4, 6, 2))
        got = pinf.sr_tile_sharded(params, [d10, d20, d60], 6, CFG6, icfg, _mesh())
        # per-shard rows force chunk batch 3, as in the JAX package
        icfg3 = dataclasses.replace(icfg, batch_size=3)
        np.testing.assert_array_equal(
            got, api._run([d10, d20, d60], 6, CFG6, params, icfg3, device="cpu"))
        want = api._run([d10, d20, d60], 6, CFG6, params, icfg, device="cpu")
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=0.5)
        jgot = jinf.sr_tile_sharded(params, [d10, d20, d60], 6, _j(CFG6), _jicfg(icfg),
                                    jpar.make_mesh(data=8))
        _assert_parity(got, jgot)

    def test_sharded_tile_uint16_inputs_bit_identical(self, rng):
        params, icfg = self._setup()
        d10, d20 = _scene(rng, 70, 66, scale=12000, dtype=np.uint16)
        got = pinf.sr_tile_sharded(params, [d10, d20], 2, CFG, icfg, _mesh())
        want = pinf.sr_tile_sharded(
            params, [d10.astype(np.float32), d20.astype(np.float32)], 2, CFG, icfg, _mesh())
        np.testing.assert_array_equal(got, want)

    def test_fewer_rows_than_devices(self, rng):
        params, icfg = self._setup()
        d10, d20 = _scene(rng, 32, 96)  # 1-2 grid rows
        want = api._run([d10, d20], 2, CFG, params, icfg, device="cpu")
        got = pinf.sr_tile_sharded(params, [d10, d20], 2, CFG, icfg, _mesh())
        np.testing.assert_array_equal(got, want)

    def test_empty_leading_band(self, rng):
        """ny == 2 with a flush row empties band 0; empty shards compute
        nothing and every band lands where it belongs."""
        params, icfg = self._setup()
        bands = pinf.plan_shard_bands(2, 24, 40, 8)
        assert bands[0] == (0, 0) and bands[1] == (0, 2)
        d10, d20 = _scene(rng, 40, 96)
        want = api._run([d10, d20], 2, CFG, params, icfg, device="cpu")
        got = pinf.sr_tile_sharded(params, [d10, d20], 2, CFG, icfg, _mesh())
        np.testing.assert_array_equal(got, want)
        dev_bands, meta = pinf.sr_tile_sharded(params, [d10, d20], 2, CFG, icfg, _mesh(),
                                               device_result=True)
        assert [b is None for b in dev_bands] == [h == 0 for _, h in meta]
        assert sum(h for _, h in meta) == 40

    def test_api_mesh_kwarg(self, rng):
        params, icfg = self._setup()
        d10, d20 = _scene(rng, 64, 64)
        want = api._run([d10, d20], 2, CFG, params, icfg, device="cpu")
        got = api._run([d10, d20], 2, CFG, params, icfg, mesh=_mesh())
        np.testing.assert_array_equal(got, want)
        jgot = japi._run([d10, d20], 2, _j(CFG), params, _jicfg(icfg),
                         mesh=jpar.make_mesh(data=8))
        _assert_parity(got, jgot)

    def test_mesh_ensemble_device_resident_matches_single(self):
        """Square and non-square (odd rotations transpose the band
        decomposition) scenes: the mesh ensemble against the single-device
        one and against JAX's mesh ensemble."""
        rng = np.random.default_rng(834)
        params, icfg = self._setup()
        for h, w in ((64, 64), (40, 96)):
            d10, d20 = _scene(rng, h, w)
            want = api._run_ensembled([d10, d20], 2, CFG, params, icfg, device="cpu")
            got = api._run_ensembled([d10, d20], 2, CFG, params, icfg, mesh=_mesh())
            assert got.dtype == want.dtype
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0.05)
            jgot = japi._run_ensembled([d10, d20], 2, _j(CFG), params, _jicfg(icfg),
                                       mesh=jpar.make_mesh(data=8))
            _assert_parity(got, jgot)

    def test_mesh_ensemble_single_readback(self, monkeypatch):
        """Exactly 8 sharded calls, each with device_result=True."""
        rng = np.random.default_rng(835)
        params, icfg = self._setup()
        calls = []
        orig = pinf.sr_tile_sharded

        def spy(*a, **kw):
            calls.append(kw.get("device_result", False))
            return orig(*a, **kw)

        monkeypatch.setattr(pinf, "sr_tile_sharded", spy)
        d10, d20 = _scene(rng, 64, 64)
        api._run_ensembled([d10, d20], 2, CFG, params, icfg, mesh=_mesh())
        assert calls == [True] * 8

    def test_mesh_with_device_output_raises(self, rng):
        params, icfg = self._setup()
        d10, d20 = _scene(rng, 64, 64)
        with pytest.raises(ValueError, match="device_output"):
            api._run([d10, d20], 2, CFG, params, icfg, mesh=_mesh(), device_output=True)

    @pytest.mark.parametrize("ensemble", [False, True])
    def test_one_device_mesh_runs_the_single_device_path(self, rng, ensemble, monkeypatch):
        """A one-device mesh gives the single-device mosaic in both
        packages, through the entry points, and never reaches the sharded
        path."""
        monkeypatch.setattr(pinf, "sr_tile_sharded", None)
        d10, d20 = _scene(rng, 48, 48)
        params = load_params_npz(NPZ_2X)
        kw = dict(patch_size=32, border=4, batch_size=3, precision="highest")
        got = dsen2_20(d10, d20, params=params, infer_cfg=InferConfig(**kw),
                       mesh=_mesh(1), ensemble=ensemble)
        want = dsen2_20(d10, d20, params=params, infer_cfg=InferConfig(**kw), device="cpu",
                        ensemble=ensemble)
        np.testing.assert_array_equal(got, want)
        jgot = dsen2_tpu.dsen2_20(d10, d20, params=params, infer_cfg=JInferConfig(**kw),
                                  mesh=jpar.make_mesh(data=1), ensemble=ensemble)
        _assert_parity(got, jgot)

    def test_dsen2_60_mesh_matches_jax(self, rng):
        """dsen2_60 passes the mesh through: 3 shards, uneven bands and a
        flush row."""
        d10, d20, d60 = _scene(rng, 84, 60, (4, 6, 2), 9000)
        params = load_params_npz(NPZ_6X)
        kw = dict(patch_size=48, border=6, batch_size=3, precision="highest")
        got = dsen2_60(d10, d20, d60, params=params, infer_cfg=InferConfig(**kw),
                       mesh=_mesh(3))
        want = dsen2_60(d10, d20, d60, params=params, infer_cfg=InferConfig(**kw),
                        device="cpu")
        np.testing.assert_array_equal(got, want)
        jgot = dsen2_tpu.dsen2_60(d10, d20, d60, params=params, infer_cfg=JInferConfig(**kw),
                                  mesh=jpar.make_mesh(data=3))
        _assert_parity(got, jgot)

    def test_device_other_than_the_mesh_raises(self, rng):
        d10, d20 = _scene(rng, 48, 48)
        for mesh in (_mesh(1), _mesh(2)):
            with pytest.raises(ValueError, match="mesh's first device"):
                dsen2_20(d10, d20, params=_params(0), mesh=mesh, device="meta",
                         infer_cfg=InferConfig(**KW))


def test_launch_counts_survive_concurrent_shards():
    """Shard workers launch the kernels from several host threads at once;
    the launch counters, and the registry's b1.blocks and b2.blocks, must
    not lose an increment."""
    from dsen2_tpu_torch.utils.profiling import counters

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    before = (resblock_chain.fused_resblock_chain.launches, resblock.fused_resblock.launches)
    counted = counters()
    try:
        def work():
            for _ in range(2000):
                resblock_chain.count_launches(resblock_chain.fused_resblock_chain, 2)
                resblock_chain.count_launches(resblock.fused_resblock, 1)

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
    assert resblock_chain.fused_resblock_chain.launches - before[0] == 16 * 2000 * 2
    assert resblock.fused_resblock.launches - before[1] == 16 * 2000
    after = counters()
    assert after["b1.blocks"] - counted.get("b1.blocks", 0) == 16 * 2000 * 2
    assert after["b2.blocks"] - counted.get("b2.blocks", 0) == 16 * 2000


def test_tf32_scopes_hold_across_threads():
    """The TF32 flags are process-wide; shard workers open their scopes from
    several threads at once. Inside a scope the flags must stay as it set
    them whatever other threads' scopes do."""
    from dsen2_tpu_torch.core import device

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    bad = []

    def work(scope, want):
        for _ in range(300):
            with scope():
                for _ in range(5):
                    flags = (torch.backends.cudnn.allow_tf32,
                             torch.backends.cuda.matmul.allow_tf32)
                    if flags != (want, want):
                        bad.append(flags)

    try:
        threads = [threading.Thread(target=work, args=a)
                   for a in [(device.tf32_disabled, False), (device.tf32_for_bf16_operands, True)]
                   * 4]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
    assert bad == []
