"""The port's data-parallel training against dsen2_tpu.parallel, on the CPU:
the port on a mesh of repeated CPU devices, JAX on its 8 virtual CPU
devices (tests/conftest.py), at 2 blocks x 16 features. The DP step equals
the unsharded step (loss rtol 1e-6, params rtol 1e-5 / atol 1e-7, as
tests/test_parallel.py holds JAX's); model-sharded params keep the eval
loss; fit(mesh=) host-fed and staged follows JAX's fit(mesh=) (history and
params rtol 1e-4, as tests/test_torch_train.py holds fit)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dsen2_tpu import parallel as jpar
from dsen2_tpu.core import config as jconfig
from dsen2_tpu.train import loop as jloop
from dsen2_tpu.train.nadam import nadam_keras
from dsen2_tpu_torch.core.config import ModelConfig, TrainConfig
from dsen2_tpu_torch.models import s2net
from dsen2_tpu_torch.parallel import (
    MODEL_AXIS, make_eval_step, make_mesh, make_train_step, shard_params,
)
from dsen2_tpu_torch.train.loop import fit
from dsen2_tpu_torch.train.nadam import make_optimizer
from dsen2_tpu_torch.weights import params_to_numpy, params_to_torch

CPU = torch.device("cpu")
CFG = ModelConfig(in_channels=(4, 6), num_layers=2, feature_size=16)
JCFG = jconfig.ModelConfig(**dataclasses.asdict(CFG))


def _mesh(n=8, **kw):
    return make_mesh([CPU] * n, **kw)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x10 = rng.random((16, 16, 16, 4), np.float32)
    x20 = rng.random((16, 16, 16, 6), np.float32)
    tgt = rng.random((16, 16, 16, 6), np.float32)
    return x10, x20, tgt


@pytest.fixture(scope="module")
def p0():
    return s2net.init_params(torch.Generator().manual_seed(0), CFG)


def _leaves(p0):
    """Leaf tensors of copies of p0 (the optimizer updates them in place)."""
    return {top: {k: v.clone().requires_grad_(True) for k, v in sub.items()}
            for top, sub in params_to_torch(p0, CPU).items()}


def _port_step(p0, data, mesh):
    x10, x20, tgt = data
    params = _leaves(p0)
    opt = make_optimizer(params, TrainConfig(lr=1e-3))
    step = make_train_step(CFG, opt, mesh=mesh)
    inputs = (torch.from_numpy(x10), torch.from_numpy(x20))
    m = step(params, inputs, torch.from_numpy(tgt))
    return params_to_numpy(params), float(m["loss"]), float(m["mse"])


class TestShardedTraining:
    @pytest.mark.parametrize("mesh_kw", [dict(), dict(data=4, model=2)])
    def test_dp_step_matches_unsharded(self, p0, data, mesh_kw):
        p1, loss1, mse1 = _port_step(p0, data, None)
        p8, loss8, mse8 = _port_step(p0, data, _mesh(**mesh_kw))
        np.testing.assert_allclose(loss1, loss8, rtol=1e-6)
        np.testing.assert_allclose(mse1, mse8, rtol=1e-6)
        for top, name in s2net.PARAM_NAMES:
            np.testing.assert_allclose(p1[top][name], p8[top][name], rtol=1e-5, atol=1e-7,
                                       err_msg=f"{top}.{name}")

        # against JAX's step on its mesh
        x10, x20, tgt = data
        opt = nadam_keras(1e-3)
        jmesh = jpar.make_mesh(**mesh_kw)
        params_r = jax.device_put(p0, jpar.replicated(jmesh))
        st = jax.device_put(opt.init(p0), jpar.replicated(jmesh))
        jstep = jpar.make_train_step(JCFG, opt, mesh=jmesh)
        shard = jpar.batch_sharding(jmesh, 4)
        jp, _, jm = jstep(params_r, st, tuple(jax.device_put(x, shard) for x in (x10, x20)),
                          jax.device_put(tgt, shard))
        np.testing.assert_allclose(loss8, float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(mse8, float(jm["mse"]), rtol=1e-5)
        for top, name in s2net.PARAM_NAMES:
            np.testing.assert_allclose(p8[top][name], np.asarray(jp[top][name]), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{top}.{name}")

    def test_short_batch_runs_unsharded(self, p0, data):
        """A batch that does not divide by the data axis runs on the first
        device: the same step as without a mesh."""
        cut = tuple(a[:10] for a in data)
        p1, loss1, _ = _port_step(p0, cut, None)
        p8, loss8, _ = _port_step(p0, cut, _mesh())
        assert loss1 == loss8
        for top, name in s2net.PARAM_NAMES:
            np.testing.assert_array_equal(p1[top][name], p8[top][name])

    def test_tp_sharded_params_same_loss(self, p0, data):
        """Feature-dim (model-parallel) sharding must not change the math."""
        x10, x20, tgt = data
        mesh = _mesh(data=4, model=2)
        got = make_eval_step(CFG, mesh=mesh)(shard_params(p0, mesh, model_parallel=True),
                                             (x10, x20), tgt)
        want = make_eval_step(CFG, mesh=None)(p0, (x10, x20), tgt)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-6)
        np.testing.assert_allclose(float(got["mse"]), float(want["mse"]), rtol=1e-6)
        jmesh = jpar.make_mesh(data=4, model=2)
        jgot = jpar.make_eval_step(JCFG, mesh=jmesh)(
            jpar.shard_params(p0, jmesh, model_parallel=True), (x10, x20), tgt)
        np.testing.assert_allclose(float(got["loss"]), float(jgot["loss"]), rtol=1e-5)

    def test_shard_params_places_on_model_axis(self, p0):
        mesh = _mesh(data=4, model=2)
        tp = shard_params(p0, mesh, model_parallel=True)
        jtp = jpar.shard_params(p0, jpar.make_mesh(data=4, model=2), model_parallel=True)
        for top, name in s2net.PARAM_NAMES:
            sp = tp[top][name]
            assert sp.sharding.spec == tuple(jtp[top][name].sharding.spec)
            assert sp.sharding.spec[-1] == MODEL_AXIS
            full = p0[top][name]
            for r in range(4):
                for m in range(2):
                    half = full.shape[-1] // 2
                    np.testing.assert_array_equal(sp.shards[r][m].numpy(),
                                                  full[..., m * half : (m + 1) * half])
                    assert sp.shards[r][m].device == mesh.devices[r, m]
                np.testing.assert_array_equal(sp.gather(r).numpy(), full)
        rep = shard_params(p0, mesh)
        assert rep["head"]["w"].sharding.spec == ()
        np.testing.assert_array_equal(rep["head"]["w"].gather(3).numpy(), p0["head"]["w"])


def _fit_data(n_train=42, n_val=16, seed=0):
    """42 = 2 x 16 + 10 crops: the last batch of 10 does not divide the
    4-shard data axis, so it runs unsharded (JAX replicates it)."""
    rng = np.random.default_rng(seed)
    n = n_train + n_val
    x10 = rng.random((n, 32, 32, 4), dtype=np.float32)
    x20 = rng.random((n, 32, 32, 6), dtype=np.float32)
    lb = (x20 * 1.5 + 0.1 * x10[..., :1]).astype(np.float32)
    k = n_train
    return (x10[:k], x20[:k]), lb[:k], (x10[k:], x20[k:]), lb[k:]


@pytest.mark.parametrize("stage_data", [False, True])
def test_fit_mesh_matches_jax(stage_data, p0):
    """fit(mesh=) over 4 shards, host-fed and staged, augmented, three
    epochs: against JAX's fit(mesh=) on 4 devices and the port's unsharded
    fit."""
    data = _fit_data()
    tcfg = TrainConfig(batch_size=16, augment=True)
    kw = dict(params=p0, epochs=3, precision="highest", verbose=False, stage_data=stage_data)
    state, hist = fit(CFG, tcfg, *data, mesh=_mesh(4), **kw)
    jstate, jhist = jloop.fit(JCFG, jconfig.TrainConfig(batch_size=16, augment=True), *data,
                              mesh=jpar.make_mesh(data=4), **kw)
    ustate, uhist = fit(CFG, tcfg, *data, device="cpu", **kw)
    for key in ("loss", "val_loss", "mse", "lr"):
        np.testing.assert_allclose(hist[key], jhist[key], rtol=1e-4, err_msg=key)
        np.testing.assert_allclose(hist[key], uhist[key], rtol=1e-5, err_msg=key)
    for top, name in s2net.PARAM_NAMES:
        got = state.params[top][name].numpy()
        np.testing.assert_allclose(got, np.asarray(jstate.params[top][name]), rtol=1e-4,
                                   atol=1e-5, err_msg=f"{top}.{name}")
        np.testing.assert_allclose(got, ustate.params[top][name].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=f"{top}.{name}")
    assert hist["loss"][-1] < hist["loss"][0]


def test_fit_builds_a_mesh_on_several_gpus(monkeypatch):
    """No mesh and no device on a machine with several GPUs: fit trains over
    make_mesh(), as JAX's fit does when jax.device_count() > 1."""
    from dsen2_tpu_torch import parallel

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(parallel, "make_mesh", lambda: _mesh(4))
    seen = []
    orig = parallel.make_train_step

    def spy(cfg, opt, mesh, *a):
        seen.append(mesh.shape)
        return orig(cfg, opt, mesh, *a)

    monkeypatch.setattr(parallel, "make_train_step", spy)
    data = _fit_data(n_train=16, n_val=8)
    _, hist = fit(CFG, TrainConfig(batch_size=8), *data, epochs=1, verbose=False,
                  precision="highest")
    assert seen == [{"data": 4, "model": 1}] and np.isfinite(hist["loss"]).all()
