"""The port's training slice against dsen2_tpu's, on the CPU, at 2 blocks x
16 features on 32 x 32 crops: fit's history and parameters, the staged
epochs, resume, the interrupt save, the prefetcher, remat, and the copies
of the JAX package's numpy helpers."""

import dataclasses
import threading
import time
import warnings
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dsen2_tpu.core import config as jconfig
from dsen2_tpu.data import patches_dataset as jpd
from dsen2_tpu.ops.dihedral import dihedral_batch as j_dihedral_batch
from dsen2_tpu.train import callbacks as jcallbacks
from dsen2_tpu.train import loop as jloop
from dsen2_tpu.train import staged as jstaged
from dsen2_tpu.train.nadam import nadam_keras
from dsen2_tpu.weights import load_keras_weights as j_load_keras
from dsen2_tpu.weights import load_params_npz as j_load_npz
from dsen2_tpu_torch.core import config as tconfig
from dsen2_tpu_torch.core.config import ModelConfig, TrainConfig
from dsen2_tpu_torch.data import patches_dataset as tpd
from dsen2_tpu_torch.models import s2net
from dsen2_tpu_torch.ops.dihedral import dihedral, dihedral_batch, dihedral_np
from dsen2_tpu_torch.train import callbacks, loop, staged
from dsen2_tpu_torch.train.loop import fit, restore_fit_state
from dsen2_tpu_torch.train.nadam import load_optimizer_state, make_optimizer
from dsen2_tpu_torch.weights import params_to_numpy, params_to_torch
from dsen2_tpu_torch.weights.checkpoint import restore_train_state

CFG = ModelConfig(in_channels=(4, 6), num_layers=2, feature_size=16)
JCFG = jconfig.ModelConfig(**dataclasses.asdict(CFG))


def _data(n_train=48, n_val=16, seed=0):
    """Seeded 32 x 32 crops; the label is a smooth function of the inputs."""
    rng = np.random.default_rng(seed)
    n = n_train + n_val
    x10 = rng.random((n, 32, 32, 4), dtype=np.float32)
    x20 = rng.random((n, 32, 32, 6), dtype=np.float32)
    lb = (x20 * 1.5 + 0.1 * x10[..., :1]).astype(np.float32)
    k = n_train
    return (x10[:k], x20[:k]), lb[:k], (x10[k:], x20[k:]), lb[k:]


def _params(seed=0):
    return s2net.init_params(torch.Generator().manual_seed(seed), CFG)


def _fit(tcfg, data, **kw):
    kw.setdefault("precision", "highest")
    return fit(CFG, tcfg, *data, verbose=False, device="cpu", **kw)


def _assert_params_close(a, b, rtol=1e-5, atol=1e-7):
    na, nb = params_to_numpy(a), params_to_numpy(b)
    for top, name in s2net.PARAM_NAMES:
        np.testing.assert_allclose(na[top][name], nb[top][name], rtol=rtol, atol=atol,
                                   err_msg=f"{top}.{name}")


def _assert_history_close(a, b, rtol=1e-5):
    assert len(a["loss"]) == len(b["loss"])
    for key in ("loss", "val_loss", "mse", "lr"):
        np.testing.assert_allclose(a[key], b[key], rtol=rtol, err_msg=key)


@pytest.mark.parametrize("augment", [False, True])
def test_fit_matches_jax_highest(augment):
    """Three epochs from the same params, host-fed, against JAX's fit at
    "highest": history rtol 1e-4, params rtol 1e-4 / atol 1e-5."""
    data, p0 = _data(), _params()
    state, hist = _fit(TrainConfig(batch_size=16, augment=augment), data, params=p0, epochs=3)
    jstate, jhist = jloop.fit(JCFG, jconfig.TrainConfig(batch_size=16, augment=augment), *data,
                              params=p0, epochs=3, precision="highest", verbose=False,
                              mesh=None)
    _assert_history_close(hist, jhist, rtol=1e-4)
    for top, name in s2net.PARAM_NAMES:
        np.testing.assert_allclose(state.params[top][name].numpy(),
                                   np.asarray(jstate.params[top][name]),
                                   rtol=1e-4, atol=1e-5, err_msg=f"{top}.{name}")
    assert hist["loss"][-1] < hist["loss"][0]


@pytest.mark.parametrize("augment", [False, True])
def test_staged_equals_host_fed(augment):
    """stage_data=True follows the host-fed trajectory; 40 = 2 x 16 + 8
    samples make the last batch short (masked in the staged epoch)."""
    data, p0 = _data(n_train=40), _params()
    tcfg = TrainConfig(batch_size=16, augment=augment)
    s_host, h_host = _fit(tcfg, data, params=p0, epochs=3)
    s_st, h_st = _fit(tcfg, data, params=p0, epochs=3, stage_data=True)
    _assert_history_close(h_st, h_host)
    _assert_params_close(s_st.params, s_host.params)


def test_staged_masked_metrics_equal_short_batch_mean():
    rng = np.random.default_rng(4)
    pred = torch.from_numpy(rng.random((16, 4, 4, 2), dtype=np.float32))
    target = torch.from_numpy(rng.random((16, 4, 4, 2), dtype=np.float32))
    mask = torch.zeros(16)
    mask[:10] = 1
    got = staged.masked_metrics(pred, target, mask)
    want = (torch.mean(torch.abs(pred[:10] - target[:10])),
            torch.mean(torch.square(pred[:10] - target[:10])))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


@pytest.mark.parametrize("stage_data", [False, True])
def test_resume_equals_uninterrupted(tmp_path, stage_data):
    """2 epochs, restore_fit_state from the periodic state, 2 more: the
    same history and params as 4 epochs straight."""
    data, p0 = _data(), _params()
    tc_a = TrainConfig(batch_size=16, augment=True, out_dir=str(tmp_path / "a"),
                       model_nr="s2_901_", state_every=0)
    state_a, hist_a = _fit(tc_a, data, params=p0, epochs=4, stage_data=stage_data)
    tc_b = TrainConfig(batch_size=16, augment=True, out_dir=str(tmp_path / "b"),
                       model_nr="s2_902_", state_every=2)
    _fit(tc_b, data, params=p0, epochs=2, stage_data=stage_data)
    rs = restore_fit_state(str(tmp_path / "b" / "s2_902_state"), CFG, tc_b)
    assert rs["start_epoch"] == 2 and len(rs["history"]["loss"]) == 2
    assert set(rs["plateau_state"]) == {"lr", "best", "wait", "cooldown_counter"}
    assert rs["best_val"] == min(rs["history"]["val_loss"])
    state_b, hist_b = _fit(tc_b, data, epochs=4, stage_data=stage_data, **rs)
    _assert_history_close(hist_b, hist_a)
    _assert_params_close(state_b.params, state_a.params)


def test_interrupt_saves_the_last_completed_epoch(tmp_path):
    """Ctrl-C during epoch 3 leaves a state with 2 completed epochs whose
    params are those of a 2-epoch run (not epoch 3's, which training had
    already applied in place)."""
    data, p0 = _data(), _params()
    tcfg = TrainConfig(batch_size=16, out_dir=str(tmp_path), model_nr="s2_997_",
                       state_every=0)
    calls = {"n": 0}
    orig = callbacks.ReduceLROnPlateau.step

    def boom(self, val_loss):
        calls["n"] += 1
        if calls["n"] >= 3:
            raise KeyboardInterrupt
        return orig(self, val_loss)

    with mock.patch.object(callbacks.ReduceLROnPlateau, "step", boom):
        with pytest.raises(KeyboardInterrupt):
            _fit(tcfg, data, params=p0, epochs=10)
    restored = restore_train_state(str(tmp_path / "s2_997_interrupted"))
    assert restored["epoch"] == 2
    two, _ = _fit(TrainConfig(batch_size=16), data, params=p0, epochs=2)
    _assert_params_close(restored["params"], two.params, rtol=0, atol=0)


def test_fit_writes_checkpoints_the_jax_package_reads(tmp_path):
    data, p0 = _data(), _params()
    tcfg = TrainConfig(lr=1e-3, batch_size=16, out_dir=str(tmp_path), model_nr="s2_999_")
    state, hist = _fit(tcfg, data, params=p0, epochs=3)
    assert (tmp_path / "s2_999__lr_1.0e-03.txt").exists()
    assert (tmp_path / "s2_999_state").is_dir()
    best = int(np.argmin(hist["val_loss"]))
    npz = j_load_npz(str(tmp_path / "s2_999_lr_1e-03.npz"))
    h5 = j_load_keras(str(tmp_path / "s2_999_lr_1e-03.hdf5"), JCFG)
    for top, name in s2net.PARAM_NAMES:
        np.testing.assert_array_equal(npz[top][name], np.asarray(h5[top][name]))
    if best == 2:
        for top, name in s2net.PARAM_NAMES:
            np.testing.assert_array_equal(npz[top][name], state.params[top][name].numpy())


def test_best_checkpoint_without_h5py_writes_npz_and_warns_once(tmp_path, monkeypatch):
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "h5py" else real(name, *a))
    with pytest.warns(UserWarning, match="h5py") as rec:
        ckpt = callbacks.BestCheckpoint(str(tmp_path / "best"), verbose=False)
    assert len(rec) == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert ckpt.maybe_save(1.0, params_to_torch(_params(), "cpu"))
        assert not ckpt.maybe_save(2.0, params_to_torch(_params(), "cpu"))
    assert (tmp_path / "best.npz").exists() and not (tmp_path / "best.hdf5").exists()


def test_remat_equals_no_remat():
    data, p0 = _data(), _params()
    tcfg = TrainConfig(batch_size=16)
    a, ha = _fit(tcfg, data, params=p0, epochs=1, precision="high")
    b, hb = _fit(tcfg, data, params=p0, epochs=1, precision="high", remat=True)
    _assert_history_close(ha, hb, rtol=0)
    _assert_params_close(a.params, b.params, rtol=0, atol=0)


def test_flags_roundtrip_and_mismatch_warns(tmp_path):
    data = _data()
    tcfg = TrainConfig(lr=1e-3, batch_size=8, out_dir=str(tmp_path), model_nr="s2_904_",
                       state_every=2, augment=True, seed=7)
    _fit(tcfg, data, epochs=2)
    path = str(tmp_path / "s2_904_state")
    rs = restore_fit_state(path, CFG, tcfg)
    assert rs["train_flags"] == {"lr": 1e-3, "batch_size": 8, "augment": True, "seed": 7}
    other = dataclasses.replace(tcfg, lr=5e-4, augment=False)
    with pytest.warns(UserWarning, match="resume flags differ"):
        restore_fit_state(path, CFG, other)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        rs2 = restore_fit_state(path, CFG, other, warn_mismatch=False)
    assert rs2["train_flags"]["augment"] is True
    _, hist = _fit(tcfg, data, epochs=3, **rs)  # fit takes the splatted restore
    assert len(hist["loss"]) == 3


def test_force_lr_drives_the_updates():
    data, p0 = _data(), _params()
    _, hist = _fit(TrainConfig(batch_size=16), data, params=p0, epochs=1, force_lr=5e-2)
    assert hist["lr"] == [5e-2]


def test_mesh_and_streaming_raise():
    """A device= that is not the mesh's first device is refused (the params
    live there); a streaming dataset cannot be staged on the device."""
    from dsen2_tpu_torch.parallel import make_mesh

    data = _data()
    with pytest.raises(ValueError, match="mesh's first device"):
        fit(CFG, TrainConfig(batch_size=16), *data, mesh=make_mesh([torch.device("cpu")] * 2),
            device="meta", epochs=1, verbose=False)

    class Stream:
        def epoch_batches(self, epoch, batch_size):
            return iter(())

    with pytest.raises(ValueError, match="stage_data"):
        fit(CFG, TrainConfig(), Stream(), None, None, None, stage_data=True, device="cpu")


def test_fit_needs_a_gpu_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fit(CFG, TrainConfig(batch_size=16), *_data(), epochs=1, verbose=False)


def test_stream_producer_augments_like_the_host_producer():
    """_stream_producer over an object with epoch_batches yields the batches
    the in-RAM producer yields for the same order and codes."""
    data = _data()
    tcfg = TrainConfig(batch_size=16, augment=True, seed=3)
    order = np.random.default_rng(5).permutation(48)

    class Stream:
        def epoch_batches(self, epoch, batch_size):
            for i in range(0, 48, batch_size):
                idx = order[i : i + batch_size]
                yield len(idx), [a[idx] for a in data[0]], data[1][idx]

    class Perm:
        def permutation(self, n):
            return order

    def place(arrs):
        return tuple(torch.from_numpy(np.asarray(a)) for a in arrs)

    got = list(loop._stream_producer(Stream(), tcfg, 2, place))
    want = list(loop._host_producer(tcfg, data[0], data[1], Perm(), 48, place, 2))
    assert len(got) == len(want) == 3
    for (c1, i1, t1), (c2, i2, t2) in zip(got, want):
        assert c1 == c2
        for a, b in zip(i1 + (t1,), i2 + (t2,)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


class TestPrefetch:
    def test_producer_unblocks_when_consumer_stops_early(self):
        n_before = threading.active_count()
        produced = []

        def gen():
            for i in range(1000):
                produced.append(i)
                yield i

        for item in loop._prefetch(gen(), depth=2):
            if item == 1:
                break
        deadline = time.time() + 5.0
        while threading.active_count() > n_before and time.time() < deadline:
            time.sleep(0.01)
        assert threading.active_count() <= n_before
        assert len(produced) < 1000

    def test_exception_from_producer_propagates(self):
        def gen():
            yield 1
            raise ValueError("boom")

        it = loop._prefetch(gen(), depth=2)
        assert next(it) == 1
        with pytest.raises(ValueError, match="boom"):
            list(it)


def test_optimizer_is_keras_nadam():
    """make_optimizer over a params dict follows nadam_keras for 50 steps,
    also across a state_dict round trip at step 25, which keeps NAdam's
    mu_product on the host."""
    p0 = _params()
    grads = [{top: {k: (0.3 * np.cos(v * (i + 1))).astype(np.float32) for k, v in sub.items()}
              for top, sub in p0.items()} for i in range(50)]
    tcfg = TrainConfig(lr=1e-3)
    tp = {top: {k: torch.tensor(v, requires_grad=True) for k, v in sub.items()}
          for top, sub in p0.items()}
    opt = make_optimizer(tp, tcfg)
    jopt = nadam_keras(learning_rate=1e-3, schedule_decay=tcfg.schedule_decay)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    jst = jopt.init(jp)
    for i, g in enumerate(grads):
        for top, name in s2net.PARAM_NAMES:
            tp[top][name].grad = torch.from_numpy(g[top][name])
        opt.step()
        upd, jst = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jst)
        jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, upd)
        if i == 24:
            sd = opt.state_dict()
            opt = make_optimizer(tp, tcfg)
            load_optimizer_state(opt, sd)
            assert all(st["mu_product"].device.type == "cpu" for st in opt.state.values())
    for top, name in s2net.PARAM_NAMES:
        np.testing.assert_allclose(tp[top][name].detach().numpy(), np.asarray(jp[top][name]),
                                   rtol=2e-5, atol=2e-6)


def test_params_to_numpy_inverts_params_to_torch():
    p = _params()
    back = params_to_numpy(params_to_torch(p, "cpu"))
    for top, name in s2net.PARAM_NAMES:
        np.testing.assert_array_equal(back[top][name], p[top][name])
        assert back[top][name].dtype == np.float32


def test_train_config_copy_equal():
    def fields(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)}

    assert fields(tconfig.TrainConfig) == fields(jconfig.TrainConfig)


@pytest.mark.parametrize("steps,batch", [(3, 16), (1, 5), (70, 8)])
def test_epoch_aug_codes_and_pad_perm_copies_equal(steps, batch):
    for seed, epoch in ((0, 0), (7, 3)):
        np.testing.assert_array_equal(staged.epoch_aug_codes(seed, epoch, steps, batch),
                                      jstaged.epoch_aug_codes(seed, epoch, steps, batch))
    perm = np.random.default_rng(steps).permutation(steps * batch - 1)
    for a, b in zip(staged.pad_perm(perm, batch), jstaged.pad_perm(perm, batch)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_plateau_copy_equal_on_one_sequence():
    seq = [1.0, 0.9, 0.9, 0.9, 0.9, 0.9, 0.9, 0.85, 0.85 + 1e-7, 0.86, 0.86, 0.86, 0.86,
           0.86, 0.86, 0.86, 0.5] + [0.5] * 30
    kw = dict(lr=1e-4, factor=0.5, patience=2, cooldown=3, min_lr=2e-5, verbose=False)
    a, b = callbacks.ReduceLROnPlateau(**kw), jcallbacks.ReduceLROnPlateau(**kw)
    for v in seq:
        assert a.step(v) == b.step(v)
        assert (a.best, a.wait, a.cooldown_counter) == (b.best, b.wait, b.cooldown_counter)
    assert a.lr == 2e-5


def test_dihedral_batch_equals_jax_for_all_codes():
    x = np.random.default_rng(2).random((16, 6, 6, 3)).astype(np.float32)
    codes = np.arange(16, dtype=np.int32) % 8
    got = dihedral_batch(torch.from_numpy(x), torch.from_numpy(codes)).numpy()
    want = np.asarray(j_dihedral_batch(jnp.asarray(x), jnp.asarray(codes)))
    np.testing.assert_array_equal(got, want)
    for c in range(8):
        np.testing.assert_array_equal(dihedral(torch.from_numpy(x[c]), c).numpy(),
                                      dihedral_np(x[c], c))
    with pytest.raises(ValueError, match="square"):
        dihedral_batch(torch.zeros(2, 4, 6, 1), torch.zeros(2, dtype=torch.int32))


def _archive(root, run_60, n=24, hw=16):
    rng = np.random.default_rng(6)
    names = ["data10", "data20"] + (["data60", "data60_gt"] if run_60 else ["data20_gt"])
    chans = {"data10": 4, "data20": 6, "data60": 2, "data60_gt": 2, "data20_gt": 6}
    train = root / ("train60" if run_60 else "train")
    for t in range(2):
        tile = train / f"T{t}.SAFE"
        tile.mkdir(parents=True)
        for name in names:
            np.save(tile / f"{name}.npy",
                    (rng.random((n, chans[name], hw, hw)) * 5000).astype(np.float32))
    np.save(train / "val_index.npy", tpd.make_val_index(2 * n, 0.25, seed=1))
    test = root / "test" / "T9.SAFE"
    test.mkdir(parents=True)
    for name in ("data10", "data20", "data60"):
        np.save(test / f"{name}.npy",
                (rng.random((5, chans[name], hw, hw)) * 5000).astype(np.float32))
    (test / "roi.json").write_text("[2, 3, 40, 30]")
    return test


@pytest.mark.parametrize("run_60", [False, True])
def test_patch_loaders_copies_equal(tmp_path, run_60):
    for n, frac, seed in ((100, 0.1, 0), (37, 0.3, 5)):
        np.testing.assert_array_equal(tpd.make_val_index(n, frac, seed),
                                      jpd.make_val_index(n, frac, seed))
    test = _archive(tmp_path, run_60)
    got = tpd.open_data_files(str(tmp_path), run_60, 2000.0)
    want = jpd.open_data_files(str(tmp_path), run_60, 2000.0)
    def flat(t):
        return list(t[0]) + [t[1]] + list(t[2]) + [t[3]]

    for a, b in zip(flat(got), flat(want)):
        np.testing.assert_array_equal(a, b)
    ti, ts = tpd.open_data_files_test(str(test), run_60, 2000.0)
    ji, js = jpd.open_data_files_test(str(test), run_60, 2000.0)
    assert ts == js == [27, 38]
    for a, b in zip(ti, ji):
        np.testing.assert_array_equal(a, b)
