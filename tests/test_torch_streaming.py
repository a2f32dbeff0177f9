"""The port's streaming training path against dsen2_tpu's, on the CPU:
StreamingPatchDataset yields the same batches per epoch, and fit over a
streaming dataset follows the JAX package's fit at 2 blocks x 16 features
(history and params within rtol 1e-4), with the val split loaded once or
streamed per epoch."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from dsen2_tpu.core import config as jconfig
from dsen2_tpu.data import streaming as jstreaming
from dsen2_tpu.train import loop as jloop
from dsen2_tpu_torch.core.config import ModelConfig, TrainConfig
from dsen2_tpu_torch.data import streaming as tstreaming
from dsen2_tpu_torch.models import s2net
from dsen2_tpu_torch.train import loop
from dsen2_tpu_torch.train.loop import fit, restore_fit_state
from dsen2_tpu_torch.weights import params_to_numpy

CFG = ModelConfig(in_channels=(4, 6), num_layers=2, feature_size=16)
JCFG = jconfig.ModelConfig(**dataclasses.asdict(CFG))
SCALE = 2000.0


def _write_tiles(root, counts, hw=32, seed=0, run_60=False):
    """Reference-format train[60]/ archives, one tile per count, and a val
    mask of every fourth slot."""
    rng = np.random.default_rng(seed)
    train = root / ("train60" if run_60 else "train")
    names = ("data10", "data20", "data60", "data60_gt") if run_60 else (
        "data10", "data20", "data20_gt")
    chans = {"data10": 4, "data20": 6, "data60": 2, "data60_gt": 2, "data20_gt": 6}
    for i, n in enumerate(counts):
        tile = train / f"T{i:02d}.SAFE"
        os.makedirs(tile)
        arrs = {k: (rng.random((n, chans[k], hw, hw)) * SCALE).astype(np.float32)
                for k in names}
        gt = names[-1]
        arrs[gt] = (arrs[names[-2]] * 1.5 + 0.1 * arrs["data10"][:, :1]).astype(np.float32)
        for k, a in arrs.items():
            np.save(tile / f"{k}.npy", a)
    val = np.zeros(sum(counts), bool)
    val[::4] = True
    np.save(train / "val_index.npy", val)
    return str(root)


def _assert_batches_equal(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for (ca, ia, la), (cb, ib, lb) in zip(a, b):
        assert ca == cb and len(ia) == len(ib)
        for x, y in zip(ia, ib):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(la, lb)


@pytest.mark.parametrize("run_60,counts,batch", [(False, (37, 20, 9), 8),
                                                 (False, (5, 40), 16), (True, (13, 11), 6)])
def test_streaming_dataset_yields_the_same_batches(tmp_path, run_60, counts, batch):
    path = _write_tiles(tmp_path, counts, hw=12, run_60=run_60)
    t = tstreaming.StreamingPatchDataset(path, run_60, SCALE, seed=3)
    j = jstreaming.StreamingPatchDataset(path, run_60, SCALE, seed=3)
    assert (t.n_train, t.n_val, t.val_nbytes()) == (j.n_train, j.n_val, j.val_nbytes())
    for epoch in range(3):
        _assert_batches_equal(t.epoch_batches(epoch, batch), j.epoch_batches(epoch, batch))
    _assert_batches_equal(t.val_batches(batch), j.val_batches(batch))
    (t_in, t_lb), (j_in, j_lb) = t.load_val(), j.load_val()
    for a, b in zip(t_in + (t_lb,), j_in + (j_lb,)):
        np.testing.assert_array_equal(a, b)


def test_streaming_dataset_raises_like_the_original(tmp_path):
    for mod in (tstreaming, jstreaming):
        with pytest.raises(FileNotFoundError, match="no \\*SAFE tile dirs"):
            mod.StreamingPatchDataset(str(tmp_path), False, SCALE)
    path = _write_tiles(tmp_path, (8,), hw=4)
    np.save(tmp_path / "train" / "val_index.npy", np.zeros(9, bool))
    for mod in (tstreaming, jstreaming):
        with pytest.raises(ValueError, match="val_index length"):
            mod.StreamingPatchDataset(path, False, SCALE)
    os.remove(tmp_path / "train" / "val_index.npy")
    for mod in (tstreaming, jstreaming):
        with pytest.raises(FileNotFoundError, match="val_index.npy missing"):
            mod.StreamingPatchDataset(path, False, SCALE)


def _params(seed=0):
    return s2net.init_params(torch.Generator().manual_seed(seed), CFG)


@pytest.mark.parametrize("augment,stream_val", [(False, False), (True, True)])
def test_fit_streaming_matches_jax(tmp_path, monkeypatch, augment, stream_val):
    """Three epochs over 3 tiles (61 train, 21 val crops, batch 16: carried
    remainders and a short last batch) from the same params, at "highest".
    With stream_val the val split streams tile by tile in both packages."""
    if stream_val:
        monkeypatch.setattr(loop, "VAL_STREAM_THRESHOLD_BYTES", 0)
        monkeypatch.setattr(jloop, "VAL_STREAM_THRESHOLD_BYTES", 0)
    path = _write_tiles(tmp_path, (37, 20, 25))
    p0 = _params()
    tcfg = TrainConfig(batch_size=16, augment=augment, seed=2)
    state, hist = fit(CFG, tcfg, tstreaming.StreamingPatchDataset(path, False, SCALE, seed=2),
                      None, None, None, params=p0, epochs=3, precision="highest",
                      verbose=False, device="cpu")
    jstate, jhist = jloop.fit(
        JCFG, jconfig.TrainConfig(batch_size=16, augment=augment, seed=2),
        jstreaming.StreamingPatchDataset(path, False, SCALE, seed=2), None, None, None,
        params=p0, epochs=3, precision="highest", verbose=False, mesh=None)
    for key in ("loss", "val_loss", "mse", "lr"):
        np.testing.assert_allclose(hist[key], jhist[key], rtol=1e-4, err_msg=key)
    got = params_to_numpy(state.params)
    for top, name in s2net.PARAM_NAMES:
        np.testing.assert_allclose(got[top][name], np.asarray(jstate.params[top][name]),
                                   rtol=1e-4, atol=1e-5, err_msg=f"{top}.{name}")
    assert hist["loss"][-1] < hist["loss"][0]


def test_streamed_val_equals_loaded_val(tmp_path, monkeypatch):
    path = _write_tiles(tmp_path, (30, 19))
    runs = []
    for threshold in (1 << 30, 0):
        monkeypatch.setattr(loop, "VAL_STREAM_THRESHOLD_BYTES", threshold)
        ds = tstreaming.StreamingPatchDataset(path, False, SCALE)
        runs.append(fit(CFG, TrainConfig(batch_size=8), ds, None, None, None, params=_params(),
                        epochs=2, precision="highest", verbose=False, device="cpu")[1])
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(runs[1][key], runs[0][key], rtol=1e-6, err_msg=key)


def test_streaming_resume_equals_uninterrupted(tmp_path):
    """2 epochs, restore, 2 more: the stream draws each epoch's order from
    (seed, epoch), so the resumed run replays the straight one."""
    path = _write_tiles(tmp_path, (30, 19))
    p0 = _params()

    def run(out, epochs, every, **kw):
        tcfg = TrainConfig(batch_size=8, augment=True, out_dir=str(tmp_path / out),
                           model_nr="s2_903_", state_every=every)
        ds = tstreaming.StreamingPatchDataset(path, False, SCALE, seed=1)
        return fit(CFG, tcfg, ds, None, None, None, epochs=epochs, precision="highest",
                   verbose=False, device="cpu", **kw), tcfg

    (straight, hist_a), _ = run("a", 4, 0, params=p0)
    _, tcfg = run("b", 2, 2, params=p0)
    rs = restore_fit_state(str(tmp_path / "b" / "s2_903_state"), CFG, tcfg)
    (resumed, hist_b), _ = run("b", 4, 2, **rs)
    for key in ("loss", "val_loss", "mse", "lr"):
        np.testing.assert_allclose(hist_b[key], hist_a[key], rtol=1e-5, err_msg=key)
    a, b = params_to_numpy(straight.params), params_to_numpy(resumed.params)
    for top, name in s2net.PARAM_NAMES:
        np.testing.assert_allclose(b[top][name], a[top][name], rtol=1e-5, atol=1e-7)


def test_streaming_with_stage_data_raises(tmp_path):
    ds = tstreaming.StreamingPatchDataset(_write_tiles(tmp_path, (8,), hw=4), False, SCALE)
    with pytest.raises(ValueError, match="stage_data"):
        fit(CFG, TrainConfig(), ds, None, None, None, stage_data=True, device="cpu")
