"""The port's training CLI (dsen2_tpu_torch.cli.train) on the CPU: --smoke
at full DSen2 width, full-state and weights-only --resume, and --predict and
--stream against the JAX package's CLI."""

import json
import os

import numpy as np
import pytest

from dsen2_tpu.cli import train as j_train_cli
from dsen2_tpu_torch.cli import train as train_cli
from dsen2_tpu_torch.core import config
from dsen2_tpu_torch.core.config import ModelConfig
from dsen2_tpu_torch.models import s2net
from dsen2_tpu_torch.weights import load_params_npz, save_params_npz

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ModelConfig(in_channels=(4, 6), num_layers=2, feature_size=16)


@pytest.fixture
def tiny(monkeypatch):
    """The CLI builds dsen2_2x(); these tests train a 2 x 16 net instead."""
    monkeypatch.setattr(config, "dsen2_2x", lambda deep=False: TINY)


def _make_train_data(root):
    rng = np.random.default_rng(7)
    n = 32
    tile = root / "train" / "SYNTH_T11XXX.SAFE"
    os.makedirs(tile)
    d10 = (rng.random((n, 4, 16, 16)) * 2000).astype(np.float32)
    d20 = (rng.random((n, 6, 16, 16)) * 2000).astype(np.float32)
    np.save(tile / "data10.npy", d10)
    np.save(tile / "data20.npy", d20)
    np.save(tile / "data20_gt.npy", (d20 * 1.2).astype(np.float32))
    val = np.zeros(n, bool)
    val[::4] = True
    np.save(root / "train" / "val_index.npy", val)


def _run(*argv):
    return train_cli.main([str(a) for a in argv], device="cpu")


def _weights(root, name):
    return load_params_npz(str(root / "network_data" / name))


def _assert_weights_close(a, b):
    for top, name in s2net.PARAM_NAMES:
        np.testing.assert_allclose(b[top][name], a[top][name], rtol=1e-5, atol=1e-7)


def test_smoke_at_full_width(tmp_path, capsys):
    assert _run("--smoke", "--path", f"{tmp_path}/", "--precision", "highest") == 0
    out = tmp_path / "network_data"
    assert (out / "s2_038_lr_1e-04.npz").exists() and (out / "s2_038_state").is_dir()
    assert _weights(tmp_path, "s2_038_lr_1e-04.npz")["blocks"]["w1"].shape == (6, 3, 3, 128, 128)
    assert "ok=True" in capsys.readouterr().out


def test_resume_matches_uninterrupted(tmp_path, tiny):
    a, b = tmp_path / "a", tmp_path / "b"
    for root in (a, b):
        _make_train_data(root)
    common = ["--batch-size", "8", "--model-nr", "s2_555_"]
    assert _run("--path", f"{a}/", "--epochs", "4", *common) == 0
    assert _run("--path", f"{b}/", "--epochs", "2", *common) == 0
    state_dir = b / "network_data" / "s2_555_state"
    assert state_dir.is_dir()
    assert _run("--path", f"{b}/", "--epochs", "4", "--batch-size", "8",
                "--resume", state_dir) == 0
    _assert_weights_close(_weights(a, "s2_555_lr_1e-04.npz"), _weights(b, "s2_555_lr_1e-04.npz"))


def test_resume_adopts_checkpointed_flags(tmp_path, tiny):
    a, b = tmp_path / "a", tmp_path / "b"
    for root in (a, b):
        _make_train_data(root)
    flags = ["--batch-size", "8", "--model-nr", "s2_556_", "--augment", "--seed", "3",
             "--lr", "5e-4", "--stage-data"]
    assert _run("--path", f"{a}/", "--epochs", "4", *flags) == 0
    assert _run("--path", f"{b}/", "--epochs", "2", *flags) == 0
    state_dir = b / "network_data" / "s2_556_state"
    assert _run("--path", f"{b}/", "--epochs", "4", "--stage-data", "--resume", state_dir) == 0
    _assert_weights_close(_weights(a, "s2_556_lr_5e-04.npz"), _weights(b, "s2_556_lr_5e-04.npz"))


def test_resume_explicit_flags_win(tmp_path, tiny, capsys):
    _make_train_data(tmp_path)
    assert _run("--path", f"{tmp_path}/", "--epochs", "2", "--batch-size", "8",
                "--model-nr", "s2_558_", "--seed", "3", "--augment") == 0
    state_dir = tmp_path / "network_data" / "s2_558_state"
    assert _run("--path", f"{tmp_path}/", "--epochs", "3", "--resume", state_dir,
                "--seed", "0", "--no-augment", "--lr", "5e-2") == 0
    out = capsys.readouterr().out
    assert out.count("overrides the checkpointed") == 3  # seed, augment, lr
    assert "lr 5.0e-02" in out
    assert (tmp_path / "network_data" / "s2_558_lr_5e-02.npz").exists()


@pytest.mark.parametrize("fmt", ["npz", "hdf5"])
def test_weights_only_resume(tmp_path, tiny, capsys, fmt):
    """--resume WEIGHTS starts from those weights (an .npz, or a Keras
    .hdf5 the JAX package wrote) and takes the run prefix from the name."""
    from dsen2_tpu.weights import save_keras_weights as j_save_keras

    _make_train_data(tmp_path)
    params = s2net.init_params(torch.Generator().manual_seed(4), TINY)
    wpath = str(tmp_path / f"s2_777_lr_1e-04.{fmt}")
    (save_params_npz if fmt == "npz" else j_save_keras)(wpath, params)
    assert _run("--path", f"{tmp_path}/", "--epochs", "1", "--batch-size", "8",
                "--resume", wpath) == 0
    assert "Changing the model number to: s2_777_" in capsys.readouterr().out
    got = _weights(tmp_path, "s2_777_lr_1e-04.npz")
    assert not np.array_equal(got["head"]["w"], params["head"]["w"])
    assert np.abs(got["head"]["w"] - params["head"]["w"]).max() < 1e-3


def test_predict_matches_the_jax_cli(tmp_path):
    """--predict over a reference-format test archive (4 patches on a 2 x 2
    grid and one zero slack slot) writes the mosaic the JAX CLI writes,
    within the "high" class's tolerance."""
    rng = np.random.default_rng(8)
    tile = tmp_path / "test" / "SYNTH.SAFE"
    tile.mkdir(parents=True)
    np.save(tile / "data10.npy", (rng.random((5, 4, 32, 32)) * 5000).astype(np.float32))
    np.save(tile / "data20.npy", (rng.random((5, 6, 32, 32)) * 5000).astype(np.float32))
    (tile / "roi.json").write_text(json.dumps([0, 0, 48, 48]))
    weights = os.path.join(REPO, "models", "s2_032_lr_1e-04.hdf5")
    out = tile / "s2_032_-predict.npy"
    assert j_train_cli.main(["--predict", weights, "--path", f"{tmp_path}/"]) == 0
    want = np.load(out)
    os.remove(out)
    assert _run("--predict", weights.replace(".hdf5", ".npz"), "--path", f"{tmp_path}/") == 0
    got = np.load(out)
    assert got.shape == want.shape == (48, 48, 6) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max()


def test_stream_raises(tmp_path, tiny, monkeypatch, capsys):
    """--stream with --stage-data raises in both packages; --stream alone
    follows the JAX CLI from the same weights (a weights-only resume, since
    the packages' fresh inits differ): the same streaming line, and best
    weights within fit's parity (rtol 1e-4)."""
    from dsen2_tpu.core import config as jconfig
    from dsen2_tpu.weights import load_keras_weights as j_load_keras
    from dsen2_tpu_torch.weights import save_keras_weights

    monkeypatch.setattr(jconfig, "dsen2_2x",
                        lambda deep=False: jconfig.ModelConfig(in_channels=(4, 6), num_layers=2,
                                                               feature_size=16))
    roots = {name: tmp_path / name for name in ("jax", "port")}
    for root in roots.values():
        _make_train_data(root)
    for main, kw in ((j_train_cli.main, {}), (train_cli.main, {"device": "cpu"})):
        with pytest.raises(ValueError, match="stage_data"):
            main(["--path", f"{roots['port']}/", "--stream", "--stage-data", "--epochs", "1"],
                 **kw)
    capsys.readouterr()
    wpath = str(tmp_path / "s2_777_lr_1e-04.hdf5")
    save_keras_weights(wpath, s2net.init_params(torch.Generator().manual_seed(4), TINY))
    outs = {}
    for name, main, kw in (("jax", j_train_cli.main, {}), ("port", train_cli.main,
                                                         {"device": "cpu"})):
        assert main(["--path", f"{roots[name]}/", "--stream", "--epochs", "2", "--batch-size",
                     "8", "--precision", "highest", "--resume", wpath], **kw) == 0
        outs[name] = capsys.readouterr().out
    line = "Streaming 24 train / 8 val patches from 1 tiles."
    assert line in outs["jax"] and line in outs["port"]
    want = j_load_keras(str(roots["jax"] / "network_data" / "s2_777_lr_1e-04.hdf5"), TINY)
    got = _weights(roots["port"], "s2_777_lr_1e-04.npz")
    for top, name in s2net.PARAM_NAMES:
        np.testing.assert_allclose(got[top][name], np.asarray(want[top][name]), rtol=1e-4,
                                   atol=1e-5, err_msg=f"{top}.{name}")
