"""The port's full-state checkpoint (weights/checkpoint.py): the five
behaviours tests/test_checkpoint.py holds the JAX package's orbax checkpoint
to, with torch.save in place of orbax."""

import os

import numpy as np
import pytest
import torch

from dsen2_tpu_torch.core.config import ModelConfig, TrainConfig
from dsen2_tpu_torch.models import s2net
from dsen2_tpu_torch.train.nadam import load_optimizer_state, make_optimizer
from dsen2_tpu_torch.weights import checkpoint as ckpt_mod
from dsen2_tpu_torch.weights import params_to_torch
from dsen2_tpu_torch.weights.checkpoint import restore_train_state, save_train_state

CFG = ModelConfig(in_channels=(4, 6), num_layers=1, feature_size=8)


def _state(seed=0, steps=3):
    params = params_to_torch(s2net.init_params(torch.Generator().manual_seed(seed), CFG), "cpu")
    for t in s2net.param_leaves(params):
        t.requires_grad_()
    opt = make_optimizer(params, TrainConfig(lr=1e-3))
    for i in range(steps):
        _step(params, opt, i)
    return params, opt


def _step(params, opt, i):
    for t in s2net.param_leaves(params):
        t.grad = torch.cos(t.detach() * (i + 1)) * 0.1
    opt.step()


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    elif torch.is_tensor(a):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    else:
        assert a == b


class TestRoundTrip:
    def test_state_roundtrip(self, tmp_path):
        params, opt = _state()
        path = str(tmp_path / "ckpt")
        save_train_state(path, params, opt.state_dict(), epoch=3,
                         extra={"best": np.float32(0.5), "hist": np.arange(3.0)})
        restored = restore_train_state(path)
        _assert_tree_equal(restored["params"],
                           {t: {k: v.detach() for k, v in s.items()} for t, s in params.items()})
        _assert_tree_equal(restored["opt_state"], opt.state_dict())
        assert restored["epoch"] == 3
        assert restored["extra"] == {"best": 0.5, "hist": [0.0, 1.0, 2.0]}

    def test_resume_continues_trajectory(self, tmp_path):
        """Restoring the optimizer state reproduces the uninterrupted run
        exactly (the reference's --resume restarts the moments)."""
        p, opt = _state(seed=1, steps=0)
        for i in range(6):
            _step(p, opt, i)

        p2, opt2 = _state(seed=1, steps=3)
        path = str(tmp_path / "mid")
        save_train_state(path, p2, opt2.state_dict(), epoch=3)
        restored = restore_train_state(path)
        p3 = {t: {k: v.clone().requires_grad_() for k, v in s.items()}
              for t, s in restored["params"].items()}
        opt3 = make_optimizer(p3, TrainConfig(lr=1e-3))
        load_optimizer_state(opt3, restored["opt_state"])
        for i in range(3, 6):
            _step(p3, opt3, i)
        for a, b in zip(s2net.param_leaves(p), s2net.param_leaves(p3)):
            torch.testing.assert_close(a.detach(), b.detach(), rtol=0, atol=0)


class TestCrashSafety:
    """save_train_state never destroys the previous checkpoint before the
    new one is fully written."""

    def test_crash_during_write_keeps_previous(self, tmp_path, monkeypatch):
        params, opt = _state()
        path = str(tmp_path / "ckpt")
        save_train_state(path, params, opt.state_dict(), epoch=3)

        class Boom(RuntimeError):
            pass

        def failing(state, where):
            os.makedirs(where)
            raise Boom("disk died mid-save")

        monkeypatch.setattr(ckpt_mod, "_write", failing)
        with pytest.raises(Boom):
            save_train_state(path, params, opt.state_dict(), epoch=7)
        monkeypatch.undo()
        assert restore_train_state(path)["epoch"] == 3  # previous state survived
        save_train_state(path, params, opt.state_dict(), epoch=8)  # stale .tmp replaced
        assert restore_train_state(path)["epoch"] == 8

    def test_second_save_replaces_and_cleans_up(self, tmp_path):
        params, opt = _state()
        path = str(tmp_path / "ckpt")
        save_train_state(path, params, opt.state_dict(), epoch=1)
        save_train_state(path, params, opt.state_dict(), epoch=2)
        assert restore_train_state(path)["epoch"] == 2
        assert not os.path.exists(path + ".tmp")
        assert not os.path.exists(path + ".old")

    def test_restore_falls_back_to_old(self, tmp_path):
        """A crash between the two swap renames leaves only ckpt.old."""
        params, opt = _state()
        path = str(tmp_path / "ckpt")
        save_train_state(path, params, opt.state_dict(), epoch=5)
        os.rename(path, path + ".old")
        assert restore_train_state(path)["epoch"] == 5
