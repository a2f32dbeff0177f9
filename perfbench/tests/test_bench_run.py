"""Runs of the harness on the CPU at a tiny size: sound runs come out
correct, the control and each planted fault do not, and run.py without a
card fails without a result."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny

CELLS = ("dsen2.tile", "vdsen2.roi", "dsen2.product", "dsen2.train")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, monkeypatch, tmp_path):
    r = tiny.run(tiny.cell(name, monkeypatch, tmp_path))
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {m["name"] for m in harness.load_cell(name).end_to_end}
    assert list(r)[-1] == "checks"
    assert not os.listdir(tmp_path) or name != "dsen2.product" or not any(
        f.startswith("perfbench_product") for f in os.listdir(tmp_path))


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, monkeypatch, tmp_path):
    """The program's own one-pass path ("default") in place of "high"."""
    r = tiny.run(tiny.cell(name, monkeypatch, tmp_path), precision="default")
    assert not r["correct"], r["checks"]


def altered_interiors(monkeypatch):
    """An answer altered where it is produced: each patch interior written
    into the mosaic 50 DN off at its centre."""
    from dsen2_tpu_torch.infer import api

    orig = api.write_interiors

    def write(mosaic, interiors, positions):
        bad = interiors.clone()
        c = bad.shape[1] // 2
        bad[:, c, c, :] += 50
        return orig(mosaic, bad, positions)

    monkeypatch.setattr(api, "write_interiors", write)


@pytest.mark.parametrize("name", ("dsen2.tile", "vdsen2.roi", "dsen2.product"))
def test_altered_answer_is_not_correct(name, monkeypatch, tmp_path):
    c = tiny.cell(name, monkeypatch, tmp_path)
    altered_interiors(monkeypatch)
    assert not tiny.run(c)["correct"]


def test_unchanged_state_is_not_correct(monkeypatch, tmp_path):
    """A step that returns its state unchanged: the optimizer moves nothing."""
    from dsen2_tpu_torch.train import loop

    c = tiny.cell("dsen2.train", monkeypatch, tmp_path)
    orig = loop.make_optimizer

    def frozen_opt(params, train_cfg):
        opt = orig(params, train_cfg)
        for g in opt.param_groups:
            g["lr"] = 0.0
        return opt

    monkeypatch.setattr(loop, "make_optimizer", frozen_opt)
    r = tiny.run(c)
    assert not r["correct"] and r["checks"]["change_gap"]["value"] > 0.5


def test_state_dropped_on_resume_is_not_correct(monkeypatch, tmp_path):
    """The window's calls resume the parameters but drop the optimizer's
    state: its step count starts again at every call."""
    from dsen2_tpu_torch.train import loop

    c = tiny.cell("dsen2.train", monkeypatch, tmp_path)
    monkeypatch.setattr(loop, "load_optimizer_state", lambda opt, state: None)
    r = tiny.run(c)
    assert not r["correct"] and r["checks"]["step_count_gap"]["value"] >= 17
    assert r["checks"]["loss_gap"]["value"] <= r["checks"]["loss_gap"]["limit"]


def test_parameters_unchanged_in_the_window_is_not_correct(monkeypatch, tmp_path):
    """Set-up's epoch trains; every call of the window, which resumes the
    optimizer's state, leaves the parameters as they were."""
    from dsen2_tpu_torch.train import loop

    c = tiny.cell("dsen2.train", monkeypatch, tmp_path)
    orig, resumed = loop.load_optimizer_state, []

    def resume_frozen(opt, state):
        orig(opt, state)
        resumed.append(opt)
        for g in opt.param_groups:
            g["lr"] = 0.0

    monkeypatch.setattr(loop, "load_optimizer_state", resume_frozen)
    r = tiny.run(c)
    assert resumed
    assert not r["correct"] and r["checks"]["unmoved_leaves"]["value"] >= 1
    assert r["checks"]["change_gap"]["value"] <= r["checks"]["change_gap"]["limit"]


def test_half_batch_is_not_correct(monkeypatch, tmp_path):
    """Half of each batch left out, the mean taken over the rest."""
    from dsen2_tpu_torch.train import staged

    c = tiny.cell("dsen2.train", monkeypatch, tmp_path)
    orig = staged.masked_mean

    def half(per_mae, per_mse, mask):
        keep = torch.zeros_like(mask)
        keep[: mask.shape[0] // 2] = 1
        return orig(per_mae, per_mse, mask * keep)

    monkeypatch.setattr(staged, "masked_mean", half)
    assert not tiny.run(c)["correct"]


def test_traced_run_reports_no_device_numbers_on_the_cpu(monkeypatch, tmp_path, capsys):
    """The profiler records the second half of the window only."""
    r = tiny.run(tiny.cell("dsen2.tile", monkeypatch, tmp_path), trace=True, seconds=2.0)
    assert r["correct"] and "breakdown" in r
    assert "traced)" in capsys.readouterr().err
    assert "mfu.tile" not in r["metrics"] and "b1_roofline.tile" not in r["metrics"]


def test_run_without_a_card_fails_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    p = subprocess.run([sys.executable, os.path.join(harness.ROOT, "perfbench", "run.py"),
                        "--workload", "dsen2.tile", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, cwd=harness.ROOT,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, os.path.join(harness.ROOT, "perfbench", "run.py"),
                        "--workload", "dsen2.train", "--seed", "5", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, cwd=harness.ROOT,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert np.isfinite(r["metrics"]["train_patches_per_s"]["value"])
