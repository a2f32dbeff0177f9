"""The dsen2.train.stream traffic (perfbench/traffic/train_stream.json,
generator train_stream, limits/dsen2.train.stream.json; not yet a cell of
BENCHMARK.json) on the CPU at a tiny size: fit fed from the host reads its
first steps' losses from the train step, comes out correct, and the control
and planted faults do not."""

import os

from perfbench import harness
from perfbench.tests import tiny


def stream_cell(monkeypatch, tmp_path) -> harness.Cell:
    """dsen2.train's tiny cell with the stream traffic and its limits."""
    c = tiny.cell("dsen2.train", monkeypatch, tmp_path)
    here = os.path.join(harness.ROOT, "perfbench")
    traffic = harness.load_json(os.path.join(here, "traffic", "train_stream.json"))
    traffic.update(crops=c.traffic["crops"], batch=c.traffic["batch"])
    limits = harness.load_json(os.path.join(here, "limits", "dsen2.train.stream.json"))["limits"]
    return harness.Cell("dsen2.train.stream", c.chips, c.config, traffic, limits, c.end_to_end,
                        c.per_layer)


def test_sound_run_is_correct_on_the_host_route(monkeypatch, tmp_path):
    from dsen2_tpu_torch.train import staged

    c = stream_cell(monkeypatch, tmp_path)
    assert c.traffic["stage_data"] is False
    calls = []
    orig = staged.masked_mean
    monkeypatch.setattr(staged, "masked_mean", lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    r = tiny.run(c)
    assert r["correct"], r["checks"]
    assert not calls  # the host route: no staged epoch ran
    assert set(r["metrics"]) == {"train_patches_per_s", "setup_s"}
    assert r["checks"]["loss_gap"]["value"] <= r["checks"]["loss_gap"]["limit"]


def test_control_is_not_correct(monkeypatch, tmp_path):
    """The program's own one-pass path ("default") in place of "high"."""
    r = tiny.run(stream_cell(monkeypatch, tmp_path), precision="default")
    assert not r["correct"], r["checks"]


def test_state_dropped_on_resume_is_not_correct(monkeypatch, tmp_path):
    """The window's calls resume the parameters but drop the optimizer's
    state: its step count starts again at every call."""
    from dsen2_tpu_torch.train import loop

    c = stream_cell(monkeypatch, tmp_path)
    monkeypatch.setattr(loop, "load_optimizer_state", lambda opt, state: None)
    r = tiny.run(c)
    assert not r["correct"] and r["checks"]["step_count_gap"]["value"] >= 17


def test_half_batch_is_not_correct(monkeypatch, tmp_path):
    """The reference fed half of each batch (perfbench/calibrate.py's
    fault), against the program's full batches."""
    from perfbench import generators
    from perfbench.trace import Tracer

    c = stream_cell(monkeypatch, tmp_path)
    d = generators.load(c.traffic["generator"])(c.config, c.traffic, 2**31 + 11, "cpu",
                                                Tracer(False))
    d.setup()
    d.request(0)
    d.free()
    full, half = d.check(), d.check(keep=0.5)
    assert all(full[k] <= c.limits[k] for k in full)
    assert any(half[k] > c.limits[k] for k in ("loss_gap", "grad_gap", "change_gap"))
