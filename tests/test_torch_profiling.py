"""The port's recorder (utils/profiling.py) on the CPU: spans off and on,
parent and request ids across the banded engine's and fit's threads, the
profiler's clock, device time by span, and the counters the layers keep."""

import contextvars
import functools
import json
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dsen2_tpu_torch.core.config import InferConfig, ModelConfig, TrainConfig
from dsen2_tpu_torch.infer import api, engine
from dsen2_tpu_torch.models import s2net
from dsen2_tpu_torch.train.loop import fit
from dsen2_tpu_torch.utils import profiling
from dsen2_tpu_torch.utils.profiling import (
    count, counters, device_s_by_span, now, record, span, spans_on, take_spans, trace, traced,
)

CFG = ModelConfig(in_channels=(4, 6), num_layers=2, feature_size=16)
ICFG = InferConfig(patch_size=32, border=4, batch_size=4, precision="highest")


@pytest.fixture(autouse=True)
def _no_leftover_spans():
    take_spans()
    yield
    take_spans()


def _scene(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.random((h, w, 4)) * 8000).astype(np.float32),
            (rng.random((h // 2, w // 2, 6)) * 8000).astype(np.float32))


def _params(seed=0):
    return s2net.init_params(torch.Generator().manual_seed(seed), CFG)


def _sr20(d10, d20):
    """dsen2_20's path (api._run) at the tiny width."""
    return api._run([d10, d20], 2, CFG, _params(), ICFG, device="cpu")


def _no_record_function(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)


def test_spans_off_record_nothing(monkeypatch):
    _no_record_function(monkeypatch)
    assert span("a") is span("b", k=1)  # one shared null context
    with span("a"):
        record("b", now())
    assert now() is None
    with pytest.raises(KeyError):  # the null context lets exceptions pass
        with span("a"):
            raise KeyError("x")
    d10, d20 = _scene(64, 64)
    _sr20(d10, d20)
    assert take_spans() == []


def test_spans_nest_and_share_their_request():
    @traced("outer")
    def work():
        with span("inner", k=3):
            mark = now()
            record("interval", mark, n=2)
        ctx = contextvars.copy_context()
        t = threading.Thread(target=ctx.run, args=(functools.partial(_in_span, "worker"),))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()

    with spans_on():
        work()
        with span("second"):
            pass
    with span("off again"):
        pass
    got = {s.name: s for s in take_spans()}
    assert set(got) == {"outer", "inner", "interval", "worker", "second"}
    outer = got["outer"]
    assert outer.parent_id is None and outer.request_id == outer.span_id
    assert got["inner"].parent_id == outer.span_id and got["inner"].attrs == {"k": 3}
    assert got["interval"].parent_id == got["inner"].span_id and got["interval"].attrs == {"n": 2}
    assert got["worker"].parent_id == outer.span_id
    assert got["worker"].native_thread_id != outer.native_thread_id
    for name in ("inner", "interval", "worker"):
        s = got[name]
        assert s.request_id == outer.span_id
        assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
    assert got["second"].request_id == got["second"].span_id != outer.span_id


def _in_span(name):
    with span(name):
        pass


def test_engine_spans_follow_its_threads(monkeypatch):
    """sr_banded through dsen2_20's path at one grid row a band: the stager's and
    the drain thread's spans carry their api.run's request id and lie
    inside it; the counters count the grid's patches, the bands and the
    bytes moved."""
    monkeypatch.setattr(api, "_BANDED_THRESHOLD_PX", 1)
    monkeypatch.setattr(engine, "sr_banded", functools.partial(engine.sr_banded, rows_per_band=1))
    d10, d20 = _scene(96, 80)
    grids = api.build_grids([d10.shape, d20.shape], 2, ICFG)
    nbands = len(engine.plan_bands(len(grids[0].starts_i), 1))
    assert nbands > 2
    before = counters()
    with spans_on():
        out = _sr20(d10, d20)
    after = counters()
    spans = take_spans()
    assert out.shape == (96, 80, 6)
    runs = [s for s in spans if s.name == "api.run"]
    assert len(runs) == 1 and runs[0].attrs == {"route": "banded", "px": 96 * 80}
    run = runs[0]
    main = run.native_thread_id
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
        assert s.request_id == run.span_id
        assert run.start_ns <= s.start_ns <= s.end_ns <= run.end_ns
    for name in ("engine.stage", "engine.drain", "engine.band"):
        assert len(by[name]) == nbands, name
    assert all(s.native_thread_id != main for s in by["engine.stage"] + by["engine.drain"])
    assert all(s.native_thread_id == main for s in by["engine.band"] + by["engine.wait_drain"])
    assert sorted(s.attrs["k"] for s in by["engine.band"]) == list(range(nbands))
    for name in ("engine.fill", "engine.tail", "api.prepare"):
        assert len(by[name]) == 1, name
    fill, tail = by["engine.fill"][0], by["engine.tail"][0]
    band0 = next(s for s in by["engine.band"] if s.attrs["k"] == 0)
    assert fill.start_ns <= by["api.prepare"][0].start_ns and band0.end_ns <= fill.end_ns
    assert tail.start_ns >= max(s.end_ns for s in by["engine.band"])
    assert len(by["conv.class"]) >= 2 * nbands  # head and tail convs, per chunk
    ids = {s.span_id for s in spans}
    assert all(s.parent_id in ids for s in spans if s is not run)

    assert after["infer.patches"] - before.get("infer.patches", 0) == grids[0].num_patches
    assert after["engine.bands"] - before.get("engine.bands", 0) == nbands
    assert after["engine.d2h_bytes"] - before.get("engine.d2h_bytes", 0) == out.nbytes
    assert after["engine.h2d_bytes"] > before.get("engine.h2d_bytes", 0)


def test_one_shot_route_counts_patches():
    d10, d20 = _scene(64, 48)
    grids = api.build_grids([d10.shape, d20.shape], 2, ICFG)
    before = counters().get("infer.patches", 0)
    with spans_on():
        _sr20(d10, d20)
    names = [s.name for s in take_spans()]
    assert counters()["infer.patches"] - before == grids[0].num_patches
    assert names.count("api.run") == names.count("api.prepare") == 1
    assert "engine.band" not in names


def test_spans_share_the_profilers_clock(tmp_path):
    """A record_function region inside a program span, under a CPU
    torch.profiler window: kineto's times lie within the span's, and the
    exported trace puts both on the span's thread."""
    from torch.profiler import ProfilerActivity, profile

    with spans_on(), profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer"):
            with torch.profiler.record_function("inner"):
                torch.ones((64, 64)) @ torch.ones((64, 64))
    (outer,) = take_spans()
    inner = [e for e in prof.profiler.kineto_results.events() if e.name() == "inner"]
    assert len(inner) == 1
    assert outer.start_ns <= inner[0].start_ns() <= inner[0].end_ns() <= outer.end_ns

    with trace(str(tmp_path)) as got:
        with span("outer"):
            with torch.profiler.record_function("inner"):
                torch.ones((64, 64)) @ torch.ones((64, 64))
    assert [s.name for s in got["spans"]] == ["outer"]
    assert take_spans() == []  # trace's spans leave with its result
    with open(got["path"]) as fh:
        events = json.load(fh)["traceEvents"]
    (o,) = [e for e in events if e.get("cat") == "program_span"]
    (i,) = [e for e in events if e.get("name") == "inner"]
    assert o["name"] == "outer" and o["tid"] == i["tid"] == got["spans"][0].native_thread_id
    assert o["ts"] <= i["ts"] <= i["ts"] + i["dur"] <= o["ts"] + o["dur"] + 1e-3
    assert o["args"]["request_id"] == got["spans"][0].span_id


class _Event(SimpleNamespace):
    """A stand-in for a kineto event."""

    def device_type(self):
        return SimpleNamespace(name=self.dev)

    def name(self):
        return self.label

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return 0

    def device_resource_id(self):
        return self.res

    def start_ns(self):
        return self.a

    def end_ns(self):
        return self.b


def test_device_time_goes_to_the_innermost_span_of_the_launching_thread():
    main, worker = 0x7F00_1234_5678, 0x7F00_9ABC_DEF0  # pthread ids
    res = {t: profiling._cupti_thread(t) for t in (main, worker)}
    assert res[worker] < 0  # CUPTI's id is the low 32 bits, signed

    def sp(a, b, name, thread):
        return profiling.Span(a, b, name, 0, None, 0, 1, thread, {})

    spans = [sp(0, 100, "step", main), sp(10, 40, "conv", main), sp(50, 60, "opt", main),
             sp(0, 100, "stage", worker)]

    def launch(corr, t, thread, label="cudaLaunchKernel"):
        return _Event(dev="CPU", label=label, corr=corr, res=res[thread], a=t, b=t + 1)

    def kernel(corr, a, b, label="k"):
        return _Event(dev="CUDA", label=label, corr=corr, res=7, a=a, b=b)

    events = [
        launch(1, 20, main), kernel(1, 1000, 3000),   # inside conv
        launch(7, 25, main), kernel(7, 3000, 3100, "add"),  # inside conv, another op
        launch(2, 45, main), kernel(2, 3000, 4000),   # back in step
        launch(3, 55, main), kernel(3, 4000, 4500),   # inside opt
        launch(4, 30, worker, "cudaMemcpyAsync"), kernel(4, 5000, 7000),  # the worker's span
        launch(5, 200, main), kernel(5, 8000, 9000),  # after every span
        _Event(dev="CPU", label="Lazy Function Loading", corr=1, res=0, a=21, b=22),
        kernel(6, 9000, 9500),                        # no runtime call seen
    ]
    got = device_s_by_span(events, spans)
    assert set(got) == {"conv", "step", "opt", "stage", "(no span)"}
    assert got["conv"]["add"] == pytest.approx(0.1e-6)
    assert {k: v["k"] for k, v in got.items()} == pytest.approx(
        {"conv": 2e-6, "step": 1e-6, "opt": 0.5e-6, "stage": 2e-6, "(no span)": 1.5e-6})


def _train_data(n_train, n_val=16, seed=0):
    rng = np.random.default_rng(seed)
    n = n_train + n_val
    x10 = rng.random((n, 32, 32, 4), dtype=np.float32)
    x20 = rng.random((n, 32, 32, 6), dtype=np.float32)
    lb = (x20 * 1.5 + 0.1 * x10[..., :1]).astype(np.float32)
    k = n_train
    return (x10[:k], x20[:k]), lb[:k], (x10[k:], x20[k:]), lb[k:]


@pytest.mark.parametrize("stage_data", [True, False])
def test_fit_spans_and_step_counts(stage_data):
    """train.steps counts ceil(n_train / batch) a call's epoch, staged and
    host-fed; every span of a call carries the fit span's request id, the
    backward's conv.class spans too; the host-fed path waits in
    fit.wait_batch and produces in fit.produce."""
    n_train, batch, epochs = 40, 16, 2
    before = counters()
    with spans_on():
        fit(CFG, TrainConfig(batch_size=batch), *_train_data(n_train), params=_params(),
            epochs=epochs, precision="high", stage_data=stage_data, verbose=False, device="cpu")
    after = counters()
    spans = take_spans()
    steps = -(-n_train // batch) * epochs
    assert after["train.steps"] - before.get("train.steps", 0) == steps
    assert after["train.samples"] - before.get("train.samples", 0) == n_train * epochs
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    (root,) = by["fit"]
    assert all(s.request_id == root.span_id for s in spans)
    assert len(by["train.step"]) == len(by["train.optimizer"]) == steps
    assert len(by["fit.epoch"]) == len(by["fit.train"]) == len(by["fit.validate"]) == epochs
    assert len(by["fit.readback"]) == len(by["fit.epoch_end"]) == epochs
    (setup,) = by["fit.setup"]
    assert setup.parent_id == root.span_id
    assert setup.end_ns <= min(s.start_ns for s in by["fit.epoch"])
    # 4 convs a step forward, 4 backward (the head's input needs no dx).
    assert len(by["conv.class"]) >= 8 * steps
    if stage_data:
        (stage,) = by["fit.stage"]
        assert setup.start_ns <= stage.start_ns <= stage.end_ns <= setup.end_ns
        assert "fit.wait_batch" not in by
    else:
        assert "fit.stage" not in by
        assert len(by["fit.wait_batch"]) >= steps
        producers = {s.native_thread_id for s in by["fit.produce"]}
        assert producers and root.native_thread_id not in producers


def test_counters_add_and_copy():
    before = counters().get("test.counter", 0)
    count("test.counter")
    count("test.counter", 2.5)
    got = counters()
    assert got["test.counter"] - before == 3.5
    got["test.counter"] = -1  # a copy: the registry is untouched
    assert counters()["test.counter"] - before == 3.5


def test_cli_phases_are_spans_of_one_request(tmp_path, monkeypatch):
    """s2_supres.main on a synthetic JP2 product (tiny nets): its read, the
    two nets, the assembly and the write are spans of one request, in that
    order, and each net's api.run lies inside its s2_supres.sr."""
    from dsen2_tpu_torch.cli import s2_supres
    from dsen2_tpu_torch.data import safe_pil

    from safe_product import build_safe

    if not safe_pil.available():
        pytest.skip("Pillow lacks JPEG-2000")
    mtd, _ = build_safe(tmp_path, np.random.default_rng(850), h10=360)
    cfg6 = ModelConfig(in_channels=(4, 6, 2), num_layers=2, feature_size=16)
    monkeypatch.setattr(api, "dsen2_2x", lambda deep=False: CFG)
    monkeypatch.setattr(api, "dsen2_6x", lambda deep=False: cfg6)
    monkeypatch.setattr(api, "default_params", lambda cfg, run_60, deep: s2net.init_params(
        torch.Generator().manual_seed(1), cfg))
    monkeypatch.chdir(tmp_path)
    with spans_on():
        assert s2_supres.main([mtd, "out.tif", "--roi_x_y", "0,0,239,239", "--run_60",
                               "--output-dtype", "uint16"], device="cpu") == 0
    spans = take_spans()
    (root,) = [s for s in spans if s.parent_id is None]
    assert root.name == "s2_supres.main"
    assert all(s.request_id == root.span_id for s in spans)
    phases = sorted((s for s in spans if s.parent_id == root.span_id), key=lambda s: s.start_ns)
    assert [(s.name, s.attrs.get("net")) for s in phases] == [
        ("s2_supres.read", None), ("s2_supres.sr", "6x"), ("s2_supres.sr", "2x"),
        ("s2_supres.assemble", None), ("s2_supres.write", None)]
    for sr in phases[1:3]:
        (run,) = [s for s in spans if s.name == "api.run" and s.parent_id == sr.span_id]
        assert run.attrs == {"route": "one_shot", "px": 240 * 240}
