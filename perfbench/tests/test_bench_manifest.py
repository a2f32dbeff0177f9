"""BENCHMARK.json against the benchmark's contract: its keys, names and
units, and every cell's files found by name."""

import json
import os
import re

import pytest

from perfbench import generators, harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def one_line(s, limit=200):
    return isinstance(s, str) and 1 <= len(s) <= limit and "\n" not in s and "\t" not in s


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "perfbench/run.py"]
    assert manifest["paths"] == ["perfbench"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_run_seconds_fit_a_full_check(manifest):
    s = manifest["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units(manifest):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in manifest[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
    assert len(set(names)) == len(names)
    metrics = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_entry_keys(manifest):
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and one_line(w["why"]) and NAME.match(w["traffic"])
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert one_line(m["layer"])


def test_every_cell_resolves(manifest):
    configs = {c["name"]: c for c in manifest["configs"]}
    used = set()
    for w in manifest["workloads"]:
        cell = harness.load_cell(w["name"], manifest=manifest)
        used.add(w["config"])
        assert configs[w["config"]]["file"].startswith("perfbench/")
        assert cell.config["name"] == w["config"]
        assert all(k in cell.config for k in configs[w["config"]]["reduced"])
        assert generators.load(cell.traffic["generator"]) is not None
        assert cell.limits, w["name"]
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.load_metric(m["name"]))
    assert used == set(configs)


def test_per_layer_moves_a_metric_its_cells_report(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    layers = {}
    for m in manifest["per_layer"]:
        for w in m.get("workloads", sorted(cells)):
            assert w in cells
            assert m["moves"] in {x["name"] for x in harness.load_cell(w).end_to_end}
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_config_files_hold_their_cuts(manifest):
    tile = harness.load_cell("dsen2.product").traffic
    assert harness.load_cell("dsen2.product").config["product_roi_px"] == tile["roi"]
    roi = harness.load_cell("vdsen2.roi")
    assert roi.config["roi_px"] == roi.traffic["side"]
    train = harness.load_cell("dsen2.train")
    assert train.traffic["crops"] == 8000 * train.config["train_tiles"]
