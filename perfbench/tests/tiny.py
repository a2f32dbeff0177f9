"""Tiny versions of the benchmark's cells for the CPU tests: the cell's own
traffic and limits, with nets of 1 block x 16 features and small scenes, and
the program's net presets patched to match."""

from __future__ import annotations

import copy
import os

import numpy as np

from perfbench import harness
from perfbench.generators.tile import make_weights

LAYERS, FEATURES = 1, 16


def patch_presets(monkeypatch) -> None:
    """Make the program's dsen2_2x / dsen2_6x presets the tiny nets."""
    from dsen2_tpu_torch.core.config import ModelConfig
    from dsen2_tpu_torch.infer import api

    monkeypatch.setattr(api, "dsen2_2x", lambda deep=False: ModelConfig(
        in_channels=(4, 6), num_layers=LAYERS, feature_size=FEATURES))
    monkeypatch.setattr(api, "dsen2_6x", lambda deep=False: ModelConfig(
        in_channels=(4, 6, 2), num_layers=LAYERS, feature_size=FEATURES))


def cell(name: str, monkeypatch, tmp_path) -> harness.Cell:
    """BENCHMARK.json's cell `name`, cut to a size the CPU runs in seconds."""
    c = harness.load_cell(name)
    cfg = copy.deepcopy(c.config)
    for net in cfg["nets"].values():
        net.update(num_layers=LAYERS, feature_size=FEATURES, weights="seed")
    t = copy.deepcopy(c.traffic)
    if t["generator"] == "tile":
        t.update(side=240, base=120, warmup_rows={h: 240 for h in t["heads"]}, sample_block=4)
    elif t["generator"] == "product":
        t.update(side=480, base=240, roi=240, warmup_roi=[240, 240], sample_block=4)
        # The CLI loads its default weights: give it the tiny ones.
        monkeypatch.setenv("DSEN2_TPU_WEIGHTS_DIR", str(tmp_path))
        for k, (h, fname) in enumerate((("2x", "s2_032_lr_1e-04.npz"),
                                        ("6x", "s2_030_lr_1e-05.npz"))):
            w = make_weights(cfg["nets"][h], 5, k, "cpu")
            path = os.path.join(tmp_path, fname)
            np.savez(path, **{a: np.asarray(b) for a, b in w.items()})
            cfg["nets"][h]["weights"] = path
    elif t["generator"] == "train":
        t.update(crops=600, batch=32)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    patch_presets(monkeypatch)
    return harness.Cell(c.name, c.chips, cfg, t, c.limits, c.end_to_end, c.per_layer)


def run(c: harness.Cell, seed: int = 2**31 + 11, **kw) -> dict:
    import tempfile

    tempfile.tempdir = None  # honour the TMPDIR the test set
    return harness.run_cell(c, seed, kw.pop("seconds", 0.2), trace=kw.pop("trace", False),
                            device="cpu", **kw)
