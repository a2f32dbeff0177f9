"""Tiles through the inference API: dsen2_20 / dsen2_60, host arrays in and out.

Traffic parameters: side and base (a side x side uint16 tile tiled from a
seeded base x base scene, frozen.tiled_scene), tiles (how many distinct
tiles set-up makes; requests take them in turn), heads (the entry points of
one request, in order: "6x" is dsen2_60, "2x" dsen2_20), deep, precision,
output_dtype ("float32": the check compares float mosaics), warmup_rows
(per head: set-up runs that head once on the first rows of tile 0, so that
the kernels, cuDNN's plans and the banded engine's pinned buffers are ready
before the window), sample_block (the check compares, of each call's
mosaic, the edges, the last patch of every patch row and one patch drawn
from the seed in every run of sample_block patches: reference.patches.
sample_ids).

One request is one tile through every head: its 10 m pixels count once.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from perfbench import counts, frozen
from perfbench.generators import seed_int
from perfbench.reference import compare
from perfbench.reference import net as refnet
from perfbench.reference.patches import TileReference, sample_ids

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def nested(flat: dict) -> dict:
    """{"head.w": a} -> {"head": {"w": a}}, the program's params layout."""
    out: dict = {}
    for k, v in flat.items():
        top, name = k.split(".", 1)
        out.setdefault(top, {})[name] = v
    return out


def make_weights(net: dict, seed: int, salt: int, device):
    """The flat weights of one net: the configuration's .npz, or for
    "seed" he_uniform drawn on the device from the seed."""
    if net["weights"] == "seed":
        gen = torch.Generator(device=device).manual_seed(seed_int(seed, 3, salt))
        return refnet.he_uniform(gen, net, device)
    return refnet.load_npz(os.path.join(ROOT, net["weights"]))


class Generator:
    def __init__(self, config: dict, traffic: dict, seed: int, device, tracer, precision=None):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.tracer = torch.device(device), tracer
        self.precision = precision or traffic.get("precision", config["precision"])
        self.heads = list(traffic["heads"])
        self.nets = {h: config["nets"][h] for h in self.heads}
        self.side = traffic["side"]
        self.kept = []  # (tile, head, patch ids, blocks of the program's mosaic)
        self.tiles = []
        self.weights = {}

    # -- the program ------------------------------------------------------

    def _call(self, head: str, rasters):
        from dsen2_tpu_torch.core.config import InferConfig
        from dsen2_tpu_torch.infer import api

        net = self.nets[head]
        icfg = InferConfig(patch_size=net["patch_size"], border=net["border"],
                           precision=self.precision,
                           output_dtype=self.traffic["output_dtype"])
        params = nested(self.weights[head])
        deep = bool(self.traffic["deep"])
        if head == "2x":
            return api.dsen2_20(rasters[0], rasters[1], deep=deep, params=params,
                                infer_cfg=icfg, device=self.device)
        return api.dsen2_60(rasters[0], rasters[1], rasters[2], deep=deep, params=params,
                            infer_cfg=icfg, device=self.device)

    def setup(self) -> None:
        tr = self.traffic
        t0 = time.perf_counter()
        self.tiles = [frozen.tiled_scene(seed_int(self.seed, 1, t), self.side, tr["base"])
                      for t in range(tr["tiles"])]
        t1 = time.perf_counter()
        self.weights = {h: make_weights(net, self.seed, k, self.device)
                        for k, (h, net) in enumerate(self.nets.items())}
        self.tracer.time_b1()
        t2 = time.perf_counter()
        for head in self.heads:
            rows = min(self.side, tr["warmup_rows"][head])
            strip = [r[: rows * r.shape[0] // self.side] for r in self.tiles[0]]
            self._call(head, strip)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.setup_parts = {"inputs": round(t1 - t0, 2), "weights": round(t2 - t1, 2),
                            "warm-up": round(time.perf_counter() - t2, 2)}

    def request(self, i: int) -> dict:
        t = i % len(self.tiles)
        rec = {"kind": "tile", "calls": [], "harness_s": 0.0}
        rec["start"] = time.perf_counter()
        with self.tracer.span("request"):
            for k, head in enumerate(self.heads):
                c0 = time.perf_counter()
                with self.tracer.span("call." + head):
                    out = self._call(head, self.tiles[t])
                c1 = time.perf_counter()
                rec["calls"].append((head, c0, c1))
                self._keep(i, t, k, head, out)
                rec["harness_s"] += time.perf_counter() - c1
        rec["end"] = time.perf_counter()
        rec["mpx"] = self.side * self.side / 1e6
        return rec

    def _keep(self, i: int, t: int, k: int, head: str, out) -> None:
        """Copy out the owned blocks of the sampled patches of this call."""
        n_in = len(self.nets[head]["in_channels"])
        geo = TileReference([r[:, :, :0] for r in self.tiles[t][:n_in]], self.nets[head], None,
                            "cpu")
        ids = sample_ids(geo.rows, geo.cols, self.traffic["sample_block"],
                         np.random.default_rng(seed_int(self.seed, 2, i, k)))
        want_shape = (self.side, self.side, self.nets[head]["in_channels"][-1])
        blocks = None
        if (isinstance(out, np.ndarray) and out.shape == want_shape
                and out.dtype == np.float32):
            blocks = [out[y0:y1, x0:x1].copy()
                      for y0, y1, x0, x1 in (geo.owned(a, b) for a, b in ids)]
        self.kept.append((t, head, ids, blocks))

    def free(self) -> None:
        self.tracer.close()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # -- the yardstick ----------------------------------------------------

    def check(self) -> dict:
        """mosaic_gap: the largest |program - reference| over the sampled
        patches' owned blocks of every call in the window, as a share of the
        largest reference DN there."""
        got, want = [], []
        refs = {}
        for t, head, ids, blocks in self.kept:
            if blocks is None:
                return {"mosaic_gap": float("inf")}
            n_in = len(self.nets[head]["in_channels"])
            key = (t, head)
            if key not in refs:
                refs[key] = TileReference(self.tiles[t][:n_in], self.nets[head],
                                          self.weights[head], self.device)
            got += blocks
            want += refs[key].blocks(ids)
        return {"mosaic_gap": compare.block_gap(got, want)}

    def counts(self, records) -> dict:
        flops = b1_flops = b1_bytes = 0
        for _ in records:
            for head in self.heads:
                net = self.nets[head]
                flops += counts.tile_model_flops(self.side, self.side, net)
                f, b = counts.b1_work(self.side, self.side, net, self.precision)
                b1_flops, b1_bytes = b1_flops + f, b1_bytes + b
        return {"model_flops": flops, "b1_flops": b1_flops, "b1_bytes": b1_bytes}

