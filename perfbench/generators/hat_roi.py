"""ROIs through dsen2_20 with HAT in place of DSen2 (models/hat.py).

The tile generator's traffic and life cycle (perfbench/generators/tile.py),
with the net a HAT configuration: a net entry gives HAT's own option names
(embed_dim, depths, num_heads, window_size, overlap_ratio, mlp_ratio,
compress_ratio, squeeze_factor, conv_scale) and "weights": "seed" (drawn on
the device from the seed, reference.hat.seeded). Traffic adds "batch", the
API's patches per step. Each request also records "attn": how far the
program's counter hat.attn (window-attention launches) moved during it.

The program's HAT module is imported when the generator is made, so a
checkout without it fails at once.
"""

from __future__ import annotations

import time

import torch

from perfbench import counts_hat, frozen
from perfbench.generators import seed_int, tile
from perfbench.reference import compare
from perfbench.reference import hat as refhat


class Generator(tile.Generator):
    def __init__(self, config: dict, traffic: dict, seed: int, device, tracer, precision=None):
        from dsen2_tpu_torch.models import hat  # the program's HAT
        from dsen2_tpu_torch.utils import profiling

        super().__init__(config, traffic, seed, device, tracer, precision=precision)
        if self.heads != ["2x"]:
            raise ValueError(f"HAT runs the 2x head only, got {self.heads}")
        net = self.nets["2x"]
        if len(set(net["depths"])) != 1 or len(set(net["num_heads"])) != 1:
            raise ValueError("the port's HAT takes equal depths and heads in every group")
        self.model = hat.HATConfig(
            in_channels=tuple(net["in_channels"]), embed_dim=net["embed_dim"],
            groups=len(net["depths"]), blocks=net["depths"][0], heads=net["num_heads"][0],
            window=net["window_size"], overlap_ratio=net["overlap_ratio"],
            mlp_ratio=net["mlp_ratio"], compress_ratio=net["compress_ratio"],
            squeeze_factor=net["squeeze_factor"], conv_scale=net["conv_scale"])
        self.attn_count = lambda: profiling.counters().get("hat.attn", 0)

    def _call(self, head: str, rasters):
        from dsen2_tpu_torch.core.config import InferConfig
        from dsen2_tpu_torch.infer import api

        net = self.nets[head]
        icfg = InferConfig(patch_size=net["patch_size"], border=net["border"],
                           batch_size=self.traffic["batch"], precision=self.precision,
                           output_dtype=self.traffic["output_dtype"])
        return api.dsen2_20(rasters[0], rasters[1], params=tile.nested(self.weights[head]),
                            infer_cfg=icfg, device=self.device, model=self.model)

    def setup(self) -> None:
        tr = self.traffic
        t0 = time.perf_counter()
        self.tiles = [frozen.tiled_scene(seed_int(self.seed, 1, t), self.side, tr["base"])
                      for t in range(tr["tiles"])]
        t1 = time.perf_counter()
        gen = torch.Generator(device=self.device).manual_seed(seed_int(self.seed, 3, 0))
        self.weights = {"2x": refhat.seeded(gen, self.nets["2x"], self.device)}
        t2 = time.perf_counter()
        rows = min(self.side, tr["warmup_rows"]["2x"])
        self._call("2x", [r[: rows * r.shape[0] // self.side] for r in self.tiles[0]])
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.setup_parts = {"inputs": round(t1 - t0, 2), "weights": round(t2 - t1, 2),
                            "warm-up": round(time.perf_counter() - t2, 2)}

    def request(self, i: int) -> dict:
        before = self.attn_count()
        rec = super().request(i)
        rec["attn"] = self.attn_count() - before
        return rec

    def check(self) -> dict:
        """mosaic_gap, as the tile generator's, against HAT's reference."""
        got, want = [], []
        refs = {}
        for t, head, ids, blocks in self.kept:
            if blocks is None:
                return {"mosaic_gap": float("inf")}
            if t not in refs:
                refs[t] = refhat.HATTileReference(self.tiles[t][:2], self.nets[head],
                                                  self.weights[head], self.device)
            got += blocks
            want += refs[t].blocks(ids)
        return {"mosaic_gap": compare.block_gap(got, want)}

    def counts(self, records) -> dict:
        net, n = self.nets["2x"], len(records)
        flops, nbytes = counts_hat.attention_work(self.side, self.side, net, self.precision)
        return {"model_flops": n * counts_hat.tile_model_flops(self.side, self.side, net),
                "wattn_flops": n * flops, "wattn_bytes": n * nbytes,
                "attn": sum(r.get("attn", 0) for r in records)}
