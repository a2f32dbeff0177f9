"""ROIs through dsen2_20 with RCAN in place of DSen2 (models/rcan.py).

The tile generator's traffic and life cycle (perfbench/generators/tile.py),
with the net an RCAN configuration: a net entry gives RCAN's own option
names (n_resgroups, n_resblocks, n_feats, reduction) and "weights": "seed"
(torch.nn.Conv2d's default initialisation drawn on the device from the
seed, reference.rcan.seeded). Traffic adds "batch", the API's patches per
step. Each request also records "gates": how far the program's counter
rcan.gates (gate launches) moved during it.

The program's RCAN module is imported when the generator is made, so a
checkout without it fails at once.
"""

from __future__ import annotations

import time

import torch

from perfbench import counts_rcan, frozen
from perfbench.generators import seed_int, tile
from perfbench.reference import compare
from perfbench.reference import rcan as refrcan


class Generator(tile.Generator):
    def __init__(self, config: dict, traffic: dict, seed: int, device, tracer, precision=None):
        from dsen2_tpu_torch.models import rcan  # the program's RCAN
        from dsen2_tpu_torch.utils import profiling

        super().__init__(config, traffic, seed, device, tracer, precision=precision)
        if self.heads != ["2x"]:
            raise ValueError(f"RCAN runs the 2x head only, got {self.heads}")
        net = self.nets["2x"]
        self.model = rcan.RCANConfig(in_channels=tuple(net["in_channels"]),
                                     groups=net["n_resgroups"], blocks=net["n_resblocks"],
                                     features=net["n_feats"], reduction=net["reduction"])
        self.gate_count = lambda: profiling.counters().get("rcan.gates", 0)

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
        self.weights = {"2x": refrcan.seeded(gen, self.nets["2x"], self.device)}
        t2 = time.perf_counter()
        rows = min(self.side, tr["warmup_rows"]["2x"])
        self._call("2x", [r[: rows * r.shape[0] // self.side] for r in self.tiles[0]])
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.setup_parts = {"inputs": round(t1 - t0, 2), "weights": round(t2 - t1, 2),
                            "warm-up": round(time.perf_counter() - t2, 2)}

    def request(self, i: int) -> dict:
        before = self.gate_count()
        rec = super().request(i)
        rec["gates"] = self.gate_count() - before
        return rec

    def check(self) -> dict:
        """mosaic_gap, as the tile generator's, against RCAN's reference."""
        got, want = [], []
        refs = {}
        for t, head, ids, blocks in self.kept:
            if blocks is None:
                return {"mosaic_gap": float("inf")}
            if t not in refs:
                refs[t] = refrcan.RCANTileReference(self.tiles[t][:2], self.nets[head],
                                                    self.weights[head], self.device)
            got += blocks
            want += refs[t].blocks(ids)
        return {"mosaic_gap": compare.block_gap(got, want)}

    def counts(self, records) -> dict:
        net, n = self.nets["2x"], len(records)
        flops, nbytes = counts_rcan.body_conv_work(self.side, self.side, net, self.precision,
                                                   self.traffic["batch"])
        return {"model_flops": n * counts_rcan.tile_model_flops(self.side, self.side, net),
                "rcan_conv_flops": n * flops, "rcan_conv_bytes": n * nbytes,
                "gate_bytes": n * counts_rcan.gate_bytes(self.side, self.side, net),
                "gates": sum(r.get("gates", 0) for r in records)}
