"""A SAFE product through the production CLI: s2_supres.main, GeoTIFF out.

Traffic parameters: side and base (one seeded side x side L1C product,
frozen.product_rasters, served in memory through safe_reader's GDAL seam by
frozen.gdal_product), roi (each request takes the next roi x roi square of
the product, row-major, as --roi_x_y), argv (the CLI's other flags),
warmup_roi ([width, height] of the ROI set-up runs once), sample_block
(which patches of each net the check compares: reference.patches.
sample_ids).

Each request writes its GeoTIFF under TMPDIR. Once the request has
returned, the file's metadata and the sampled patches' blocks are read
back (the file is mapped, so only those pages are touched) and the file is
deleted, so that a run keeps at most one GeoTIFF on disk; the blocks are
compared with the reference once the window has closed. The host clock
times the CLI's read_safe, dsen2_60, dsen2_20 and write_bands calls,
wrapped from here as chip_smoke.timed_calls does.
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import time

import numpy as np
import torch

from perfbench import frozen
from perfbench.generators import seed_int
from perfbench.generators.tile import make_weights
from perfbench.reference import compare
from perfbench.reference.patches import TileReference, sample_ids
from perfbench.tiff_reader import read_tiff

# The SR bands s2_supres writes, by head, in its order (20 m bands, then 60 m).
HEAD_BANDS = {"2x": ("B5", "B6", "B7", "B8A", "B11", "B12"), "6x": ("B1", "B9")}


def _desc(band: str) -> str:
    """The description s2_supres gives an SR band in the GeoTIFF."""
    return f"SR{band} ({frozen.WAVELENGTH_NM[band]} nm)"


class Generator:
    def __init__(self, config: dict, traffic: dict, seed: int, device, tracer, precision=None):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.tracer = torch.device(device), tracer
        self.precision = precision or traffic.get("precision", config["precision"])
        self.nets = config["nets"]
        self.side, self.roi = traffic["side"], traffic["roi"]
        self.per_row = self.side // self.roi
        self.kept = []  # (request, x0, y0, metadata as written, {head: (ids, blocks)})
        self.tmp = tempfile.gettempdir()

    def _argv(self, path: str, x0: int, y0: int, w: int, h: int):
        return [self.name, path, *self.traffic["argv"],
                "--roi_x_y", f"{x0},{y0},{x0 + w - 1},{y0 + h - 1}"]

    def _cli(self, argv, parts=None):
        """s2_supres.main(argv) with its printing sent to standard error;
        `parts` collects the wall seconds of its inner calls."""
        from dsen2_tpu_torch.cli import s2_supres
        from dsen2_tpu_torch.core import config as core_config
        from dsen2_tpu_torch.data import safe_reader
        from dsen2_tpu_torch.infer import api
        from dsen2_tpu_torch.io import writers

        targets = ((safe_reader, "read_safe"), (api, "dsen2_60"), (api, "dsen2_20"),
                   (writers, "write_bands"))
        with contextlib.ExitStack() as stack:
            stack.enter_context(frozen.installed_gdal(self.gdal))
            stack.enter_context(contextlib.redirect_stdout(sys.stderr))
            times = stack.enter_context(frozen.timed_calls(*targets))
            stack.enter_context(self.tracer.spans_around(*targets))
            if self.precision != "high":
                stack.enter_context(_infer_precision(core_config, self.precision))
            with self.tracer.span("cli"):
                # On the card the CLI picks its device as a user's run does.
                dev = None if self.device.type == "cuda" else str(self.device)
                rc = s2_supres.main(argv, device=dev)
        if rc != 0:
            raise RuntimeError(f"s2_supres returned {rc}")
        if parts is not None:
            parts.update({k: sum(v) for k, v in times.items()})

    def setup(self) -> None:
        t0 = time.perf_counter()
        self.rasters = frozen.product_rasters(seed_int(self.seed, 1, 0), self.side,
                                              self.traffic["base"])
        t1 = time.perf_counter()
        self.gdal, self.name = frozen.gdal_product(*self.rasters)
        self.weights = {h: make_weights(net, self.seed, k, "cpu")
                        for k, (h, net) in enumerate(self.nets.items())}
        w, h = self.traffic["warmup_roi"]
        path = os.path.join(self.tmp, "perfbench_product_warmup.tif")
        self._cli(self._argv(path, 0, 0, w, h))
        os.unlink(path)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.setup_parts = {"inputs": round(t1 - t0, 2),
                            "weights and warm-up": round(time.perf_counter() - t1, 2)}

    def request(self, i: int) -> dict:
        q = i % (self.per_row * self.per_row)
        x0, y0 = (q % self.per_row) * self.roi, (q // self.per_row) * self.roi
        path = os.path.join(self.tmp, f"perfbench_product_{i}.tif")
        parts = {}
        rec = {"kind": "product", "start": time.perf_counter()}
        with self.tracer.span("request"):
            self._cli(self._argv(path, x0, y0, self.roi, self.roi), parts)
        rec["end"] = time.perf_counter()
        wall = rec["end"] - rec["start"]
        rec["parts"] = {"read": parts.get("read_safe", 0.0), "write": parts.get("write_bands", 0.0),
                        "sr": parts.get("dsen2_60", 0.0) + parts.get("dsen2_20", 0.0)}
        rec["parts"]["other"] = wall - sum(rec["parts"].values())
        rec["mpx"] = self.roi * self.roi / 1e6
        try:
            self._keep(i, x0, y0, path)
        finally:
            os.unlink(path)
        return rec

    def _keep(self, i: int, x0: int, y0: int, path: str) -> None:
        """Copy out of the written file its metadata and, for each net, the
        SR bands' blocks that the sampled patches own."""
        t = read_tiff(path)
        meta_ok = (t["descriptions"] == [_desc(b) for b in HEAD_BANDS["2x"] + HEAD_BANDS["6x"]]
                   and t["dtype"] == np.uint16 and (t["height"], t["width"]) == (self.roi,
                                                                                 self.roi)
                   and t["geokeys"].get(3072) == frozen.PRODUCT_EPSG
                   and list(t["tiepoint"][3:5]) == [frozen.PRODUCT_ULX + 10 * x0,
                                                    frozen.PRODUCT_ULY - 10 * y0])
        heads = {}
        if meta_ok:
            for k, head in enumerate(("2x", "6x")):
                geo = self._geometry(head)
                ids = sample_ids(geo.rows, geo.cols, self.traffic["sample_block"],
                                 np.random.default_rng(seed_int(self.seed, 2, i, k)))
                planes = [t["bands"][_desc(b)] for b in HEAD_BANDS[head]]
                blocks = []
                for a, b in ids:
                    ya, yb, xa, xb = geo.owned(a, b)
                    blocks.append(np.stack([p[ya:yb, xa:xb] for p in planes], axis=-1))
                heads[head] = (ids, blocks)
        del t
        self.kept.append((i, x0, y0, meta_ok, heads))

    def _geometry(self, head: str) -> TileReference:
        """The patch grid of one net on an ROI (no pixels, no weights)."""
        n_in = len(self.nets[head]["in_channels"])
        shapes = [(self.roi, self.roi), (self.roi // 2,) * 2, (self.roi // 6,) * 2][:n_in]
        return TileReference([np.zeros(sh + (0,), np.uint16) for sh in shapes],
                             self.nets[head], None, "cpu")

    def free(self) -> None:
        self.tracer.close()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """product_gap_dn: the largest |GeoTIFF - round(reference)| in DN
        over the sampled patches' owned blocks of every SR band of every
        request; meta_mismatches: requests whose file lacks the eight SR
        bands as uint16 of the ROI's size, the product's EPSG code or the
        ROI corner's tiepoint."""
        gap, bad = 0.0, 0
        d10, d20, d60 = self.rasters
        r = self.roi
        for i, x0, y0, meta_ok, heads in self.kept:
            if not meta_ok:
                bad += 1
                continue
            win = [d10[y0:y0 + r, x0:x0 + r], d20[y0 // 2:(y0 + r) // 2, x0 // 2:(x0 + r) // 2],
                   d60[y0 // 6:(y0 + r) // 6, x0 // 6:(x0 + r) // 6, :2]]
            for head, (ids, blocks) in heads.items():
                net = self.nets[head]
                ref = TileReference(win[:len(net["in_channels"])], net, self.weights[head],
                                    self.device)
                want = [compare.round_half_even_u16(w) for w in ref.blocks(ids)]
                gap = max(gap, compare.dn_gap(blocks, want))
        if not self.kept:
            gap = float("inf")
        return {"product_gap_dn": gap, "meta_mismatches": float(bad)}

    def counts(self, records) -> dict:
        return {}


@contextlib.contextmanager
def _infer_precision(core_config, precision: str):
    """Make the CLI's InferConfig default to `precision` inside the block
    (the control: the program's own one-pass path)."""
    import dataclasses

    orig = core_config.InferConfig

    def infer_config(*a, **kw):
        return dataclasses.replace(orig(*a, **kw), precision=precision)

    core_config.InferConfig = infer_config
    try:
        yield
    finally:
        core_config.InferConfig = orig
