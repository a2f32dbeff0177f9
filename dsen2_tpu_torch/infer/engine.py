"""Banded full-tile engine: transfers that overlap compute, bounded device memory.

The counterpart of dsen2_tpu/infer/engine.py. The one-shot path
(infer/api.py::_run) keeps the whole output mosaic on the device and reads it
back in one copy at the end. This engine splits the patch grid into
horizontal BANDS of whole grid rows, runs `sr_tile` once per band, and reads
band k back while band k+1 computes. The JAX package gets that overlap from
asynchronous dispatch; here it is built from CUDA streams and events:

- h2d: when the rasters are host arrays, each band's pipeline gets only its
  own input WINDOW (its patch rows and their symmetric halo, in the compact
  staging dtype). A one-worker stager thread fills each window into pinned
  host memory and copies it on a side stream `stage_lookahead` bands ahead,
  recording an event that the compute stream waits on before the band's
  gather.
- d2h: after band k is queued, an event on the compute stream gates its copy
  into pinned host memory on a second side stream. Band k+1 is queued before
  anything waits for that copy; a one-worker drain thread then waits for it
  and moves the rows into the output while the main thread queues on.

The device holds about two bands of output and `stage_lookahead + 2` input
windows, never the whole mosaic. Callers that pass tensors as rasters (the
self-ensemble) keep the whole-raster path: the inputs are on the device
already. Band boundaries need no halo exchange: every patch carries its own
halo, and grid rows write disjoint output rows, except the final edge-flush
row, which is merged into the last band (the reference's last-write-wins).

How a tile is cut into patches, bands and chunks is decided here for every
route (the one-shot path, this engine, the mesh's sharded tile and fleet):
plan_tile lays out the tile once, and TilePlan.band gives each band's
schedule.
"""

from __future__ import annotations

import concurrent.futures
import contextvars
import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from dsen2_tpu_torch.core.config import InferConfig, ModelConfig
from dsen2_tpu_torch.core.device import resolve_device
from dsen2_tpu_torch.infer.api import (
    Device,
    _cast,
    _host_view,
    _output_dtype,
    _validate_inputs,
    build_grids,
    sr_tile,
    stage_raster,
    staging_dtype,
)
from dsen2_tpu_torch.ops.tiling import (
    PatchGrid, pad_symmetric, recompose_positions, symmetric_index,
)
from dsen2_tpu_torch.utils import profiling
from dsen2_tpu_torch.weights import params_to_torch

__all__ = [
    "TilePlan", "plan_tile", "plan_bands", "band_window_rows", "stage_window", "sr_banded",
]


def plan_bands(ny: int, rows_per_band: int):
    """Assign the ny patch-grid rows to bands of rows_per_band rows; the
    final flush row (if any) writes rows that overlap the previous row's
    span, so a lone trailing row always joins the last band."""
    if rows_per_band < 1:
        raise ValueError(f"rows_per_band must be >= 1, got {rows_per_band}")
    band_rows = []
    r0 = 0
    while r0 < ny:
        r1 = min(r0 + rows_per_band, ny)
        if ny - r1 == 1:
            r1 = ny
        band_rows.append((r0, r1))
        r0 = r1
    return band_rows


def band_window_rows(grid: PatchGrid, r0: int, r1: int) -> Tuple[int, int]:
    """Padded-coordinate row span [w0, w1) of the input window that covers
    grid rows r0..r1-1 on this raster: from the first row's patch start to
    the last row's patch end."""
    starts = grid.starts_i
    return starts[r0], starts[r1 - 1] + grid.patch


class Band(NamedTuple):
    """One band's schedule (TilePlan.band): output rows [y0, y0 + band_h);
    per raster, its input window's padded rows [w0, w1) (None when not
    windowed); and the [nb, batch, n_inputs, 2] patch starts and the
    [nb, batch, 2] band-relative output positions, chunk by chunk."""

    y0: int
    band_h: int
    windows: Optional[Tuple[Tuple[int, int], ...]]
    starts: Optional[np.ndarray]
    positions: Optional[np.ndarray]


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How one tile is cut into patches (plan_tile), and each band's
    schedule: every inference route asks this for its chunks."""

    grids: Tuple[PatchGrid, ...]
    out_hw: Tuple[int, int]
    interior: int
    out_dtype: np.dtype
    starts: np.ndarray  # [ny, nx, n_inputs, 2] patch starts, padded-raster coordinates
    positions: np.ndarray  # [ny, nx, 2] where each patch interior lands in the mosaic

    @property
    def ny(self) -> int:
        return self.starts.shape[0]

    @property
    def nx(self) -> int:
        return self.starts.shape[1]

    def band(self, r0: int, r1: int, batch: int, windowed: bool) -> Band:
        """The schedule of grid rows r0..r1-1 in chunks of `batch` patches,
        the last chunk padded by repeating the band's final patch (a
        duplicate write of identical content). Positions are relative to
        the band's first output row y0. windowed: the starts are in each
        raster's window coordinates (band_window_rows), else in the whole
        padded raster's. An empty range (a shard with no grid rows) has
        band_h 0 and no chunks."""
        if r0 == r1:
            return Band(r0 * self.interior, 0, None, None, None)
        y0 = int(self.positions[r0, 0, 0])
        band_h = int(self.positions[r1 - 1, 0, 0]) + self.interior - y0
        starts = self.starts[r0:r1].reshape(-1, len(self.grids), 2)
        positions = self.positions[r0:r1].reshape(-1, 2) - np.asarray([y0, 0], np.int32)
        windows = None
        if windowed:
            windows = tuple(band_window_rows(g, r0, r1) for g in self.grids)
            starts = starts - np.asarray([[w0, 0] for w0, _ in windows], starts.dtype)
        n = positions.shape[0]
        nb = -(-n // batch)
        take = np.minimum(np.arange(nb * batch), n - 1)
        return Band(y0, band_h, windows, starts[take].reshape(nb, batch, len(self.grids), 2),
                    positions[take].reshape(nb, batch, 2))


def plan_tile(
    rasters: Sequence[np.ndarray], lr_factor: int, cfg: ModelConfig, infer_cfg: InferConfig
) -> TilePlan:
    """Check a call's rasters (finest-first HWC arrays or tensors) and
    output dtype, and lay out the tile's patch grid: the one place that
    decides where each patch is read and where its interior lands."""
    out_dtype = _output_dtype(infer_cfg.output_dtype)
    _validate_inputs(rasters, lr_factor, cfg, infer_cfg)
    grids = build_grids([r.shape for r in rasters], lr_factor, infer_cfg)
    starts = [g.flat_starts() for g in grids]
    n = starts[0].shape[0]
    if any(s.shape[0] != n for s in starts):
        raise ValueError("all rasters must share the patch grid")
    out_hw = tuple(int(d) for d in rasters[0].shape[:2])
    interior = infer_cfg.patch_size - 2 * infer_cfg.border
    positions = recompose_positions(out_hw, interior)
    if positions.shape[0] != n:
        raise ValueError(f"mosaic has {positions.shape[0]} positions for {n} patches")
    ny, nx = len(grids[0].starts_i), len(grids[0].starts_j)
    return TilePlan(grids, out_hw, interior, out_dtype,
                    np.stack(starts, axis=1).reshape(ny, nx, len(grids), 2),
                    positions.reshape(ny, nx, 2))


def _fill_window(dst: np.ndarray, raster: np.ndarray, grid: PatchGrid, w0: int, w1: int):
    """Write np.pad(raster, symmetric halo of grid.border)[w0:w1] into dst
    ([w1 - w0, W + 2 * border, C]), copying the raster rows it covers once;
    only the halo rows and columns are gathered by index."""
    b, w = grid.border, grid.width
    rows = symmetric_index(grid.height, b)[w0:w1]
    lo, hi = max(0, w0 - b), min(grid.height, w1 - b)
    top, mid = lo - (w0 - b), hi - lo
    dst[top : top + mid, b : b + w] = raster[lo:hi]
    dst[:top, b : b + w] = raster[rows[:top]]
    dst[top + mid :, b : b + w] = raster[rows[top + mid :]]
    cols = symmetric_index(w, b) + b
    dst[:, :b] = dst[:, cols[:b]]
    dst[:, b + w :] = dst[:, cols[b + w :]]


def stage_window(
    raster: np.ndarray, grid: PatchGrid, w0: int, w1: int, device: torch.device
) -> torch.Tensor:
    """One band's input window on `device`, in the compact staging dtype:
    the bytes of np.pad(raster, symmetric)[w0:w1]. On CUDA it is filled into
    pinned host memory and copied without blocking on the current stream
    (the caller's copy stream); torch's pinned-memory cache hands the block
    out again only after that copy has completed."""
    dt = staging_dtype(raster.dtype)
    shape = (w1 - w0, grid.width + 2 * grid.border, raster.shape[2])
    if device.type != "cuda":
        win = np.empty(shape, dt)
        _fill_window(win, raster, grid, w0, w1)
        return torch.from_numpy(win).to(device)
    host = torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dt)).dtype, pin_memory=True)
    _fill_window(host.numpy(), raster, grid, w0, w1)
    return host.to(device, non_blocking=True)


def _record(stream) -> torch.cuda.Event:
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def sr_banded(
    rasters: Sequence[np.ndarray],
    lr_factor: int,
    cfg: ModelConfig,
    params,
    infer_cfg: InferConfig,
    rows_per_band: int = 16,
    device_output: bool = False,
    stage_lookahead: int = 2,
    device: Device = None,
):
    """Like infer.api._run but banded. rasters: finest-first HWC numpy (or
    tensors). rows_per_band: patch-grid rows per band (16 rows x 112 px =
    1792 output rows per band on the default 2x geometry). stage_lookahead:
    how many bands ahead the window stager runs when the rasters are host
    arrays (0 = each band's window just in time, still off the main thread).
    Runs on "cuda" unless `device` says otherwise.

    Returns the host mosaic in infer_cfg.output_dtype, or with
    device_output=True a GENERATOR of (tensor, y0, band_h) that reads
    nothing back: band k+1 is queued before band k is yielded, so a consumer
    that drains as it iterates keeps one band computing and about two bands
    of output on the device (holding every band holds the whole mosaic).
    Counts the bytes it moves (engine.h2d_bytes, engine.d2h_bytes), its
    bands and patches (utils/profiling counters).

    Its spans: engine.fill (entry to the first band queued, api.prepare
    inside), engine.stage (a band's windows, on the stager thread),
    engine.wait_stage (the issuing thread waiting for them), engine.band
    (queueing a band's compute), engine.wait_drain (the issuing thread
    waiting for the previous band's drain), engine.drain (the drain thread's
    wait for the copy and its move into the mosaic) and engine.tail (the
    last band queued to the mosaic returned)."""
    if rows_per_band < 1:
        raise ValueError(f"rows_per_band must be >= 1, got {rows_per_band}")
    entered = profiling.now()
    with profiling.span("api.prepare"):
        dev = resolve_device(device)
        plan = plan_tile(rasters, lr_factor, cfg, infer_cfg)
        tparams = params_to_torch(params, dev)

        # Host rasters stream per-band windows; tensors are padded once on
        # the device and every band gathers from the whole padded raster.
        windowed = not any(torch.is_tensor(r) for r in rasters)
        if windowed:
            host = [np.asarray(r) for r in rasters]
        else:
            compute_dtype = getattr(torch, infer_cfg.compute_dtype)
            inputs = tuple(pad_symmetric(_cast(stage_raster(r, dev), compute_dtype), g.border)
                           for r, g in zip(rasters, plan.grids))
        batch = min(infer_cfg.batch_size, plan.nx * min(rows_per_band, plan.ny))
        band_rows = plan_bands(plan.ny, rows_per_band)
    profiling.count("infer.patches", plan.grids[0].num_patches)
    h10, w10 = plan.out_hw
    last_queued = []  # the mark after the last band is queued (engine.tail)

    cuda = dev.type == "cuda"
    h2d = torch.cuda.Stream(dev) if cuda and windowed else None
    d2h = torch.cuda.Stream(dev) if cuda and not device_output else None
    compute = torch.cuda.current_stream(dev) if cuda else None

    def make_band(k):
        """Band k's schedule and inputs; in windowed mode it also fills and
        ships the input windows (on the stager thread, on the h2d stream)
        and returns the event the compute stream must wait on."""
        with profiling.span("engine.stage", k=k):
            band = plan.band(*band_rows[k], batch, windowed)
            if not windowed:
                return band, inputs, None
            with torch.cuda.stream(h2d):  # no-op for None (CPU)
                wins = tuple(stage_window(r, g, w0, w1, dev)
                             for r, g, (w0, w1) in zip(host, plan.grids, band.windows))
                ready = _record(h2d) if cuda else None
            profiling.count("engine.h2d_bytes", sum(w.nbytes for w in wins))
            return band, wins, ready

    def start_readback(band: torch.Tensor):
        """Queue band's copy into pinned host memory on the d2h stream,
        after the compute that writes it; returns (pinned, copied event)."""
        d2h.wait_event(_record(compute))
        with torch.cuda.stream(d2h):
            pinned = torch.empty(band.shape, dtype=band.dtype, pin_memory=True)
            pinned.copy_(band, non_blocking=True)
        band.record_stream(d2h)
        return pinned, _record(d2h)

    def band_iter(emit):
        """Queue band k+1 before yielding band k (as emit(band) returns it,
        right after band k is queued). In windowed mode a one-worker thread
        stages windows `stage_lookahead` bands ahead."""
        nband = len(band_rows)
        lookahead = max(0, stage_lookahead) if windowed else 0
        pool = concurrent.futures.ThreadPoolExecutor(max_workers=1) if windowed else None
        try:
            pending = []
            prev = None
            for k in range(nband):
                if pool is not None:
                    while len(pending) <= lookahead and k + len(pending) < nband:
                        pending.append(pool.submit(contextvars.copy_context().run, make_band,
                                                   k + len(pending)))
                    with profiling.span("engine.wait_stage", k=k):
                        band, band_inputs, ready = pending.pop(0).result()
                else:
                    band, band_inputs, ready = make_band(k)
                with profiling.span("engine.band", k=k):
                    if ready is not None:
                        compute.wait_event(ready)
                        for w in band_inputs:
                            w.record_stream(compute)
                    with torch.no_grad():
                        out = sr_tile(tparams, band_inputs, band.starts, band.positions,
                                      cfg=cfg, infer_cfg=infer_cfg, grids=plan.grids,
                                      out_hw=(band.band_h, w10), pad_inputs=False)
                profiling.count("engine.bands")
                if k == 0:
                    profiling.record("engine.fill", entered)
                if k == nband - 1:
                    last_queued.append(profiling.now())
                if prev is not None:
                    yield prev
                prev = (emit(out), band.y0, band.band_h)
            if prev is not None:
                yield prev
        finally:
            if pool is not None:
                # Drop windows not yet staged when the consumer stops early.
                pool.shutdown(wait=False, cancel_futures=True)

    if device_output:
        return band_iter(lambda band: band)
    mosaic = np.empty((h10, w10, cfg.out_channels), plan.out_dtype)

    def drain(got, y0, band_h):
        """Wait for band's copy, then move its rows into the output."""
        with profiling.span("engine.drain", y0=y0):
            if cuda:
                pinned, copied = got
                copied.synchronize()
                got = pinned
            rows = _host_view(got, plan.out_dtype)
            mosaic[y0 : y0 + band_h] = rows
        return rows.nbytes

    # The rows move on a worker thread (numpy copies without the GIL), so
    # the main thread goes back to queueing the next band at once: a band is
    # thousands of launches, more than CUDA's launch queue holds, and a drain
    # on this thread would leave the card idle for the queue's tail.
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as drainer:
        pending = None
        for band in band_iter(start_readback if cuda else (lambda band: band)):
            if pending is not None:
                with profiling.span("engine.wait_drain"):
                    profiling.count("engine.d2h_bytes", pending.result())
            pending = drainer.submit(contextvars.copy_context().run, drain, *band)
        if pending is not None:
            with profiling.span("engine.wait_drain"):
                profiling.count("engine.d2h_bytes", pending.result())
    profiling.record("engine.tail", last_queued[0] if last_queued else None)
    return mosaic
