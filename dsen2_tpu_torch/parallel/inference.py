"""Mesh-parallel inference: multi-tile fleets and single-tile band sharding.

The counterpart of dsen2_tpu/parallel/inference.py. Tiles are independent
and every patch carries its own halo, so tiles shard over the mesh's 'data'
axis with no communication during compute (`sr_tiles_sharded`).

`sr_tile_sharded` extends that to ONE tile: the patch grid's rows split into
contiguous bands (the banded engine's row decomposition, infer/engine.py),
one per data shard. Each shard receives only its input window (halo
included) and mosaics its own disjoint output band; the edge-flush row is
merged into the band before it, so bands never write the same rows.

One process drives the mesh. Each shard runs on a host worker of its own,
under its device and on a CUDA stream of its own, so N GPUs compute at
once, as JAX's shard_map does; on a mesh that repeats one GPU the workers
launch concurrently on that GPU. The kernels' launches release the
interpreter lock. Shards on the CPU run one after another on the caller's
thread.

Numerics against the single-device path: each shard runs sr_tile with the
chunk batch JAX's sharded program uses, min(batch_size, rows of the largest
band x grid columns), so the mosaic is bit-equal to a single-device run at
that batch.
"""

from __future__ import annotations

import concurrent.futures
import contextvars
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dsen2_tpu_torch.core.config import InferConfig, ModelConfig, dsen2_2x, dsen2_6x
from dsen2_tpu_torch.infer.api import _host_view, sr_tile, stage_raster
from dsen2_tpu_torch.infer.engine import plan_tile, stage_window
from dsen2_tpu_torch.parallel.mesh import Mesh
from dsen2_tpu_torch.utils import profiling
from dsen2_tpu_torch.weights import params_to_torch

__all__ = [
    "sr_tiles_sharded",
    "sr_tile_sharded",
    "dsen2_20_tiles",
    "dsen2_60_tiles",
    "plan_shard_bands",
]


def run_on_shards(devices: Sequence[torch.device], fn: Callable[[int], List[torch.Tensor]]):
    """[fn(s) for each shard s], where fn(s) returns tensors on devices[s].

    With CUDA devices, each shard runs on a host worker of its own, under
    torch.cuda.device(devices[s]) and on a new stream that first waits for
    what the caller queued on that device (the params); the caller's stream
    then waits for the shard's, and each returned tensor is recorded on the
    caller's stream, so the caller may use and free it with no host wait.
    CPU shards run one after another on the caller's thread."""
    if all(d.type != "cuda" for d in devices):
        return [fn(s) for s in range(len(devices))]
    callers = {d: torch.cuda.current_stream(d) for d in set(devices) if d.type == "cuda"}

    def run(s: int):
        dev = devices[s]
        if dev.type != "cuda":
            return fn(s)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(callers[dev])
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            out = fn(s)
        callers[dev].wait_stream(stream)
        for t in out:
            if t is not None:
                t.record_stream(callers[dev])
        return out

    with concurrent.futures.ThreadPoolExecutor(len(devices)) as pool:
        futures = [pool.submit(contextvars.copy_context().run, run, s)
                   for s in range(len(devices))]
        return [f.result() for f in futures]


def _params_on(params, devices: Sequence[torch.device]) -> dict:
    """The params on each distinct device, crossed once per device."""
    return {d: params_to_torch(params, d) for d in dict.fromkeys(devices)}


def sr_tiles_sharded(
    params,
    tile_inputs: Sequence[np.ndarray],  # finest first, each [N, H_r, W_r, C_r]
    lr_factor: int,
    cfg: ModelConfig,
    infer_cfg: InferConfig,
    mesh: Mesh,
) -> np.ndarray:
    """Super-resolve a batch of tiles sharded over the mesh 'data' axis:
    shard s runs tiles [s N/ndev, (s+1) N/ndev). N must divide by the
    data-axis size. Returns [N, H, W, C_out] in infer_cfg.output_dtype."""
    n = tile_inputs[0].shape[0]
    devs = mesh.data_devices
    ndev = len(devs)
    if n % ndev:
        raise ValueError(f"tile batch {n} must divide the data axis {ndev}")
    plan = plan_tile([t[0] for t in tile_inputs], lr_factor, cfg, infer_cfg)
    num_patches = plan.grids[0].num_patches
    band = plan.band(0, plan.ny, min(infer_cfg.batch_size, num_patches), windowed=False)
    tparams = _params_on(params, devs)
    profiling.count("infer.patches", n * num_patches)
    per = n // ndev

    def shard(s: int) -> List[torch.Tensor]:
        dev = devs[s]
        with torch.no_grad():
            return [
                sr_tile(tparams[dev], tuple(stage_raster(np.asarray(t[j]), dev)
                                            for t in tile_inputs),
                        band.starts, band.positions, cfg=cfg, infer_cfg=infer_cfg,
                        grids=plan.grids, out_hw=plan.out_hw)
                for j in range(s * per, (s + 1) * per)
            ]

    results = run_on_shards(devs, shard)
    return np.stack([_host_view(t.cpu(), plan.out_dtype) for tiles in results for t in tiles])


def plan_shard_bands(ny: int, interior: int, out_h: int, ndev: int) -> List[Tuple[int, int]]:
    """Assign the ny patch-grid rows to ndev contiguous bands, balanced to
    within one row. The final edge-flush row (present iff ny*interior >
    out_h) always shares a band with the row before it, so bands write
    DISJOINT output-row ranges: band (r0, r1) owns [r0*interior,
    r1*interior), the last non-empty band owns through out_h. Trailing
    bands may be empty (r0 == r1) when ny < ndev. A copy of the JAX
    package's."""
    base, rem = divmod(ny, ndev)
    rows = [base + (1 if s < rem else 0) for s in range(ndev)]
    has_flush = ny * interior > out_h
    if has_flush and ny >= 2:
        # find the band holding the last row; if it holds ONLY that row,
        # steal one from the previous non-empty band
        bounds = np.cumsum([0] + rows)
        last = next(s for s in range(ndev) if bounds[s] < ny <= bounds[s + 1])
        if rows[last] == 1 and last > 0:
            rows[last - 1] -= 1
            rows[last] += 1
    bounds = np.cumsum([0] + rows)
    return [(int(bounds[s]), int(bounds[s + 1])) for s in range(ndev)]


def sr_tile_sharded(
    params,
    rasters: Sequence[np.ndarray],  # finest first, HWC numpy
    lr_factor: int,
    cfg: ModelConfig,
    infer_cfg: InferConfig,
    mesh: Mesh,
    device_result: bool = False,
):
    """Super-resolve ONE tile with its patch grid sharded over the mesh
    'data' axis: shard s computes grid-row band s of the output mosaic from
    only its own input window (engine.stage_window). Returns the
    [H, W, C_out] host mosaic in infer_cfg.output_dtype.

    device_result=True instead returns (bands, band_meta) with no host
    readback: band_meta is a list of (y0, band_h) per shard, and bands[s]
    the [band_h, W, C_out] band of rows [y0, y0 + band_h) on shard s's
    device (the mosaic dtype of sr_tile), or None for an empty shard
    (band_h 0), which computes nothing. One tensor cannot span devices, so
    the bands stay a list; the mesh ensemble folds them into one sum."""
    plan = plan_tile(rasters, lr_factor, cfg, infer_cfg)
    devs = mesh.data_devices
    h10, w10 = plan.out_hw
    profiling.count("infer.patches", plan.grids[0].num_patches)
    rows = plan_shard_bands(plan.ny, plan.interior, h10, len(devs))
    # JAX's sharded program pads every band to kmax rows; its chunk batch
    # follows from that, and the port keeps it (see the module docstring).
    kmax = max(r1 - r0 for r0, r1 in rows)
    batch = min(infer_cfg.batch_size, kmax * plan.nx)
    bands = [plan.band(r0, r1, batch, windowed=True) for r0, r1 in rows]
    host = [np.asarray(r) for r in rasters]
    tparams = _params_on(params, [d for d, b in zip(devs, bands) if b.band_h])

    def shard(s: int) -> List[Optional[torch.Tensor]]:
        band, dev = bands[s], devs[s]
        if not band.band_h:
            return [None]
        # Each shard ships only its window, staged as the banded engine
        # stages a band's: compact dtypes (the uint16 L1C source) cross
        # unconverted and are cast on the device inside sr_tile.
        windows = tuple(stage_window(r, g, w0, w1, dev)
                        for r, g, (w0, w1) in zip(host, plan.grids, band.windows))
        with torch.no_grad():
            return [sr_tile(tparams[dev], windows, band.starts, band.positions, cfg=cfg,
                            infer_cfg=infer_cfg, grids=plan.grids, out_hw=(band.band_h, w10),
                            pad_inputs=False)]

    results = [r[0] for r in run_on_shards(devs, shard)]
    band_meta = [(b.y0, b.band_h) for b in bands]
    if device_result:
        return results, band_meta
    out = np.empty((h10, w10, cfg.out_channels), plan.out_dtype)
    for band, (y0, band_h) in zip(results, band_meta):
        if band_h:
            out[y0 : y0 + band_h] = _host_view(band.cpu(), plan.out_dtype)
    return out


def dsen2_20_tiles(
    d10s: np.ndarray, d20s: np.ndarray, mesh: Mesh,
    deep: bool = False, params=None, infer_cfg: Optional[InferConfig] = None,
) -> np.ndarray:
    """Batched 2x super-resolution: d10s [N,H,W,4], d20s [N,H/2,W/2,6] ->
    [N,H,W,6], tiles sharded over the mesh."""
    cfg = dsen2_2x(deep)
    infer_cfg = infer_cfg or InferConfig(patch_size=128, border=8)
    if params is None:
        from dsen2_tpu_torch.weights import default_params

        params = default_params(cfg, run_60=False, deep=deep)
    return sr_tiles_sharded(params, [d10s, d20s], 2, cfg, infer_cfg, mesh)


def dsen2_60_tiles(
    d10s: np.ndarray, d20s: np.ndarray, d60s: np.ndarray, mesh: Mesh,
    deep: bool = False, params=None, infer_cfg: Optional[InferConfig] = None,
) -> np.ndarray:
    """Batched 6x super-resolution across the mesh."""
    cfg = dsen2_6x(deep)
    infer_cfg = infer_cfg or InferConfig(patch_size=192, border=12)
    if params is None:
        from dsen2_tpu_torch.weights import default_params

        params = default_params(cfg, run_60=True, deep=deep)
    return sr_tiles_sharded(params, [d10s, d20s, d60s], 6, cfg, infer_cfg, mesh)
