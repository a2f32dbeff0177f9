"""DSen2 inference API: numpy HWC in -> numpy HWC out.

The counterpart of dsen2_tpu/infer/api.py. One pipeline serves both heads:

    symmetric halo pad -> per-chunk patch gather -> per-patch bilinear
    LR->HR upsample (two f32 matmuls) -> the net -> border crop ->
    last-write-wins mosaic

The net is s2net (DSen2, VDSen2) or, for an RCANConfig, RCAN (models/rcan),
or for a HATConfig, HAT (models/hat); every route (one-shot, banded,
sharded, ensemble) runs any of them through sr_tile.

The schedule (patch starts, output positions, chunks) is host numpy, as in
the JAX package, and every route takes it from infer/engine.py's TilePlan
(plan_tile); the rasters, the padded images, every chunk and the mosaic
live on the device. Rasters of dtypes that embed exactly in float32 (uint16
L1C data above all) cross to the device unconverted and are cast there.
Host outputs of _BANDED_THRESHOLD_PX pixels or more go through the banded
engine (infer/engine.py), which overlaps both transfers with compute.
`ensemble=True` averages the 8 dihedral transforms on the device and reads
back one mosaic.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dsen2_tpu_torch.core.bands import SCALE
from dsen2_tpu_torch.core.config import InferConfig, ModelConfig, dsen2_2x, dsen2_6x
from dsen2_tpu_torch.core.device import resolve_device, upload
from dsen2_tpu_torch.models import hat, rcan, s2net
from dsen2_tpu_torch.ops.resize import upsample_patches
from dsen2_tpu_torch.ops.tiling import (
    PatchGrid, gather_patches, pad_symmetric, write_interiors,
)
from dsen2_tpu_torch.parallel.mesh import primary_device
from dsen2_tpu_torch.utils import profiling
from dsen2_tpu_torch.weights import default_params, params_to_torch

__all__ = [
    "dsen2_20", "dsen2_60", "sr_tile", "build_grids", "stage_raster", "staging_dtype",
]

Device = Union[str, torch.device, None]

# Host-output tiles of at least this many 10 m pixels go through the banded
# engine; the ensemble uses it to pick the banded route for large tiles.
_BANDED_THRESHOLD_PX = 3000 * 3000


def build_grids(
    shapes: Sequence[Tuple[int, ...]], lr_factor: int, infer_cfg: InferConfig
) -> Tuple[PatchGrid, ...]:
    """Per-raster patch grids for finest-first raster shapes ((H, W[, C])).
    The grid lives on the coarsest raster and is scaled up to each finer one."""
    h10 = shapes[0][0]
    p_hr, b_hr = infer_cfg.patch_size, infer_cfg.border
    g_coarse = PatchGrid(
        shapes[-1][0], shapes[-1][1], p_hr // lr_factor, b_hr // lr_factor
    )
    factors = [lr_factor // (h10 // s[0]) for s in shapes]
    return tuple(g_coarse.scaled(f) for f in factors)


# Dtypes whose values embed exactly in float32: they cross host->device as
# they are and are cast on the device.
_COMPACT_STAGE_DTYPES = tuple(
    np.dtype(t) for t in (np.uint8, np.int8, np.uint16, np.int16, np.float16)
)


def staging_dtype(dtype) -> np.dtype:
    """The dtype a raster of `dtype` crosses to the device as: itself when its
    values embed exactly in float32, float32 otherwise."""
    dt = np.dtype(dtype)
    return dt if dt in _COMPACT_STAGE_DTYPES else np.dtype(np.float32)


def stage_raster(r, device: Device) -> torch.Tensor:
    """Move one host raster to `device` with the fewest bytes (see
    staging_dtype). Tensors already on the device pass through."""
    if torch.is_tensor(r):
        return r.to(device)
    a = np.ascontiguousarray(np.asarray(r))
    return torch.from_numpy(a.astype(staging_dtype(a.dtype), copy=False)).to(device)


def _cast(img: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Cast a staged raster to the compute dtype on its device. uint16 goes
    through int32, whose conversions every backend has."""
    if img.dtype == torch.uint16:
        img = img.view(torch.int16).to(torch.int32) & 0xFFFF
    return img.to(dtype)


def _mosaic_dtype(out_dtype: np.dtype) -> torch.dtype:
    """The device dtype of a mosaic of `out_dtype`: the same width, and
    signed for unsigned types wider than a byte, which hold their values'
    two's-complement bit patterns (torch has few kernels for uint16;
    _host_view reinterprets the bytes on the host)."""
    if out_dtype == np.uint8:
        return torch.uint8
    if np.issubdtype(out_dtype, np.integer):
        return getattr(torch, f"int{8 * out_dtype.itemsize}")
    return getattr(torch, out_dtype.name)


def _quantize(v: torch.Tensor, out_dtype: np.dtype) -> torch.Tensor:
    """Round half to even, clip to out_dtype's range, store in
    _mosaic_dtype(out_dtype) (through int64, which wraps to the narrower
    signed type bit for bit)."""
    info = np.iinfo(out_dtype)
    v = torch.clamp(torch.round(v), info.min, info.max).to(torch.int64)
    if out_dtype.itemsize <= 4:  # f32 rounds 2**31 - 1 and 2**32 - 1 up
        v = v.clamp(info.min, info.max)
    return v.to(_mosaic_dtype(out_dtype))


def _host_view(t: torch.Tensor, out_dtype: np.dtype) -> np.ndarray:
    """A mosaic tensor on the host as a numpy array of out_dtype (a view of
    the same bytes: unsigned types come back from their signed twin, and
    bfloat16, which numpy has only through ml_dtypes, through int16)."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    a = t.numpy()
    return a if a.dtype == out_dtype else a.view(out_dtype)


def net_apply(cfg):
    """The forward pass of cfg's net: rcan.apply for an RCANConfig,
    hat.apply for a HATConfig, else s2net.apply."""
    if isinstance(cfg, rcan.RCANConfig):
        return rcan.apply
    return hat.apply if isinstance(cfg, hat.HATConfig) else s2net.apply


def sr_tile(
    params,
    inputs: Tuple[torch.Tensor, ...],
    starts: np.ndarray,  # [nb, B, n_inputs, 2] per-chunk per-input patch starts
    positions: np.ndarray,  # [nb, B, 2] output-space interior positions
    *,
    cfg: ModelConfig,
    infer_cfg: InferConfig,
    grids: Tuple[PatchGrid, ...],
    out_hw: Tuple[int, int],
    pad_inputs: bool = True,
) -> torch.Tensor:
    """Tiled super-resolution over `inputs` (HWC rasters on one device, one
    per resolution, finest first) with torch params. Returns the
    [H, W, C_out] mosaic on that device: float in infer_cfg.output_dtype,
    or for an integer output_dtype the rounded, clipped values in a tensor
    of that dtype's width (_mosaic_dtype; _host_view reads it back).

    pad_inputs=False: the inputs are windows that already carry their
    symmetric halo, and `starts` are window coordinates. Nothing here makes
    the host wait for the device."""
    p_hr, border = infer_cfg.patch_size, infer_cfg.border
    out_dtype = np.dtype(infer_cfg.output_dtype)
    integer = np.issubdtype(out_dtype, np.integer)
    compute_dtype = getattr(torch, infer_cfg.compute_dtype)
    if compute_dtype != torch.float32:
        params = {top: {k: v.to(compute_dtype) for k, v in sub.items()}
                  for top, sub in params.items()}

    padded = [_cast(img, compute_dtype) for img in inputs]
    if pad_inputs:
        padded = [pad_symmetric(img, g.border) for img, g in zip(padded, grids)]
    device = inputs[0].device
    starts_dev = upload(starts, device)
    inv_scale = float(np.float32(1.0 / SCALE))
    mosaic = torch.zeros((out_hw[0], out_hw[1], cfg.out_channels),
                         dtype=_mosaic_dtype(out_dtype), device=device)
    for chunk_starts, chunk_pos in zip(starts_dev, positions):
        patches = [gather_patches(pad, chunk_starts[:, i], g.patch)
                   for i, (pad, g) in enumerate(zip(padded, grids))]
        net_in = [patches[0] * inv_scale]
        net_in += [upsample_patches(p, (p_hr, p_hr)) * inv_scale for p in patches[1:]]
        pred = net_apply(cfg)(params, net_in, cfg, precision=infer_cfg.precision,
                              use_kernels=infer_cfg.use_kernels)
        pred = pred.float() * SCALE
        interiors = pred[:, border : p_hr - border, border : p_hr - border, :]
        interiors = _quantize(interiors, out_dtype) if integer else interiors.to(mosaic.dtype)
        write_interiors(mosaic, interiors, chunk_pos)
    return mosaic


def _validate_inputs(
    rasters: Sequence[np.ndarray], lr_factor: int, cfg: ModelConfig, infer_cfg: InferConfig
) -> None:
    names = ("d10", "d20", "d60")[: len(rasters)]
    h10, w10 = rasters[0].shape[:2]
    for r, name, want_c in zip(rasters, names, cfg.in_channels):
        if r.ndim != 3:
            raise ValueError(f"{name}: expected an HWC array, got shape {r.shape}")
        if r.shape[-1] != want_c:
            raise ValueError(
                f"{name}: expected {want_c} bands (got {r.shape[-1]}); band order "
                "follows testing/supres.py:16-18,34-37 of the reference"
            )
        down = h10 // r.shape[0]
        if down * r.shape[0] != h10 or down * r.shape[1] != w10 or lr_factor % max(down, 1):
            raise ValueError(
                f"{name} shape {tuple(r.shape[:2])} does not align with the 10m grid "
                f"({h10}x{w10}): each raster must be an integer 1/2 or 1/6 of it"
            )
    # Every raster, once halo-padded, must hold at least one patch.
    min_lr = infer_cfg.patch_size // lr_factor - 2 * (infer_cfg.border // lr_factor)
    if rasters[-1].shape[0] < min_lr or rasters[-1].shape[1] < min_lr:
        raise ValueError(
            f"image too small for patch_size={infer_cfg.patch_size}/"
            f"border={infer_cfg.border}: the coarsest raster is "
            f"{tuple(rasters[-1].shape[:2])} but must be at least {min_lr}x{min_lr}; "
            "pass a smaller InferConfig.patch_size"
        )


def _run(
    rasters: Sequence[np.ndarray],
    lr_factor: int,
    cfg: ModelConfig,
    params,
    infer_cfg: InferConfig,
    device: Device = None,
    device_output: bool = False,
    mesh=None,
):
    """The 2x and 6x paths share this runner. rasters: finest-first HWC numpy
    (or tensors); params: a numpy (or tensor) params dict. Returns a host
    array, or with device_output=True the mosaic tensor on the device (in
    _mosaic_dtype). Host outputs of _BANDED_THRESHOLD_PX pixels or more go
    through the banded engine. With a mesh of several devices, the tile's
    grid rows shard over its 'data' axis (parallel.inference.
    sr_tile_sharded), one output band per shard; a one-device mesh runs
    this single-device path on its device. The call is one span, api.run,
    with its route and its 10 m pixels (px)."""
    h10, w10 = rasters[0].shape[:2]
    if mesh is not None and mesh.devices.size > 1:
        route = "mesh"
    elif not device_output and h10 * w10 >= _BANDED_THRESHOLD_PX:
        route = "banded"
    else:
        route = "one_shot"
    with profiling.span("api.run", route=route, px=h10 * w10):
        return _run_route(route, rasters, lr_factor, cfg, params, infer_cfg, device,
                          device_output, mesh)


def _run_route(route, rasters, lr_factor, cfg, params, infer_cfg, device, device_output, mesh):
    """_run's work along `route`."""
    if route == "mesh":
        if device_output:
            raise ValueError(
                "device_output=True is not supported with a multi-device mesh: "
                "sr_tile_sharded assembles the mosaic on the host from per-shard "
                "bands. Drop device_output or run without a mesh."
            )
        from dsen2_tpu_torch.parallel.inference import sr_tile_sharded

        primary_device(mesh, device)
        return sr_tile_sharded(params, rasters, lr_factor, cfg, infer_cfg, mesh)
    from dsen2_tpu_torch.infer.engine import plan_tile, sr_banded

    dev = resolve_device(device if mesh is None else primary_device(mesh, device))
    if route == "banded":
        return sr_banded(rasters, lr_factor, cfg, params, infer_cfg, device=dev)
    with profiling.span("api.prepare"):
        plan = plan_tile(rasters, lr_factor, cfg, infer_cfg)
        num_patches = plan.grids[0].num_patches
        band = plan.band(0, plan.ny, min(infer_cfg.batch_size, num_patches), windowed=False)
        tparams = params_to_torch(params, dev)
    profiling.count("infer.patches", num_patches)

    with torch.no_grad():
        out = sr_tile(
            tparams,
            tuple(stage_raster(r, dev) for r in rasters),
            band.starts, band.positions,
            cfg=cfg, infer_cfg=infer_cfg, grids=plan.grids, out_hw=plan.out_hw,
        )
    if device_output:
        return out
    return _host_view(out.cpu(), plan.out_dtype)


def _ens_add_band(acc: torch.Tensor, stripe: torch.Tensor, idx: int, *, k: int, f: bool):
    """Add one band of a dihedral-transformed SR mosaic into the
    output-space f32 accumulator, in place. The band covers rows [y0, y0+h)
    of the TRANSFORMED mosaic; under the inverse transform it lands as a
    contiguous row stripe (k even) or column stripe (k odd) of output space,
    starting at row or column `idx`; k/f encode the forward transform
    (ops/dihedral.py: k quarter-turns, then a flip along axis 0 iff f)."""
    s = torch.flip(stripe, dims=(0,)) if f else stripe
    # The inverse, once the flip is undone, is rot90(.., -k) of the stripe.
    content = torch.rot90(s.float(), -k, dims=(0, 1))
    if k % 2 == 0:
        acc[idx : idx + content.shape[0]] += content
    else:
        acc[:, idx : idx + content.shape[1]] += content
    return acc


def _ens_accumulate_bands(acc: torch.Tensor, bands, code: int) -> torch.Tensor:
    """Fold one dihedral transform's banded SR output into the accumulator,
    band by band, so that no full transformed mosaic is ever held. bands:
    iterable of (tensor, y0, band_h) in the TRANSFORMED mosaic's rows."""
    k, f = code % 4, code >= 4
    h_out, w_out = acc.shape[:2]
    rows_tr = h_out if k % 2 == 0 else w_out  # rows of the transformed mosaic
    for band, y0, h in bands:
        a = rows_tr - y0 - h if f else y0  # stripe start after un-flipping
        # After rot90(.., -k) the stripe starts at:
        #   k=0: row a    k=1: col rows_tr-a-h    k=2: row rows_tr-a-h
        #   k=3: col a
        idx = a if k in (0, 3) else rows_tr - a - h
        acc = _ens_add_band(acc, band, idx, k=k, f=f)
    return acc


def _run_ensembled(
    rasters: Sequence[np.ndarray],
    lr_factor: int,
    cfg: ModelConfig,
    params,
    infer_cfg: InferConfig,
    device: Device = None,
    mesh=None,
) -> np.ndarray:
    """Geometric self-ensemble: run the pipeline on all 8 dihedral
    transforms of the input rasters, invert each prediction, average.

    The rasters cross to the device once; the 8 transforms and the f32 sum
    live there, and the host reads back one mosaic. Tiles below
    _BANDED_THRESHOLD_PX run each transform whole; larger ones run the
    banded engine and fold each band into the sum as it comes, so the
    device holds the sum and about two bands, never a transformed mosaic.
    An integer output_dtype is applied once, to the mean.

    With a mesh of several devices, each transform is transformed on the
    host (the band decomposition depends on the orientation) and runs
    sr_tile_sharded with device_result=True; every shard's band folds into
    the f32 sum on the mesh's first device, and the host reads back one
    mosaic. A one-device mesh runs the single-device path on its device.
    The call is one span, api.run, with route "ensemble" and its 10 m
    pixels (px); the transforms' own calls nest inside it."""
    h10, w10 = rasters[0].shape[:2]
    with profiling.span("api.run", route="ensemble", px=h10 * w10):
        return _ensemble(rasters, lr_factor, cfg, params, infer_cfg, device, mesh)


def _ensemble(rasters, lr_factor, cfg, params, infer_cfg, device, mesh) -> np.ndarray:
    """_run_ensembled's work."""
    from dsen2_tpu_torch.infer.engine import plan_tile, sr_banded
    from dsen2_tpu_torch.ops.dihedral import dihedral_np, dihedral_static, inverse_code

    sharded = mesh is not None and mesh.devices.size > 1
    dev = resolve_device(device if mesh is None else primary_device(mesh, device))
    plan = plan_tile(rasters, lr_factor, cfg, infer_cfg)
    h10, w10 = plan.out_hw
    f32_cfg = dataclasses.replace(infer_cfg, output_dtype="float32")
    acc = torch.zeros((h10, w10, cfg.out_channels), dtype=torch.float32, device=dev)
    if sharded:
        from dsen2_tpu_torch.parallel import inference as pinf

        for code in range(8):
            tr = [dihedral_np(np.asarray(r), code) for r in rasters]
            bands, band_meta = pinf.sr_tile_sharded(params, tr, lr_factor, cfg, f32_cfg, mesh,
                                                    device_result=True)
            acc = _ens_accumulate_bands(
                acc, ((b.to(dev), y0, h) for b, (y0, h) in zip(bands, band_meta) if h), code)
        return _ens_finish(acc, plan.out_dtype)
    tparams = params_to_torch(params, dev)
    # f32 on the device, exact for the compact dtypes, before any transform.
    staged = [_cast(stage_raster(r, dev), torch.float32) for r in rasters]
    large = h10 * w10 >= _BANDED_THRESHOLD_PX
    for code in range(8):
        tr = [dihedral_static(r, code) for r in staged]
        if large:
            bands = sr_banded(tr, lr_factor, cfg, tparams, f32_cfg, device_output=True,
                              device=dev)
            acc = _ens_accumulate_bands(acc, bands, code)
        else:
            sr = _run(tr, lr_factor, cfg, tparams, f32_cfg, device=dev, device_output=True)
            acc += dihedral_static(sr, inverse_code[code])
    return _ens_finish(acc, plan.out_dtype)


def _ens_finish(acc: torch.Tensor, out_dtype: np.dtype) -> np.ndarray:
    """The mean of the 8 transforms' f32 sum, quantised once for an integer
    output_dtype, read back once."""
    mean = acc / 8.0
    if np.issubdtype(out_dtype, np.integer):
        mean = _quantize(mean, out_dtype)
    else:
        mean = mean.to(_mosaic_dtype(out_dtype))
    return _host_view(mean.cpu(), out_dtype)


def _output_dtype(name: str) -> np.dtype:
    """float32, float16, an integer dtype, or bfloat16 as ml_dtypes.bfloat16
    where ml_dtypes is importable (numpy has no bfloat16 of its own)."""
    if name == "bfloat16":
        try:
            import ml_dtypes
        except ImportError:
            raise NotImplementedError(
                "output_dtype='bfloat16' returns ml_dtypes.bfloat16 arrays; "
                "ml_dtypes is not installed"
            ) from None
        return np.dtype(ml_dtypes.bfloat16)
    try:
        dt = np.dtype(name)
    except TypeError:
        dt = None
    if dt is None or not (np.issubdtype(dt, np.integer) or dt in (np.float32, np.float16)):
        raise NotImplementedError(
            f"output_dtype={name!r}: the port returns float32, float16, "
            "bfloat16 or integer mosaics"
        )
    return dt


def dsen2_20(
    d10: np.ndarray,
    d20: np.ndarray,
    deep: bool = False,
    params=None,
    infer_cfg: Optional[InferConfig] = None,
    mesh=None,
    ensemble: bool = False,
    device: Device = None,
    model: Optional[Union[rcan.RCANConfig, hat.HATConfig]] = None,
) -> np.ndarray:
    """Super-resolve the six 20 m bands to 10 m.

    d10: [H, W, 4] (B2, B3, B4, B8); d20: [H/2, W/2, 6]
    (B5, B6, B7, B8A, B11, B12). ensemble=True averages over the 8 dihedral
    transforms (8x the compute). Runs on "cuda" unless `device` says
    otherwise. With a mesh (parallel.make_mesh), ONE tile's patch grid
    shards over the mesh's 'data' axis.

    model=None runs DSen2 (VDSen2 with deep=True); an RCANConfig
    (models.rcan.rcan_2x()) runs RCAN instead, with `params` in
    models.rcan.init_params's layout, and a HATConfig (models.hat.hat_2x())
    HAT, with `params` in models.hat.init_params's layout (there are no
    shipped RCAN or HAT weights; `deep` is then not read). HAT's window must
    divide infer_cfg.patch_size."""
    cfg = dsen2_2x(deep) if model is None else model
    infer_cfg = infer_cfg or InferConfig(patch_size=128, border=8)
    if params is None:
        if model is not None:
            raise ValueError("RCAN and HAT have no shipped weights: pass params= "
                             "(models.rcan.init_params's or models.hat.init_params's "
                             "layout)")
        params = default_params(cfg, run_60=False, deep=deep)
    run = _run_ensembled if ensemble else _run
    return run([d10, d20], 2, cfg, params, infer_cfg, device, mesh=mesh)


def dsen2_60(
    d10: np.ndarray,
    d20: np.ndarray,
    d60: np.ndarray,
    deep: bool = False,
    params=None,
    infer_cfg: Optional[InferConfig] = None,
    mesh=None,
    ensemble: bool = False,
    device: Device = None,
) -> np.ndarray:
    """Super-resolve the two 60 m bands (B1, B9) to 10 m (patch 192, border
    12). ensemble=True averages over the 8 dihedral transforms. Runs on
    "cuda" unless `device` says otherwise; with a mesh, over its devices."""
    cfg = dsen2_6x(deep)
    infer_cfg = infer_cfg or InferConfig(patch_size=192, border=12)
    if params is None:
        params = default_params(cfg, run_60=True, deep=deep)
    run = _run_ensembled if ensemble else _run
    return run([d10, d20, d60], 6, cfg, params, infer_cfg, device, mesh=mesh)
