"""Halo-patch decomposition and the border-crop mosaic.

The counterpart of dsen2_tpu/ops/tiling.py:33-147. `PatchGrid` is host
integer geometry, copied. The halo pad is numpy's mode="symmetric", which
repeats the edge pixel; torch's "reflect" pad does not, so the pad is built by
index. The mosaic writes patch interiors one after another on the stream, in
the reference's order, so overlapping edge-flush patches resolve
last-write-wins as they do there.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "PatchGrid", "symmetric_index", "pad_symmetric", "extract_patches",
    "gather_patches", "recompose_positions", "write_interiors",
]


@dataclasses.dataclass(frozen=True)
class PatchGrid:
    """Static geometry of the overlapping patch decomposition along one image,
    in pixels of one raster, measured in the PADDED image (padding = `border`
    on each side). A copy of dsen2_tpu.ops.tiling.PatchGrid."""

    height: int  # unpadded image height on this raster
    width: int
    patch: int  # patch size on this raster
    border: int  # halo on this raster

    @property
    def stride(self) -> int:
        return self.patch - 2 * self.border

    def starts_1d(self, n: int) -> tuple[int, ...]:
        """Patch start offsets (in padded coordinates) along an axis of
        unpadded length n: regular stride-spaced starts plus an edge-flush
        final start when the stride does not divide n."""
        s = self.stride
        if n < s:
            raise ValueError(
                f"image extent {n} is smaller than the patch interior {s} "
                f"(patch {self.patch}, border {self.border}); use a smaller "
                "patch size"
            )
        starts = [i * s for i in range(n // s)]
        if n % s != 0:
            starts.append(n + 2 * self.border - self.patch)
        return tuple(starts)

    @property
    def starts_i(self) -> tuple[int, ...]:
        return self.starts_1d(self.height)

    @property
    def starts_j(self) -> tuple[int, ...]:
        return self.starts_1d(self.width)

    @property
    def num_patches(self) -> int:
        return len(self.starts_i) * len(self.starts_j)

    def scaled(self, factor: int) -> "PatchGrid":
        """The same grid expressed on a raster `factor`x finer."""
        return PatchGrid(
            self.height * factor, self.width * factor,
            self.patch * factor, self.border * factor,
        )

    def flat_starts(self) -> np.ndarray:
        """[N, 2] int32 (i, j) patch starts in padded coordinates, row-major
        in the reference's iteration order (i outer, j inner)."""
        si, sj = np.meshgrid(
            np.asarray(self.starts_i, np.int32), np.asarray(self.starts_j, np.int32),
            indexing="ij",
        )
        return np.stack([si.ravel(), sj.ravel()], axis=1)


def symmetric_index(n: int, pad: int) -> np.ndarray:
    """Source indices of an axis of length n padded by `pad` on each side in
    numpy's mode="symmetric" (edge pixel repeated, period 2n)."""
    idx = np.mod(np.arange(-pad, n + pad), 2 * n)
    return np.where(idx >= n, 2 * n - 1 - idx, idx)


def _symmetric_index_on(n: int, pad: int, device: torch.device) -> torch.Tensor:
    """symmetric_index computed on `device`, so that no host array has to
    cross (a pageable host->device copy waits for the device)."""
    idx = torch.remainder(torch.arange(-pad, n + pad, device=device), 2 * n)
    return torch.where(idx >= n, 2 * n - 1 - idx, idx)


def pad_symmetric(img: torch.Tensor, pad: int) -> torch.Tensor:
    """np.pad(img, ((pad, pad), (pad, pad), (0, 0)), mode="symmetric") for an
    [H, W, C] tensor, built by index on img's device."""
    h, w = img.shape[:2]
    iy = _symmetric_index_on(h, pad, img.device)
    ix = _symmetric_index_on(w, pad, img.device)
    return img.index_select(0, iy).index_select(1, ix)


def gather_patches(padded: torch.Tensor, starts, patch: int) -> torch.Tensor:
    """[B, patch, patch, C] windows of a padded [H, W, C] tensor at the
    (i, j) starts [B, 2]: a host array, or an integer tensor already on
    padded's device (then nothing crosses to the device)."""
    starts = torch.as_tensor(starts, device=padded.device).long()
    ar = torch.arange(patch, device=padded.device)
    rows = starts[:, 0, None] + ar
    cols = starts[:, 1, None] + ar
    return padded[rows[:, :, None], cols[:, None, :]]


def extract_patches(img: torch.Tensor, grid: PatchGrid) -> torch.Tensor:
    """Symmetric-pad [H, W, C] by grid.border and gather all halo patches in
    the reference's order -> [N, patch, patch, C]."""
    return gather_patches(pad_symmetric(img, grid.border), grid.flat_starts(), grid.patch)


def recompose_positions(out_hw: tuple[int, int], interior: int) -> np.ndarray:
    """[N, 2] int32 output-space positions where each patch interior lands,
    in the reference's mosaic order with edge clamping (utils/patches.py:
    394-403): position = tile_index * interior, clamped to size - interior;
    y outer, x inner."""
    h, w = out_hw
    ys = np.minimum(np.arange(-(-h // interior)) * interior, h - interior)
    xs = np.minimum(np.arange(-(-w // interior)) * interior, w - interior)
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    return np.stack([yy.ravel(), xx.ravel()], axis=1).astype(np.int32)


def write_interiors(mosaic: torch.Tensor, interiors: torch.Tensor, positions: np.ndarray) -> None:
    """Write [B, s, s, C] interiors into the [H, W, C] mosaic at the host
    positions [B, 2], one after another, so a later patch overwrites an
    earlier one where they overlap (last write wins)."""
    s = interiors.shape[1]
    for patch, (y, x) in zip(interiors, positions.tolist()):
        mosaic[y : y + s, x : x + s] = patch
