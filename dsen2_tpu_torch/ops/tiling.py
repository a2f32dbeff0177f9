"""Halo-patch decomposition and the border-crop mosaic.

The counterpart of dsen2_tpu/ops/tiling.py. `PatchGrid` is host integer
geometry, and `pad_patch_slack` host numpy, both copied. The halo pad is numpy's mode="symmetric", which
repeats the edge pixel; torch's "reflect" pad does not, so the pad is built by
index. The mosaic writes patch interiors one after another on the stream, in
the reference's order, so overlapping edge-flush patches resolve
last-write-wins as they do there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = [
    "PatchGrid", "symmetric_index", "pad_symmetric", "extract_patches",
    "gather_patches", "recompose_positions", "write_interiors", "recompose",
    "pad_patch_slack",
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

    @property
    def slack_patches(self) -> int:
        """The reference over-allocates (k+1)^2 patch slots and leaves unused
        trailing slots zero (utils/patches.py:35,104); this is the number of
        zero slots needed to reproduce its on-disk patch-archive format."""
        k_i = self.height // self.stride
        k_j = self.width // self.stride
        return (k_i + 1) * (k_j + 1) - self.num_patches

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


def recompose(
    patches: torch.Tensor,
    border: int,
    out_hw: tuple[int, int],
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Crop `border` pixels from every patch edge and mosaic the interiors
    into an [H, W, C] image, one after another in the reference's order, so
    overlapping (edge-flush) patches resolve last-write-wins exactly like
    utils/patches.py:374-405.

    patches: [N, P, P, C] with N >= ceil(H/(P-2b)) * ceil(W/(P-2b)); extra
    trailing patches (the reference's zero-filled slack slots) are ignored.
    A single patch with border 0 covering the image short-circuits, like the
    reference's one-patch path (utils/patches.py:375-376). `out`, when given,
    is written in place and returned; else a zero mosaic on the patches'
    device.
    """
    n, p, _, c = patches.shape
    s = p - 2 * border
    h, w = out_hw
    if n == 1 and border == 0 and (h, w) == (p, p):
        return patches[0]

    if s > h or s > w:
        raise ValueError(
            f"recompose: patch interior {s} exceeds the image {out_hw}; "
            "the patch/border geometry is too large for this image"
        )
    pos = recompose_positions(out_hw, s)
    needed = pos.shape[0]
    if n < needed:
        raise ValueError(f"recompose: got {n} patches, grid needs {needed}")
    if out is None:
        out = torch.zeros((h, w, c), dtype=patches.dtype, device=patches.device)
    write_interiors(out, patches[:needed, border : p - border, border : p - border, :], pos)
    return out


def pad_patch_slack(patches: np.ndarray, grid: PatchGrid) -> np.ndarray:
    """Append the reference's zero slack slots to a host patch array so saved
    archives are bit-compatible with reference-created ones
    (utils/patches.py:35,104: (k+1)^2 allocated slots)."""
    slack = grid.slack_patches
    if slack == 0:
        return patches
    pad = np.zeros((slack,) + patches.shape[1:], dtype=patches.dtype)
    return np.concatenate([patches, pad], axis=0)
