"""The tiled super-resolution of one tile, patch by patch, in plain PyTorch.

Written from the reference's testing/supres.py and utils/patches.py, not from
dsen2_tpu_torch. For lr_factor f (2 for the 20 m bands, 6 for the 60 m ones):

- The patch grid lives on the coarsest raster: patch P/f, border B/f,
  stride S = (P - 2B)/f; starts k * S in the raster padded by B/f on each
  side (numpy's mode="symmetric", the edge pixel repeated), plus an
  edge-flush start n + 2B/f - P/f when S does not divide the extent n. Each
  finer raster uses the same grid scaled by its factor.
- Each patch: the 10 m window / SCALE; every coarser window upsampled to
  P x P by skimage's bilinear resize (order 1, mode "reflect", centred
  pixels) of window / 30000, times 30000, / SCALE; the net; x SCALE; the
  border of B pixels cropped.
- The mosaic: interior (i, j) lands at (min(i (P - 2B), H - (P - 2B)),
  min(j (P - 2B), W - (P - 2B))), rows outer, columns inner, later patches
  overwriting earlier ones. So the pixels that patch (i, j) finally owns are
  rows [y_i, y_{i+1}) and columns [x_j, x_{j+1}) of the mosaic, with
  y_{last+1} = H and x_{last+1} = W.

`TileReference` computes the owned block of any patch, in blocks of patches
on one device, float32 with TF32 off.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from perfbench.reference import net as refnet

SCALE = 2000.0
INTERP_NORM = 30000.0


def axis_starts(n: int, patch: int, border: int) -> List[int]:
    """Patch starts along an axis of extent n, in coordinates of the axis
    padded by `border` on each side."""
    stride = patch - 2 * border
    if n < stride:
        raise ValueError(f"extent {n} is smaller than the patch interior {stride}")
    starts = [k * stride for k in range(n // stride)]
    if n % stride:
        starts.append(n + 2 * border - patch)
    return starts


def mosaic_positions(n: int, interior: int) -> List[int]:
    """Where each interior lands along an axis of the n-pixel mosaic."""
    return [min(k * interior, n - interior) for k in range(-(-n // interior))]


def symmetric_take(n: int, first: int, count: int, border: int) -> np.ndarray:
    """Indices into an unpadded axis of length n of padded positions
    first .. first + count - 1 (padding `border`, mode="symmetric")."""
    idx = np.arange(first, first + count) - border
    idx = np.mod(idx, 2 * n)
    return np.where(idx >= n, 2 * n - 1 - idx, idx)


def bilinear(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of skimage.transform.resize(order=1,
    mode="reflect") along one axis: output o samples input coordinate
    (o + 0.5) n_in / n_out - 0.5, mirrored about the first and last sample
    centres, linearly interpolated between its two neighbours."""
    w = np.zeros((n_out, n_in))
    for o in range(n_out):
        c = (o + 0.5) * n_in / n_out - 0.5
        if n_in > 1:
            period = 2 * (n_in - 1)
            c = np.mod(c, period)
            c = period - c if c > n_in - 1 else c
        lo = min(int(np.floor(c)), max(n_in - 2, 0))
        frac = c - lo
        w[o, lo] += 1 - frac
        if n_in > 1:
            w[o, lo + 1] += frac
    return w


class TileReference:
    """The reference mosaic of one tile for one net, patch by patch.

    rasters: host HWC arrays, finest first (10 m, 20 m[, 60 m]); net: a net
    entry of a configuration file; params: flat {"head.w": ...} weights, or
    None for the geometry alone."""

    def __init__(self, rasters: Sequence[np.ndarray], net: dict, params: Dict, device):
        self.rasters = rasters
        self.net = net
        self.device = torch.device(device)
        self.params = None if params is None else refnet.to_device(params, self.device)
        f = net["lr_factor"]
        p, b = net["patch_size"], net["border"]
        self.h, self.w = rasters[0].shape[:2]
        self.interior = p - 2 * b
        coarse = rasters[-1]
        if coarse.shape[0] * f != self.h or coarse.shape[1] * f != self.w:
            raise ValueError("the coarsest raster does not tile the 10 m grid")
        # How many times finer than the coarsest raster each raster is.
        self.scales = [f // (self.h // r.shape[0]) for r in rasters]
        si = axis_starts(coarse.shape[0], p // f, b // f)
        sj = axis_starts(coarse.shape[1], p // f, b // f)
        self.ys = mosaic_positions(self.h, self.interior)
        self.xs = mosaic_positions(self.w, self.interior)
        if len(si) != len(self.ys) or len(sj) != len(self.xs):
            raise ValueError("patch grid and mosaic disagree")
        self.starts = (si, sj)
        self.rows, self.cols = len(si), len(sj)
        self._up = {}

    def owned(self, i: int, j: int) -> Tuple[int, int, int, int]:
        """Mosaic rows [y0, y1) and columns [x0, x1) that patch (i, j) owns."""
        y1 = self.ys[i + 1] if i + 1 < self.rows else self.h
        x1 = self.xs[j + 1] if j + 1 < self.cols else self.w
        return self.ys[i], y1, self.xs[j], x1

    def _window(self, k: int, i: int, j: int) -> np.ndarray:
        """Patch (i, j) of raster k: [C, p, p] float32."""
        r, s = self.rasters[k], self.scales[k]
        f = self.net["lr_factor"]
        p, b = self.net["patch_size"] * s // f, self.net["border"] * s // f
        ri = symmetric_take(r.shape[0], self.starts[0][i] * s, p, b)
        rj = symmetric_take(r.shape[1], self.starts[1][j] * s, p, b)
        return np.ascontiguousarray(r[ri][:, rj].transpose(2, 0, 1), np.float32)

    def _upsample(self, x: torch.Tensor) -> torch.Tensor:
        n_in, n_out = x.shape[-1], self.net["patch_size"]
        if n_in == n_out:
            return x
        if n_in not in self._up:
            self._up[n_in] = torch.as_tensor(bilinear(n_in, n_out), dtype=torch.float32,
                                             device=self.device)
        m = self._up[n_in]
        return torch.einsum("ph,nchw,qw->ncpq", m, x / INTERP_NORM, m) * INTERP_NORM

    def blocks(self, ids: Sequence[Tuple[int, int]], batch: int = 16) -> List[np.ndarray]:
        """The owned block of each patch (i, j) in `ids`, [h, w, C_out]
        float32 DN."""
        b = self.net["border"]
        out = []
        with refnet.no_tf32(), torch.no_grad():
            for s in range(0, len(ids), batch):
                part = ids[s:s + batch]
                ins = []
                for k in range(len(self.rasters)):
                    x = torch.as_tensor(np.stack([self._window(k, i, j) for i, j in part]),
                                        device=self.device)
                    ins.append((x if k == 0 else self._upsample(x)) / SCALE)
                pred = refnet.forward(self.params, ins, self.net["residual_scale"]) * SCALE
                pred = pred[:, :, b:b + self.interior, b:b + self.interior]
                pred = pred.permute(0, 2, 3, 1).cpu().numpy()
                for (i, j), v in zip(part, pred):
                    y0, y1, x0, x1 = self.owned(i, j)
                    out.append(v[:y1 - y0, :x1 - x0])
        return out


def sample_ids(rows: int, cols: int, block: int,
               rng: np.random.Generator) -> List[Tuple[int, int]]:
    """The patches a check compares, stratified so that no run of patches
    that the program computes together can miss the sample:

    - the four corners and the patches next to the edge-flush row and column;
    - the last patch of every patch row, so every row, and so every band of
      rows and every band's last (short) batch, is in it;
    - one patch drawn from rng in each aligned run of `block` patches in
      row-major order, so that any `2 * block` consecutive patches (a batch
      of the program's) hold at least one.

    No repeats; the order is that of the rules above."""
    fixed = [(0, 0), (0, cols - 1), (rows - 1, 0), (rows - 1, cols - 1),
             (max(rows - 2, 0), cols - 1), (rows - 1, max(cols - 2, 0))]
    fixed += [(i, cols - 1) for i in range(rows)]
    total = rows * cols
    for s in range(0, total, block):
        flat = int(rng.integers(s, min(s + block, total)))
        fixed.append((flat // cols, flat % cols))
    return list(dict.fromkeys(fixed))
