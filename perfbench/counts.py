"""Operations and bytes of a cell's work, counted from its shapes.

The per-layer metrics `mfu.*` and `b1_roofline.*` divide these counts by
measured time. They are computed here from the cell's own sizes and never
read from the program's counters, so the same work is counted whatever
implements it.

- Model FLOPs: 2 * 9 * C_in * C_out per pixel for every 3x3 conv of the net
  (head, 2 per residual block, tail), over every pixel of every patch of the
  patch grid (patches, not the padded duplicates of a chunk). Training
  counts 3x the forward.
- Kernel B1 (the residual blocks): the bf16 products of the blocks' convs
  times the passes of the accuracy class (3 at "high", 1 at "default"),
  against x read once, the output written once (f32) and the f32 weights
  read once per call of `batch` patches, as chip_smoke.bound_ms counts them.
"""

from __future__ import annotations

import math

# Published dense peaks of one H100 SXM (NVIDIA data sheet) and its HBM rate.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

PASSES = {"high": 3, "default": 1}


def grid_cells(n_coarse: int, patch_coarse: int, border_coarse: int) -> int:
    """Patches along one axis of the coarsest raster: stride-spaced starts
    plus an edge-flush one when the stride does not divide the extent."""
    stride = patch_coarse - 2 * border_coarse
    return n_coarse // stride + (1 if n_coarse % stride else 0)


def tile_patches(h10: int, w10: int, net: dict) -> int:
    """Patches of the patch grid of an h10 x w10 tile for `net` (a net entry
    of a configuration file: patch_size, border, lr_factor)."""
    f = net["lr_factor"]
    pc, bc = net["patch_size"] // f, net["border"] // f
    return grid_cells(h10 // f, pc, bc) * grid_cells(w10 // f, pc, bc)


def conv_flops_per_px(net: dict) -> int:
    """Forward FLOPs per output pixel of the whole net."""
    f, n_l = net["feature_size"], net["num_layers"]
    cin, cout = sum(net["in_channels"]), net["in_channels"][-1]
    return 2 * 9 * (cin * f + 2 * n_l * f * f + f * cout)


def tile_model_flops(h10: int, w10: int, net: dict) -> int:
    """Model FLOPs of one entry-point call on an h10 x w10 tile."""
    return tile_patches(h10, w10, net) * net["patch_size"] ** 2 * conv_flops_per_px(net)


def b1_work(h10: int, w10: int, net: dict, precision: str, batch: int = 64):
    """(operations, bytes) kernel B1 must do for one call on an h10 x w10
    tile: every patch through all residual blocks."""
    n = tile_patches(h10, w10, net)
    p2, f, n_l = net["patch_size"] ** 2, net["feature_size"], net["num_layers"]
    flops = n * p2 * 2 * 9 * f * f * 2 * n_l * PASSES[precision]
    nbytes = n * 2 * p2 * f * 4 + math.ceil(n / batch) * n_l * 2 * (9 * f * f + f) * 4
    return flops, nbytes


def bound_s(flops: float, nbytes: float):
    """(least seconds on the card, what bounds it)."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def train_step_flops(net: dict, batch: int, hw: int) -> int:
    """Model FLOPs of one training step (forward and backward, 3x the
    forward) on a batch of hw x hw crops."""
    return 3 * batch * hw * hw * conv_flops_per_px(net)
