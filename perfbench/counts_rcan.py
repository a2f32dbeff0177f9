"""Operations and bytes of RCAN's work in a cell, counted from its shapes.

As perfbench/counts.py does for DSen2, and never from the program's
counters. A net entry of a configuration gives RCAN's own option names:
n_resgroups (G), n_resblocks (B per group), n_feats (C), reduction, and the
patch geometry (lr_factor, patch_size, border).

- Model FLOPs: 2 * 9 * C_in * C_out per pixel for every 3x3 conv (the head,
  G (2 B + 1) + 1 body convs of C -> C, the tail), over every pixel of every
  patch of the patch grid. The attention's 1x1 convs act on one pooled
  vector per patch and are left out (under 1e-5 of the rest).
- The body's convs (kernel B1's conv kernel at C = 64): their bf16 products
  times the passes of the accuracy class, against the body's input read
  once, its output written once (f32) and every body conv's f32 weights
  once per call of `batch` patches.
- The gate (ca_gate_kernel): x and y read and x + s * y written, f32: 12 C
  bytes per patch pixel per RCAB.
"""

from __future__ import annotations

import math

from perfbench.counts import PASSES, tile_patches


def body_convs(net: dict) -> int:
    """3x3 convs of C -> C in the body: two per RCAB, one per group, the
    long skip's."""
    return net["n_resgroups"] * (2 * net["n_resblocks"] + 1) + 1


def rcabs(net: dict) -> int:
    return net["n_resgroups"] * net["n_resblocks"]


def conv_flops_per_px(net: dict) -> int:
    """Forward FLOPs per output pixel of the whole net."""
    c = net["n_feats"]
    cin, cout = sum(net["in_channels"]), net["in_channels"][-1]
    return 2 * 9 * (cin * c + body_convs(net) * c * c + c * cout)


def tile_model_flops(h10: int, w10: int, net: dict) -> int:
    """Model FLOPs of one entry-point call on an h10 x w10 tile."""
    return tile_patches(h10, w10, net) * net["patch_size"] ** 2 * conv_flops_per_px(net)


def body_conv_work(h10: int, w10: int, net: dict, precision: str, batch: int = 64):
    """(operations, bytes) the body's convs must do for one call."""
    n = tile_patches(h10, w10, net)
    p2, c, k = net["patch_size"] ** 2, net["n_feats"], body_convs(net)
    flops = n * p2 * 2 * 9 * c * c * k * PASSES[precision]
    nbytes = n * 2 * p2 * c * 4 + math.ceil(n / batch) * k * (9 * c * c + c) * 4
    return flops, nbytes


def gate_bytes(h10: int, w10: int, net: dict) -> int:
    """Bytes the gates of one call must move."""
    n = tile_patches(h10, w10, net)
    return n * net["patch_size"] ** 2 * 12 * net["n_feats"] * rcabs(net)
