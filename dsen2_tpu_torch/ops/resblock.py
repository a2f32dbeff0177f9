"""Kernel B2: one DSen2 residual block, single pass, on the GPU.

Replaces the TPU kernel dsen2_tpu/ops/pallas/resblock.py::fused_resblock
(body `_resblock_kernel`), which s2net reaches at precision "default" when
the block count is odd or the height has no 8-row tile. On the card it is
the one-block instance of B1's CUDA kernels (`csrc/resblock_chain.cu`), behind
B2's own contract: single pass, w [3, 3, C, C], b [C], and H a multiple of
tile_rows with tile_rows >= 2 when there are several row tiles. The CUDA
kernels tile both axes themselves; tile_rows is kept for that contract only.
"""

from __future__ import annotations

from dsen2_tpu_torch.ops.resblock_chain import (
    check_args, count_launches, launch_blocks, resblock_plain,
)

__all__ = ["fused_resblock", "fused_resblock_plain"]


def fused_resblock_plain(x, w1, b1, w2, b2, *, scale: float = 0.1):
    """x + scale * conv2(relu(conv1(x))) in plain PyTorch, one pass."""
    return resblock_plain(x, w1, b1, w2, b2, scale=scale, passes=1)


def fused_resblock(x, w1, b1, w2, b2, *, scale: float = 0.1, tile_rows: int = 16):
    """x: [B, H, W, C]; w*: [3, 3, C, C]; b*: [C]. Returns
    x + scale * conv2(relu(conv1(x))) with SAME zero padding.

    A CUDA tensor goes through the kernels (`launch_blocks`, one block); a
    CPU tensor through `fused_resblock_plain`. The counter b2.blocks (and
    `.launches`) counts residual blocks run on the card, one per call,
    whatever the number of CUDA launches the block takes."""
    check_args(x, w1[None], b1[None], w2[None], b2[None], 1)
    h = x.shape[1]
    if h % tile_rows:
        raise ValueError(f"H={h} not a multiple of tile_rows={tile_rows}")
    if h // tile_rows > 1 and tile_rows < 2:
        raise ValueError("tile_rows must be >= 2 when the image has multiple tiles")
    if x.device.type == "cpu":
        return fused_resblock_plain(x, w1, b1, w2, b2, scale=scale)
    out = launch_blocks(x, w1[None], b1[None], w2[None], b2[None], scale, 1)
    count_launches(fused_resblock, 1)
    return out


fused_resblock.launches = 0
fused_resblock.counter = "b2.blocks"
