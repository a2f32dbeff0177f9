"""RCAN's channel attention and its residual body on the GPU.

A residual channel-attention block (RCAB, models/rcan.py) is

    y = conv2(relu(conv1(x)));  s = sigmoid(Wu relu(Wd mean_hw(y) + bd) + bu)
    x <- x + s * y

The gate s depends on all of an image's y, so the block cannot end in B1's
fused residual epilogue. On the card (`rcan_body`) a block is three
launches: conv1 with B1's ReLU epilogue (t as bf16 planes), conv2 with the
pooling epilogue (y in f32 and each warp's per-channel sums of y over its
pixels of a tile), and the gate kernel (csrc/resblock_chain.cu,
ca_gate_kernel), which adds the sums in a fixed order, computes s in f32 and
writes x + s * y with the bf16 planes the next conv1 reads. The conv at the
end of each residual group and the long skip's conv are B1's residual
epilogue at scale 1.0. No atomics: the same call gives the same bits.

The JAX package has no RCAN, so these replace no TPU kernel. Each wrapper
launches on a CUDA tensor and runs its plain version on a CPU tensor;
anything else raises, and a failed launch raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dsen2_tpu_torch.core.device import tf32_disabled
from dsen2_tpu_torch.ops.resblock_chain import (
    CLUSTER_CTAS, CLUSTER_TILE, KERNEL_CHANNELS, _check, _conv, count_conv_tiles, pack_weights,
    split_planes,
)
from dsen2_tpu_torch.utils import profiling

__all__ = [
    "channel_scale", "ca_gate_plain", "pool_rows", "pool_sums_plain", "ca_gate",
    "rcan_body", "rcan_body_plain",
]

# Warps of a consumer warpgroup of the conv kernel; each writes one row of
# per-channel sums per tile.
_WARPS = 4


def channel_scale(mean: torch.Tensor, wd, bd, wu, bu) -> torch.Tensor:
    """s [B, C] = sigmoid(relu(mean @ wd + bd) @ wu + bu) in f32, TF32 off:
    mean [B, C], wd [C, R], bd [R], wu [R, C], bu [C] (RCAN's two 1x1 convs)."""
    with tf32_disabled():
        z = torch.relu(mean.float() @ wd.float() + bd.float())
        return torch.sigmoid(z @ wu.float() + bu.float())


def ca_gate_plain(x: torch.Tensor, y: torch.Tensor, wd, bd, wu, bu) -> torch.Tensor:
    """x + s * y with s = channel_scale of y's mean over each image [B, H, W, C]."""
    s = channel_scale(y.float().mean(dim=(1, 2)), wd, bd, wu, bu)
    return x + s.to(y.dtype)[:, None, None, :] * y


def pool_rows(h: int, w: int) -> int:
    """Rows of per-warp sums the pooling epilogue writes per image: for each
    16 x 16 tile, each CTA of the cluster and each warp of a warpgroup."""
    return -(-h // CLUSTER_TILE) * -(-w // CLUSTER_TILE) * CLUSTER_CTAS * _WARPS


def pool_sums_plain(y: torch.Tensor) -> torch.Tensor:
    """The pooling epilogue's sums in its layout, [B, pool_rows, C] f32: row
    ((tile * 2 + rank) * 4 + warp) sums y over rows 16 ty + 8 rank + warp and
    16 ty + 8 rank + 4 + warp, columns 16 tx ... 16 tx + 15, of tile (ty, tx),
    tiles row-major; pixels outside the image add nothing."""
    b, h, w, c = y.shape
    ty, tx = -(-h // CLUSTER_TILE), -(-w // CLUSTER_TILE)
    p = F.pad(y.float(), (0, 0, 0, tx * CLUSTER_TILE - w, 0, ty * CLUSTER_TILE - h))
    # rows of a tile: (rank, half, warp); columns: 16
    p = p.reshape(b, ty, CLUSTER_CTAS, 2, _WARPS, tx, CLUSTER_TILE, c).sum(dim=(3, 6))
    return p.permute(0, 1, 4, 2, 3, 5).reshape(b, pool_rows(h, w), c)


def _gate_from_pool(x, y, pool, wd, bd, wu, bu):
    """The gate kernel's arithmetic in plain PyTorch: s from the pooled sums."""
    hw = y.shape[1] * y.shape[2]
    s = channel_scale(pool.sum(dim=1) / hw, wd, bd, wu, bu)
    return x + s[:, None, None, :] * y


def _launch_gate(lib, x, y, pool, wd, bd, wu, bu, out, planes, passes, stream):
    b, h, w, c = x.shape
    _check(lib.dsen2_ca_gate(x.data_ptr(), y.data_ptr(), pool.data_ptr(), wd.data_ptr(),
                             bd.data_ptr(), wu.data_ptr(), bu.data_ptr(), out.data_ptr(),
                             planes.data_ptr(), b, h, w, c, wd.shape[-1], passes, stream), "gate")


def ca_gate(x, y, pool, wd, bd, wu, bu, *, passes: int):
    """One gate: (x + s * y, its bf16 planes [planes, B, H, W, C]) with s
    from `pool`, the pooling epilogue's sums of y ([B, pool_rows, C]). f32
    x, y and pool. A CUDA tensor runs the gate kernel; a CPU one its plain
    version. The counter rcan.gates counts launches."""
    if x.dtype != torch.float32 or y.dtype != torch.float32 or x.shape != y.shape:
        raise ValueError("x and y must be float32 tensors of one shape")
    if x.device.type == "cpu":
        out = _gate_from_pool(x, y, pool, wd, bd, wu, bu)
        return out, split_planes(out, passes)
    from dsen2_tpu_torch.ops._build import load_library

    lib = load_library()
    x, y, pool = x.contiguous(), y.contiguous(), pool.float().contiguous()
    wd, bd, wu, bu = (t.float().contiguous() for t in (wd, bd, wu, bu))
    out = torch.empty_like(x)
    planes = torch.empty((2 if passes == 3 else 1, *x.shape), dtype=torch.bfloat16,
                         device=x.device)
    with torch.cuda.device(x.device):
        _launch_gate(lib, x, y, pool, wd, bd, wu, bu, out, planes, passes,
                     torch.cuda.current_stream(x.device).cuda_stream)
    profiling.count("rcan.gates")
    return out, planes


def rcan_body_plain(x: torch.Tensor, p: dict, *, passes: int) -> torch.Tensor:
    """RCAN's body, head output to long skip, as the kernels compute it, in
    plain PyTorch: convs in f32 with TF32 off (passes=3: the bf16x3
    products), the gate from the pooled sums."""
    blk, ca, grp, lsc = p["blocks"], p["ca"], p["groups"], p["lsc"]
    n_g, n_b = blk["w1"].shape[:2]
    xf = x.float()
    g_in = xf
    for g in range(n_g):
        s = g_in
        for k in range(n_b):
            t = torch.relu(_conv(s, blk["w1"][g, k].float(), passes) + blk["b1"][g, k].float())
            y = _conv(t, blk["w2"][g, k].float(), passes) + blk["b2"][g, k].float()
            s = _gate_from_pool(s, y, pool_sums_plain(y), ca["wd"][g, k], ca["bd"][g, k],
                                ca["wu"][g, k], ca["bu"][g, k])
        g_in = g_in + (_conv(s, grp["w"][g].float(), passes) + grp["b"][g].float())
    return xf + (_conv(g_in, lsc["w"].float(), passes) + lsc["b"].float())


def rcan_body(x: torch.Tensor, p: dict, *, passes: int) -> torch.Tensor:
    """RCAN's body on f32 x [B, H, W, C] (the head's output): G residual
    groups of B RCABs, each group closed by a conv and its skip, then the
    long skip's conv and F_0. p holds "blocks" {w1, b1, w2, b2: [G, B, ...]},
    "ca" {wd, bd, wu, bu: [G, B, ...]}, "groups" {w, b: [G, ...]} and "lsc"
    {w, b}. A CPU tensor runs `rcan_body_plain`; a CUDA one the kernels (see
    the module's doc). Counters: rcan.blocks (RCABs run on the card, one
    launch of the pooling epilogue each), rcan.convs (launches of the conv
    kernel with the ReLU or the residual epilogue), rcan.gates (gate
    launches), and the convs' tiles in b1.tiles and b1.tiles_overlapped.
    Returns a new tensor."""
    if x.dim() != 4 or x.dtype != torch.float32:
        raise ValueError(f"x must be float32 [B, H, W, C], got {x.dtype} {tuple(x.shape)}")
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    if x.device.type == "cpu":
        return rcan_body_plain(x, p, passes=passes)
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernels need a CUDA tensor, got {x.device}")
    c = x.shape[-1]
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"the kernels take C in {KERNEL_CHANNELS}, got C={c}")
    from dsen2_tpu_torch.ops._build import load_library

    lib = load_library()
    blk, ca, grp, lsc = p["blocks"], p["ca"], p["groups"], p["lsc"]
    n_g, n_b = blk["w1"].shape[:2]
    x = x.contiguous()
    packed = pack_weights(torch.stack((blk["w1"], blk["w2"])), passes)     # [2, G, B, ...]
    bias = torch.stack((blk["b1"], blk["b2"])).float().contiguous()        # [2, G, B, C]
    g_packed = pack_weights(torch.cat((grp["w"], lsc["w"][None])), passes)  # [G + 1, ...]
    g_bias = torch.cat((grp["b"], lsc["b"][None])).float().contiguous()
    wd, bd, wu, bu = (ca[k].float().contiguous() for k in ("wd", "bd", "wu", "bu"))
    bsz, h, w, _ = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    state = torch.empty((2 if passes == 3 else 1, *x.shape), dtype=torch.bfloat16,
                        device=x.device)  # planes of the state each conv1 reads
    spare = torch.empty_like(state)       # t, then the next group's planes
    y, s, out = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    pool = torch.empty((bsz, pool_rows(h, w), c), dtype=torch.float32, device=x.device)

    def conv(src, k, b, epilogue, resid=None, dst=None, planes=None):
        _check(lib.dsen2_conv3x3(src.data_ptr(), k.data_ptr(), b.data_ptr(),
                                 None if resid is None else resid.data_ptr(),
                                 None if dst is None else dst.data_ptr(),
                                 None if planes is None else planes.data_ptr(),
                                 bsz, h, w, c, 1.0, passes, 0, epilogue, stream),
               "group conv" if epilogue else "conv1")

    with torch.cuda.device(x.device):
        _check(lib.dsen2_split_planes(x.data_ptr(), state.data_ptr(), x.numel(), passes,
                                      stream), "split")
        g_in = x  # F_0 for the first group and the long skip
        for g in range(n_g):
            for k in range(n_b):
                conv(state, packed[0, g, k], bias[0, g, k], 0, planes=spare)
                _check(lib.dsen2_conv3x3_pool(spare.data_ptr(), packed[1, g, k].data_ptr(),
                                              bias[1, g, k].data_ptr(), y.data_ptr(),
                                              pool.data_ptr(), bsz, h, w, c, passes, stream),
                       "conv2")
                # The first block reads the group's input; the others update s
                # in place.
                _launch_gate(lib, g_in if k == 0 else s, y, pool, wd[g, k], bd[g, k], wu[g, k],
                             bu[g, k], s, state, passes, stream)
            # F_g = F_{g-1} + conv(s): the residual epilogue at scale 1, its
            # planes into the spare buffer, which the next group reads.
            conv(state, g_packed[g], g_bias[g], 1, resid=g_in, dst=out, planes=spare)
            state, spare = spare, state
            g_in = out
        conv(state, g_packed[n_g], g_bias[n_g], 1, resid=x, dst=out)
        count_conv_tiles(lib, x.shape, passes,
                         ((0, 0, n_g * n_b), (2, 0, n_g * n_b), (1, 0, n_g + 1)))
    profiling.count("rcan.blocks", n_g * n_b)
    profiling.count("rcan.convs", n_g * n_b + n_g + 1)
    profiling.count("rcan.gates", n_g * n_b)
    return out
