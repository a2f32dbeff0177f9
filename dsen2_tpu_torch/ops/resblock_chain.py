"""Kernel B1: K chained DSen2 residual blocks on the GPU.

Replaces the TPU kernel dsen2_tpu/ops/pallas/resblock_chain.py::
fused_resblock_chain (body `_chain_kernel`). Each block computes

    x <- x + scale * (conv3x3(relu(conv3x3(x) + b1)) + b2)

on NHWC [B, H, W, C] with SAME zero padding and f32 sums. The CUDA kernels are
in `csrc/resblock_chain.cu`; its header says how they tile and what bounds
them. On the card a block is two launches of one implicit-GEMM 3x3 conv
kernel (conv1 + ReLU, conv2 + residual), with the intermediate in HBM as
bf16 planes; the TPU kernel's fusion of K = 2 blocks per window is not
carried over (PERF.md states the choice).

`fused_resblock_chain` launches the kernel for a CUDA tensor and runs the
plain version, `resblock_chain_plain`, for a CPU tensor; anything else
raises. A failed build or launch raises.
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from dsen2_tpu_torch.core.device import tf32_disabled
from dsen2_tpu_torch.utils import profiling

__all__ = [
    "fused_resblock_chain", "resblock_chain_plain", "resblock_plain",
    "pack_weights", "split_planes", "KERNEL_CHANNELS", "count_launches",
    "schedule_counts", "count_tiles", "count_conv_tiles", "tile_channels",
]

# Feature counts the CUDA kernel is instantiated for (csrc/resblock_chain.cu,
# dispatch<C>): RCAN's 64, DSen2's 128 and VDSen2's 256.
KERNEL_CHANNELS = (64, 128, 256)
# The conv kernel's schedule (csrc/resblock_chain.cu, header): a cluster of
# two CTAs takes a 16 x 16 pixel x 128 channel tile (64 at C = 64); each CTA
# its 8 x 16 half.
CLUSTER_TILE = 16
CLUSTER_CTAS = 2


def tile_channels(c: int) -> int:
    """Output channels of one tile of the conv kernel: 128, or C below that."""
    return min(c, 128)


def _conv(x: torch.Tensor, w: torch.Tensor, passes: int) -> torch.Tensor:
    """SAME 3x3 conv without bias of f32 NHWC x by f32 HWIO w, TF32 off.
    passes=3 sums the three bf16x3 products, as the TPU kernel's taps do."""
    def conv(a, b):
        y = F.conv2d(a.permute(0, 3, 1, 2), b.permute(3, 2, 0, 1), padding=1)
        return y.permute(0, 2, 3, 1)

    with tf32_disabled():
        if passes == 3:
            xh, xl = split_planes(x, 3).float()
            wh, wl = split_planes(w, 3).float()
            return conv(xh, wh) + conv(xl, wh) + conv(xh, wl)
        return conv(x, w)


def resblock_plain(x, w1, b1, w2, b2, *, scale: float = 0.1, passes: int = 1) -> torch.Tensor:
    """One block in plain PyTorch. Sums run in f32; the intermediate and the
    output are rounded to x's dtype, as in the TPU kernel. passes=1 computes
    at the operands' precision (the TPU kernel's arithmetic on the CPU);
    passes=3 computes the bf16x3 products."""
    xf = x.float()
    t = torch.relu(_conv(xf, w1.float(), passes) + b1.float())
    t = t.to(x.dtype).float()
    y = _conv(t, w2.float(), passes) + b2.float()
    return (xf + scale * y).to(x.dtype)


def resblock_chain_plain(x, w1, b1, w2, b2, *, scale: float = 0.1, passes: int = 1):
    """K blocks in plain PyTorch: w1/w2 [K, 3, 3, C, C], b1/b2 [K, C]."""
    for k in range(w1.shape[0]):
        x = resblock_plain(x, w1[k], b1[k], w2[k], b2[k], scale=scale, passes=passes)
    return x


def split_planes(v: torch.Tensor, passes: int) -> torch.Tensor:
    """[planes, *v.shape] bf16: hi = bf16(v) and, for bf16x3, lo = bf16(v - hi),
    both rounded to nearest even. The kernel's split_kernel and store_split
    compute the same planes on the card."""
    vf = v.float()
    hi = vf.to(torch.bfloat16)
    if passes == 1:
        return hi[None]
    return torch.stack((hi, (vf - hi.float()).to(torch.bfloat16)))


def pack_weights(w: torch.Tensor, passes: int) -> torch.Tensor:
    """[..., 3, 3, C, C] HWIO weights -> [..., C/N, C/64, 9, planes, N, 64]
    bf16 with N = tile_channels(C), the shared-memory layout the kernel's B
    descriptor reads: for output part nh, input chunk kc and tap, one slice
    of N x 128 bytes per plane holding w[tap, 64 kc + k, N nh + n] at row n,
    16-byte group (k / 8) ^ (n % 8), element k % 8 (K-major with the
    128-byte swizzle). One bulk copy moves a (nh, kc, tap) slice with all its
    planes. Done once per wrapper call, from the tensor as given; nothing is
    cached."""
    c = w.shape[-1]
    nt = tile_channels(c)
    lead = w.shape[:-4]
    nl = len(lead)
    p = split_planes(w.reshape(*lead, 9, c // 64, 64, c // nt, nt), passes)
    # [P, ..., tap, kc, k, nh, n] -> [..., nh, kc, tap, P, n, k]
    d = [1 + i for i in range(nl)]
    p = p.permute(*d, nl + 4, nl + 2, nl + 1, 0, nl + 5, nl + 3)
    n = torch.arange(nt, device=w.device)[:, None]
    group = torch.arange(8, device=w.device)[None, :] ^ (n % 8)
    p = p.reshape(*p.shape[:-1], 8, 8)[..., n, group, :]
    return p.reshape(*p.shape[:-2], 64).contiguous()


def check_args(x, w1, b1, w2, b2, passes: int) -> None:
    """Shapes and dtypes both kernels take: x [B, H, W, C] f32 or bf16,
    w [K, 3, 3, C, C], b [K, C]; passes=3 only for f32 x."""
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got shape {tuple(x.shape)}")
    c = x.shape[-1]
    k = w1.shape[0]
    for name, t, shape in (("w1", w1, (k, 3, 3, c, c)), ("w2", w2, (k, 3, 3, c, c)),
                           ("b1", b1, (k, c)), ("b2", b2, (k, c))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    if passes == 3 and x.dtype != torch.float32:
        raise ValueError("passes=3 (the bf16x3 'high' class) requires f32 inputs")


_launch_lock = threading.Lock()


def count_launches(wrapper, n: int) -> None:
    """Add n to the wrapper's counter (utils/profiling, named by
    wrapper.counter) and to wrapper.launches, the same tally, which a caller
    may reset. Mesh shards launch from several host threads at once, and +=
    on an attribute is not atomic."""
    profiling.count(wrapper.counter, n)
    with _launch_lock:
        wrapper.launches += n


def schedule_counts(b: int, h: int, w: int, c: int, clusters: int) -> tuple[int, int]:
    """(tiles, overlapped) of one conv launch on [b, h, w, c] with `clusters`
    co-resident clusters. A tile is what one warpgroup owns: 8 x 16 pixels x
    tile_channels(c) channels, one CTA's half of a cluster tile. The launch runs
    n = min(clusters, T) clusters over the T cluster tiles; cluster i takes
    tiles i, i + n, ..., and in each of its two CTAs the warpgroups take them
    in turn, so every tile but a CTA's last has its epilogue beside the other
    warpgroup's mainloop: overlapped = 2 (T - n)."""
    steps = b * -(-h // CLUSTER_TILE) * -(-w // CLUSTER_TILE) * (c // tile_channels(c))
    n = min(clusters, steps)
    return CLUSTER_CTAS * steps, CLUSTER_CTAS * (steps - n)


def count_tiles(lib, shape, passes: int, f32: bool, nblocks: int) -> None:
    """Add the tiles of K blocks' convs (conv1 and conv2 each) on x of
    `shape` to the counters b1.tiles and b1.tiles_overlapped, from the launch
    geometry: the library reports how many clusters of each instantiation fit
    on the current device (it reads that once per device and instantiation;
    nothing is read back from the device). Raises if none fits."""
    count_conv_tiles(lib, shape, passes, ((0, 0, nblocks), (1, 0 if f32 else 1, nblocks)))


def count_conv_tiles(lib, shape, passes: int, convs) -> None:
    """Add to b1.tiles and b1.tiles_overlapped the tiles of `convs`, a
    sequence of (epilogue, dtype, number of launches) of the conv kernel on
    x of `shape` (epilogue 0: ReLU, 1: residual, 2: pooling), from the launch
    geometry alone. Raises if no cluster of an instantiation fits."""
    bsz, h, w, c = shape
    tiles = overlapped = 0
    for epilogue, dtype, n in convs:
        clusters = lib.dsen2_conv3x3_clusters(c, passes, dtype, epilogue)
        if clusters <= 0:
            raise RuntimeError(f"epilogue {epilogue}: no cluster fits the device "
                               f"(error {clusters})")
        t, o = schedule_counts(bsz, h, w, c, clusters)
        tiles += n * t
        overlapped += n * o
    profiling.count("b1.tiles", tiles)
    profiling.count("b1.tiles_overlapped", overlapped)


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed (error {err})")


def launch_blocks(x, w1, b1, w2, b2, scale: float, passes: int) -> torch.Tensor:
    """Run K blocks on the card: x [B, H, W, C]; w [K, 3, 3, C, C]; b [K, C].
    Packs all K blocks' weights in one call, then launches, per block, the
    conv kernel twice (conv1 with the ReLU epilogue, conv2 with the residual
    one). f32 x first goes through split_kernel once; each conv2 but the last
    writes the planes the next block's conv1 reads. Adds the launches' tiles
    to b1.tiles and b1.tiles_overlapped (`count_tiles`). Returns a new tensor;
    raises if the kernels cannot take the arguments or a launch fails."""
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous NHWC starting on a 16-byte boundary")
    c = x.shape[-1]
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"the kernel takes C in {KERNEL_CHANNELS}, got C={c}")
    if c < 128 and x.dtype != torch.float32:
        raise ValueError(f"the kernel takes C={c} for float32 activations only")
    for t in (w1, b1, w2, b2):
        if t.device != x.device:
            raise ValueError(f"weights on {t.device}, activations on {x.device}")
    from dsen2_tpu_torch.ops._build import load_library

    lib = load_library()
    packed = pack_weights(torch.stack((w1, w2)), passes)  # [2, K, ...]
    bias = torch.stack((b1, b2)).float().contiguous()      # [2, K, C]
    bsz, h, w, _ = x.shape
    f32 = x.dtype == torch.float32
    nplanes = 2 if passes == 3 else 1
    stream = torch.cuda.current_stream(x.device).cuda_stream
    t = torch.empty((nplanes, *x.shape), dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        if f32:
            planes = torch.empty_like(t)
            _check(lib.dsen2_split_planes(x.data_ptr(), planes.data_ptr(), x.numel(), passes,
                                          stream), "split")
        else:
            planes = x
        resid = x
        nblocks = w1.shape[0]
        for k in range(nblocks):
            _check(lib.dsen2_conv3x3(planes.data_ptr(), packed[0, k].data_ptr(),
                                     bias[0, k].data_ptr(), None, None, t.data_ptr(),
                                     bsz, h, w, c, 1.0, passes, 0, 0, stream), "conv1")
            # bf16 activations are their own single plane; f32 ones get theirs
            # from conv2's epilogue, except after the last block.
            nxt = planes.data_ptr() if f32 and k + 1 < nblocks else None
            _check(lib.dsen2_conv3x3(t.data_ptr(), packed[1, k].data_ptr(),
                                     bias[1, k].data_ptr(), resid.data_ptr(), out.data_ptr(),
                                     nxt, bsz, h, w, c, float(scale), passes,
                                     0 if f32 else 1, 1, stream), "conv2")
            resid = out  # blocks after the first update out in place
            if not f32:
                planes = out
        count_tiles(lib, x.shape, passes, f32, w1.shape[0])
    return out


def fused_resblock_chain(x, w1, b1, w2, b2, *, scale: float = 0.1, passes: int = 1):
    """Apply K chained resblocks: x [B, H, W, C]; w1/w2 [K, 3, 3, C, C];
    b1/b2 [K, C]. passes=1 is one bf16 pass (the "default" class), passes=3
    bf16x3 (the "high" class, f32 x only).

    A CUDA tensor goes through the kernels (`launch_blocks`), any H and W; a
    CPU tensor through `resblock_chain_plain`. The counter b1.blocks (and
    `.launches`) counts residual blocks run on the card, K per call, whatever
    the number of CUDA launches a block takes (two convs, plus one split per
    call for f32 x)."""
    check_args(x, w1, b1, w2, b2, passes)
    if x.device.type == "cpu":
        return resblock_chain_plain(x, w1, b1, w2, b2, scale=scale, passes=passes)
    x = launch_blocks(x, w1, b1, w2, b2, scale, passes)
    count_launches(fused_resblock_chain, w1.shape[0])
    return x


fused_resblock_chain.launches = 0
fused_resblock_chain.counter = "b1.blocks"
