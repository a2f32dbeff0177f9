"""DSen2's head and tail convs on the kernel route, two CUDA kernels.

    head: x = relu(conv3x3(concat(inputs), w) + b), and x's bf16 planes
    tail: y = conv3x3(x, w, b) + inputs[-1]          (the global residual)

at the accuracy class ("high": bf16x3, "default": one bf16 pass, f32 sums),
for f32 NHWC activations. models/s2net.py takes them wherever its residual
blocks run on the kernels: the head writes the planes B1's first conv1
reads (`fused_resblock_chain(..., planes=)`), so no split pass runs between
them, and the inputs' concatenation, the tail's three-term sum and the
global residual add go. They replace no TPU kernel: the JAX package leaves
the head and tail to XLA convs. The kernels (`csrc/resblock_chain.cu`,
head_kernel and tail_kernel) are bytes-bound; their note there says what
bounds them and what the design does about it. Training keeps the class
conv (ops/conv.py), whose backward and saved planes these kernels have no
use for.

`head` and `tail` launch the kernels for CUDA tensors and run their plain
versions, `head_plain` and `tail_plain` (the class conv of ops/conv.py, as
s2net computed the head and tail before), for CPU tensors; anything else
raises. A failed build or launch raises; nothing falls back. The counters
s2net.heads and s2net.tails count the launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from dsen2_tpu_torch.ops.conv import conv3x3
from dsen2_tpu_torch.ops.resblock_chain import split_planes
from dsen2_tpu_torch.utils import profiling

__all__ = ["head", "tail", "head_plain", "tail_plain", "pack_fragments", "EDGE_CHANNELS",
           "HEAD_MAX_CIN", "TAIL_MAX_COUT"]

# The kernels' limits: the features they are instantiated for (DSen2's 128
# and VDSen2's 256; other widths keep the class conv in models/s2net.py), the
# inputs' channels together (one k16 step of the head's products) and the
# tail's outputs (one n8 block).
EDGE_CHANNELS = (128, 256)
HEAD_MAX_CIN = 16
TAIL_MAX_COUT = 8
_PASSES = {"high": 3, "default": 1}


def _passes(precision: str) -> int:
    if precision not in _PASSES:
        raise ValueError(f"the head and tail kernels take precision 'high' or 'default', "
                         f"got {precision!r}")
    return _PASSES[precision]


def head_plain(inputs: Sequence[torch.Tensor], w: torch.Tensor, b: torch.Tensor,
               precision: str, planes: bool = False
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(relu(conv3x3(concat(inputs), w, b, precision)), its split_planes if
    `planes`, else None): the head as the class conv computes it."""
    x = torch.relu(conv3x3(torch.cat(list(inputs), dim=-1), w, b, precision))
    return x, split_planes(x, _passes(precision)) if planes else None


def tail_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, residual: torch.Tensor,
               precision: str) -> torch.Tensor:
    """conv3x3(x, w, b, precision) + residual: the tail as the class conv
    computes it."""
    return conv3x3(x, w, b, precision) + residual


def pack_fragments(w: torch.Tensor, passes: int) -> torch.Tensor:
    """[3, 3, K, N] HWIO weights -> the B fragments of mma.m16n8k16 the head
    and tail kernels read: bf16 [K/16, 9, N/8, planes, 8, 4, 2, 2], K padded
    to a multiple of 16 and N to one of 8 with zeros. For k16 step kc, tap,
    8-column block nb and plane, lane 4 g + t holds its two registers b0 =
    (w[tap, 16 kc + 2t, 8 nb + g], w[tap, 16 kc + 2t + 1, 8 nb + g]) and b1
    (the same 8 rows down), as the PTX ISA lays out m16n8k16's B operand, so
    a warp reads one fragment as 256 contiguous bytes. Done once per call,
    from the tensor as given; nothing is cached."""
    k, n = w.shape[2], w.shape[3]
    kp, np_ = -(-k // 16) * 16, -(-n // 8) * 8
    wp = F.pad(w.float(), (0, np_ - n, 0, kp - k)).reshape(9, kp, np_)
    p = split_planes(wp, passes)  # [P, tap, k, n]
    # k = 16 kc + 8 h + 2 t + e, n = 8 nb + g -> [kc, tap, nb, P, g, t, h, e]
    p = p.reshape(p.shape[0], 9, kp // 16, 2, 4, 2, np_ // 8, 8)
    return p.permute(2, 1, 6, 0, 7, 4, 3, 5).contiguous()


def _check_cuda(t: torch.Tensor, name: str, device: torch.device, shape: tuple) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")


def _strides(tensors, n: int):
    """The element strides of up to n [B, H, W, C] tensors, 4 each, zeros for
    the absent ones, as the C interface takes them."""
    flat = [s for t in tensors for s in t.stride()] + [0] * (4 * (n - len(tensors)))
    return (ctypes.c_longlong * (4 * n))(*flat)


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed (error {err})")


def launch_head(inputs, w, b, passes: int, planes: bool):
    """Run the head kernel: (x [B, H, W, F] f32, x's planes [P, B, H, W, F]
    bf16 or None). The inputs are read in whatever layout they have (the
    upsampled ones arrive as permuted views: a copy would cost a pass and
    their size in device memory). Raises on what the kernel cannot take."""
    x0 = inputs[0]
    if x0.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got {x0.device}")
    f = w.shape[-1]
    cin = [t.shape[-1] for t in inputs]
    if not 1 <= len(inputs) <= 3:
        raise ValueError(f"the head kernel takes 1 to 3 inputs, got {len(inputs)}")
    if sum(cin) > HEAD_MAX_CIN:
        raise ValueError(f"the head kernel takes at most {HEAD_MAX_CIN} input channels, "
                         f"got {sum(cin)}")
    if f not in EDGE_CHANNELS:
        raise ValueError(f"the head kernel takes F in {EDGE_CHANNELS}, got F={f}")
    for i, t in enumerate(inputs):
        _check_cuda(t, f"inputs[{i}]", x0.device, (*x0.shape[:3], t.shape[-1]))
    from dsen2_tpu_torch.ops._build import load_library

    lib = load_library()
    frags = pack_fragments(w, passes)
    bias = b.float().contiguous()
    bsz, h, wd = x0.shape[:3]
    out = torch.empty((bsz, h, wd, f), dtype=torch.float32, device=x0.device)
    pl = (torch.empty((2 if passes == 3 else 1, bsz, h, wd, f), dtype=torch.bfloat16,
                      device=x0.device) if planes else None)
    ptrs = [t.data_ptr() for t in inputs] + [None] * (3 - len(inputs))
    chans = cin + [0] * (3 - len(inputs))
    with torch.cuda.device(x0.device):
        _check(lib.dsen2_head(*ptrs, *chans, _strides(inputs, 3), frags.data_ptr(),
                              bias.data_ptr(), out.data_ptr(),
                              None if pl is None else pl.data_ptr(), bsz, h, wd, f, passes,
                              torch.cuda.current_stream(x0.device).cuda_stream), "head")
    return out, pl


def launch_tail(x, w, b, residual, passes: int):
    """Run the tail kernel: conv(x, w, b) + residual, [B, H, W, C_out] f32;
    x contiguous, the residual in any layout. Raises on what the kernel
    cannot take."""
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got {x.device}")
    f, cout = x.shape[-1], w.shape[-1]
    if f not in EDGE_CHANNELS:
        raise ValueError(f"the tail kernel takes F in {EDGE_CHANNELS}, got F={f}")
    if not 1 <= cout <= TAIL_MAX_COUT:
        raise ValueError(f"the tail kernel takes 1 to {TAIL_MAX_COUT} output channels, "
                         f"got {cout}")
    _check_cuda(x, "x", x.device, x.shape)
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous NHWC starting on a 16-byte boundary")
    _check_cuda(residual, "residual", x.device, (*x.shape[:3], cout))
    from dsen2_tpu_torch.ops._build import load_library

    lib = load_library()
    frags = pack_fragments(w, passes)
    bias = b.float().contiguous()
    bsz, h, wd = x.shape[:3]
    out = torch.empty((bsz, h, wd, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _check(lib.dsen2_tail(x.data_ptr(), frags.data_ptr(), bias.data_ptr(),
                              residual.data_ptr(), _strides([residual], 1), out.data_ptr(), bsz,
                              h, wd, f, cout, passes,
                              torch.cuda.current_stream(x.device).cuda_stream), "tail")
    return out


def head(inputs: Sequence[torch.Tensor], w: torch.Tensor, b: torch.Tensor, precision: str,
         planes: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The head, x = relu(conv3x3(concat(inputs), w, b)) at `precision`
    ("high" or "default"), and with `planes` x's bf16 planes [P, B, H, W, F]
    as split_planes gives them. inputs: 1 to 3 NHWC f32 tensors of at most
    16 channels together, in any layout; w [3, 3, C_in, F]; b [F]. CUDA
    tensors go through the head kernel (F = 128 or 256), CPU tensors
    through `head_plain`."""
    passes = _passes(precision)
    cin = sum(t.shape[-1] for t in inputs)
    if tuple(w.shape[:3]) != (3, 3, cin) or tuple(b.shape) != (w.shape[-1],):
        raise ValueError(f"w must be [3, 3, {cin}, F] and b [F], got {tuple(w.shape)} and "
                         f"{tuple(b.shape)}")
    if inputs[0].device.type == "cpu":
        return head_plain(inputs, w, b, precision, planes)
    got = launch_head(inputs, w, b, passes, planes)
    profiling.count("s2net.heads")
    return got


def tail(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, residual: torch.Tensor,
         precision: str) -> torch.Tensor:
    """The tail, conv3x3(x, w, b) + residual at `precision` ("high" or
    "default"). x: [B, H, W, F] f32; w [3, 3, F, C_out]; b [C_out]; residual
    [B, H, W, C_out] f32 in any layout. CUDA tensors go through the tail
    kernel (F = 128 or 256, C_out <= 8, x contiguous), CPU tensors through
    `tail_plain`."""
    passes = _passes(precision)
    if tuple(w.shape[:3]) != (3, 3, x.shape[-1]) or tuple(b.shape) != (w.shape[-1],):
        raise ValueError(f"w must be [3, 3, {x.shape[-1]}, C_out] and b [C_out], got "
                         f"{tuple(w.shape)} and {tuple(b.shape)}")
    if x.device.type == "cpu":
        return tail_plain(x, w, b, residual, precision)
    out = launch_tail(x, w, b, residual, passes)
    profiling.count("s2net.tails")
    return out

