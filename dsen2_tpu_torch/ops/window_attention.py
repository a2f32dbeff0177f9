"""HAT's window attention: shifted-window self-attention and overlapping
cross-attention, on the GPU and in plain PyTorch.

Both read q, k and v from one qkv tensor [B, H, W, 3C] (q = channels [0, C),
k = [C, 2C), v = [2C, 3C); head j = channels [jd, (j + 1) d) of each, d =
C / heads) and write [B, H, W, C], each head's d channels in its place. Per
M x M window of queries (M^2 of them, row-major) and per head j:

    A_j = softmax((q_j / sqrt(d)) k_j^T + T[j, rpi] + mask);  o_j = A_j v_j

  self-attention (overlap = 0): keys and values are the query window's own
    M^2 pixels; with shift s > 0 the windows are those of the image rolled
    by -s on both axes, and the output is rolled back by +s (so a query at
    rolled (r, c) is the pixel ((r + s) mod H, (c + s) mod W)).
    rpi = (y_q - y_k + M - 1)(2M - 1) + (x_q - x_k + M - 1); the mask, only
    where s > 0, labels each pixel of the rolled image by its row band [0,
    H - M), [H - M, H - s), [H - s, H) times the same bands of columns, and
    is -100.0 (HAT's value) where query and key labels differ, else 0.
  overlapping cross-attention (overlap = M_o > M): keys and values of the
    window at (M wy, M wx) are the M_o x M_o block of pixels at rows and
    columns [M wy - (M_o - M) / 2, ...), zero vectors outside the image
    (nn.Unfold's zero padding: they take part in the softmax, unmasked).
    rpi = (y_k - y_q + M - 1)(M + M_o - 1) + (x_k - x_q + M - 1) in local
    coordinates (query 0..M-1, key 0..M_o-1).

T is the bias table [entries, heads]. On a CUDA tensor `window_attention`
launches csrc/window_attention.cu's kernel, which reads q, k and v by window
coordinates (no roll or partition copies), adds the bias and mask in-kernel,
keeps the scores on the chip and sums in f32; its products follow the
accuracy class (passes=3: bf16x3, passes=1: one bf16 pass). On a CPU tensor
it runs `window_attention_plain` at the same class. The JAX package has no
attention, so the kernel replaces no TPU kernel; the counter hat.attn counts
its launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dsen2_tpu_torch.core.device import tf32_disabled
from dsen2_tpu_torch.utils import profiling

__all__ = ["window_attention", "window_attention_plain", "relative_index", "shift_mask",
           "KERNEL_WINDOW", "KERNEL_OVERLAPS"]

MASK_VALUE = -100.0
# What the kernel takes: M = 16, self-attention or M_o = 24, head size <= 32.
KERNEL_WINDOW = 16
KERNEL_OVERLAPS = (0, 24)
_MAX_HEAD = 32
# Score elements one chunk of the plain version holds at once.
_CHUNK_SCORES = 1 << 27


def relative_index(window: int, overlap: int = 0) -> torch.Tensor:
    """[M^2, N_k] int64: the bias table's row for each query and key
    (N_k = M^2, or M_o^2 with overlap = M_o)."""
    side = overlap or window
    qy, qx = torch.meshgrid(torch.arange(window), torch.arange(window), indexing="ij")
    ky, kx = torch.meshgrid(torch.arange(side), torch.arange(side), indexing="ij")
    dy = qy.reshape(-1, 1) - ky.reshape(1, -1)
    dx = qx.reshape(-1, 1) - kx.reshape(1, -1)
    if overlap:
        return (window - 1 - dy) * (window + overlap - 1) + (window - 1 - dx)
    return (dy + window - 1) * (2 * window - 1) + (dx + window - 1)


def shift_mask(h: int, w: int, window: int, shift: int) -> torch.Tensor:
    """[nW, M^2, M^2] float32: 0 where query and key of a window of the
    rolled image share a label, MASK_VALUE where they do not."""
    def bands(n):
        lab = torch.zeros(n, dtype=torch.int64)
        lab[n - window:n - shift] = 1
        lab[n - shift:] = 2
        return lab

    lab = (bands(h)[:, None] * 3 + bands(w)[None, :]).reshape(h // window, window, w // window,
                                                               window)
    lab = lab.permute(0, 2, 1, 3).reshape(-1, window * window)
    return torch.where(lab[:, :, None] == lab[:, None, :], 0.0, MASK_VALUE)


def _windows(t: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nW, M^2, C], windows and their pixels row-major."""
    b, h, w, c = t.shape
    t = t.reshape(b, h // window, window, w // window, window, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(-1, window * window, c)


def _key_windows(t: torch.Tensor, window: int, overlap: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nW, M_o^2, C]: each window's overlapping block,
    zero outside the image."""
    pad = (overlap - window) // 2
    t = torch.nn.functional.pad(t, (0, 0, pad, pad, pad, pad))
    t = t.unfold(1, overlap, window).unfold(2, overlap, window)  # [B, nWy, nWx, C, Mo, Mo]
    return t.permute(0, 1, 2, 4, 5, 3).reshape(-1, overlap * overlap, t.shape[3])


def _split(v: torch.Tensor, passes: int):
    hi = v.to(torch.bfloat16).to(v.dtype)
    return hi, (v - hi).to(torch.bfloat16).to(v.dtype) if passes == 3 else None


def _product(a: torch.Tensor, b: torch.Tensor, passes: Optional[int]) -> torch.Tensor:
    """a @ b in a's dtype (passes None), or at the class: the bf16 planes'
    products, each exact in f32, summed in f32."""
    if passes is None:
        return a @ b
    ah, al = _split(a, passes)
    bh, bl = _split(b, passes)
    out = ah @ bh
    return out + al @ bh + ah @ bl if passes == 3 else out


def _plain_chunk(qkv, table, heads, window, shift, overlap, passes):
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    if shift:
        qkv = torch.roll(qkv, (-shift, -shift), (1, 2))
    q = _windows(qkv[..., :c], window)
    if overlap:
        k = _key_windows(qkv[..., c:2 * c], window, overlap)
        v = _key_windows(qkv[..., 2 * c:], window, overlap)
    else:
        k, v = _windows(qkv[..., c:2 * c], window), _windows(qkv[..., 2 * c:], window)
    n, nq, nk = q.shape[0], q.shape[1], k.shape[1]
    q = q.reshape(n, nq, heads, d).transpose(1, 2) * d ** -0.5
    k = k.reshape(n, nk, heads, d).transpose(1, 2)
    v = v.reshape(n, nk, heads, d).transpose(1, 2)
    idx = relative_index(window, overlap).to(qkv.device)
    s = _product(q, k.transpose(-2, -1), passes) + table.to(q.dtype)[idx].permute(2, 0, 1)
    if shift:
        mask = shift_mask(h, w, window, shift).to(device=q.device, dtype=q.dtype)
        s = (s.view(b, -1, heads, nq, nk) + mask[None, :, None]).view(n, heads, nq, nk)
    o = _product(torch.softmax(s, dim=-1), v, passes)
    o = o.transpose(1, 2).reshape(b, h // window, w // window, window, window, c)
    o = o.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)
    return torch.roll(o, (shift, shift), (1, 2)) if shift else o


def window_attention_plain(qkv: torch.Tensor, table: torch.Tensor, *, heads: int, window: int,
                           shift: int = 0, overlap: int = 0,
                           passes: Optional[int] = None) -> torch.Tensor:
    """The attention of the module's doc in plain PyTorch, scores
    materialised a few images at a time: products in qkv's dtype with TF32
    off (passes None) or at the class (3: bf16x3, 1: one bf16 pass, f32
    sums), the softmax in qkv's dtype."""
    b, h, w, c3 = qkv.shape
    if h % window or w % window:
        raise ValueError(f"the window {window} must divide {h} x {w}")
    if overlap and shift:
        raise ValueError("overlapping cross-attention takes no shift")
    nk = (overlap or window) ** 2
    per_image = (h // window) * (w // window) * heads * window * window * nk
    step = max(1, _CHUNK_SCORES // per_image)
    out = qkv.new_empty((b, h, w, c3 // 3))
    with tf32_disabled():
        for i in range(0, b, step):
            out[i:i + step] = _plain_chunk(qkv[i:i + step], table, heads, window, shift,
                                           overlap, passes)
    return out


def _declare(lib):
    """The library's entry point's argument and return types."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dsen2_window_attention.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, p]
    lib.dsen2_window_attention.restype = i
    return lib


def window_attention(qkv: torch.Tensor, table: torch.Tensor, *, heads: int, window: int,
                     shift: int = 0, overlap: int = 0, passes: int) -> torch.Tensor:
    """The attention of the module's doc at the class `passes` (3: bf16x3,
    1: one bf16 pass) on f32 qkv [B, H, W, 3C] and table [entries, heads].
    A CUDA tensor runs the kernel (window 16, overlap 0 or 24, head size
    even and at most 32, H and W multiples of 16); a CPU one the plain
    version. Returns a new [B, H, W, C] tensor."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    if qkv.dim() != 4 or qkv.dtype != torch.float32 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"qkv must be float32 [B, H, W, 3C] with heads | C, got {qkv.dtype} "
                         f"{tuple(qkv.shape)}")
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, table, heads=heads, window=window, shift=shift,
                                      overlap=overlap, passes=passes)
    if qkv.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got {qkv.device}")
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    if (window != KERNEL_WINDOW or overlap not in KERNEL_OVERLAPS or d > _MAX_HEAD or d % 2
            or h % window or w % window or not 0 <= shift < window or (overlap and shift)):
        raise ValueError(f"the kernel takes window {KERNEL_WINDOW}, overlap in "
                         f"{KERNEL_OVERLAPS} without shift, an even head size <= {_MAX_HEAD} "
                         f"and H, W multiples of the window; got window {window}, overlap "
                         f"{overlap}, shift {shift}, head size {d}, {h} x {w}")
    want = ((2 * window - 1) if not overlap else (window + overlap - 1)) ** 2
    if tuple(table.shape) != (want, heads):
        raise ValueError(f"table must be [{want}, {heads}], got {tuple(table.shape)}")
    from dsen2_tpu_torch.ops._build import load_library

    lib = load_library("window_attention", _declare)
    qkv = qkv.contiguous()
    table = table.to(device=qkv.device, dtype=torch.float32).contiguous()
    out = torch.empty((b, h, w, c), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = lib.dsen2_window_attention(
            qkv.data_ptr(), table.data_ptr(), out.data_ptr(), b, h, w, c, heads, window, overlap,
            shift, passes, torch.cuda.current_stream(qkv.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window attention launch failed (error {err})")
    profiling.count("hat.attn")
    return out

