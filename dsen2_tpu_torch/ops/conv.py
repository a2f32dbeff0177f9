"""The plain 3x3 conv of the port at an accuracy class, forward and backward.

The counterpart of the XLA convs of dsen2_tpu/models/s2net.py:101-106 at
Precision HIGHEST, HIGH or DEFAULT, and of their VJPs, whose transpose convs
run at the same precision. Activations are NHWC and kernels HWIO; every conv
runs on channels-last views of them, so cuDNN needs no layout transposes.

  "highest"  true f32, TF32 off.
  "high"     bf16x3: xh = bf16(x), xl = bf16(x - xh), the same for w;
             y = xh*wh + xl*wh + xh*wl with f32 sums (for the narrow-input
             head as one conv of concatenated planes, for the narrow-output
             tail with the xh products as one conv of concatenated weights).
  "default"  one pass: bf16(x) * bf16(w) with f32 sums and f32 output.

The backward splits the incoming gradient g the same way:

  "high"     dx = gh*'wh + gl*'wh + gh*'wl,   dw = xh.gh + xh.gl + xl.gh
  "default"  dx = gh*'wh,                     dw = xh.gh

(the tail's dx at "high" as one dgrad of concatenated planes), and
db = sum(g) in f32. The planes are f32 tensors holding bf16 values, and
their convs run in TF32 (core/device.py::tf32_for_bf16_operands), which
rounds none of them, so each product is exact in f32. cuDNN's sums are not
all f32-grade, though: on an H100 its TF32 wgrad over a whole 96 x 96 batch
strays up to 1.3e-3 x max|dw| from float64, and its f32 one (TF32 off) up to
2e-4, while over at most _WGRAD_ROWS pixels per call both stay near 5e-6
(PERF.md §6, scripts/diagnose_wgrad_torch.py). So the wgrad runs over batch
chunks of at most that many pixels, and the chunks' f32 results are added.
The forward keeps its planes of x and w for the backward, which then splits
only g (x's low plane only while w's gradient is wanted; at "highest" it
keeps x and w).

On the card every f32 operand is split in one pass
(csrc/resblock_chain.cu::plane_kernel, store_split's rounding) that reads v
once and writes both planes, bit-equal to the plain split that CPU tensors
take; an operand not dense in memory is copied dense first. The counters
conv.plane_passes (launches of that pass) and conv.planes_kept (backward
calls that took the forward's planes) count it.

Tensors of another dtype than f32 (compute_dtype="bfloat16") take a plain
conv in their own dtype at every class, as in the JAX package.
"""

from __future__ import annotations

import contextvars
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from dsen2_tpu_torch.core.device import tf32_disabled, tf32_for_bf16_operands
from dsen2_tpu_torch.utils import profiling

__all__ = ["conv3x3", "PRECISIONS"]

PRECISIONS = ("highest", "high", "default")

# Pixels (batch x H x W) one cuDNN wgrad call of the planes reduces over.
_WGRAD_ROWS = 32768


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> an NCHW view with channels-last strides (no copy)."""
    return x.permute(0, 3, 1, 2)


def _oihw(w: torch.Tensor) -> torch.Tensor:
    """HWIO -> OIHW with channels-last strides (OHWI in memory)."""
    return w.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)


def _plain_planes(v: torch.Tensor, precision: str) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(hi, lo) f32 tensors of bf16 values, rounded to nearest even, in v's
    layout: hi = bf16(v), lo = bf16(v - hi) at "high", None at "default"
    (ops/resblock_chain.py::split_planes computes the same planes)."""
    hi = v.to(torch.bfloat16).float()
    if precision != "high":
        return hi, None
    return hi, (v - hi).to(torch.bfloat16).float()


def _dense(v: torch.Tensor) -> bool:
    """Whether v's elements fill one block of memory, in some dimension order."""
    return v.permute(sorted(range(v.dim()), key=v.stride, reverse=True)).is_contiguous()


def _kernel_planes(v: torch.Tensor, precision: str) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """_plain_planes of a dense f32 CUDA tensor in one launch of the plane
    pass, each plane laid out in memory as v is."""
    from dsen2_tpu_torch.ops._build import load_library

    lib = load_library()
    hi = torch.empty_strided(v.shape, v.stride(), dtype=torch.float32, device=v.device)
    lo = torch.empty_like(hi) if precision == "high" else None
    with torch.cuda.device(v.device):
        err = lib.dsen2_class_planes(
            v.data_ptr(), hi.data_ptr(), None if lo is None else lo.data_ptr(), v.numel(),
            1 if lo is None else 3, torch.cuda.current_stream(v.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"plane pass launch failed (error {err})")
    profiling.count("conv.plane_passes")
    return hi, lo


def _planes(v: torch.Tensor, precision: str) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """_plain_planes(v, precision); on the card, for f32 v, from the plane
    pass, after a dense copy of v (laid out as _plain_planes lays out its
    planes) where v is not dense in memory."""
    if v.is_cuda and v.dtype == torch.float32:
        return _kernel_planes(v if _dense(v) else v.clone(), precision)
    return _plain_planes(v, precision)


def _operand_planes(x: torch.Tensor, w: torch.Tensor, precision: str) -> tuple:
    """(xh, xl, wh, wl): the planes of NHWC x and HWIO w as the convs take
    them (channels-last NCHW and OIHW)."""
    return (*_planes(_nchw(x), precision), *_planes(_oihw(w), precision))


def _forward(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
             precision: str, planes: Optional[tuple]) -> torch.Tensor:
    """y = conv(x, w) + b at the class; b is added in cuDNN's epilogue.
    `planes`: x's and w's (_operand_planes), None at "highest"."""
    if precision == "highest":
        with tf32_disabled():
            y = F.conv2d(_nchw(x), _oihw(w), b, padding=1)
    else:
        xh, xl, wh, wl = planes
        with tf32_for_bf16_operands():
            if xl is None:
                y = F.conv2d(xh, wh, b, padding=1)
            elif xh.shape[1] < wh.shape[0]:
                # Fewer input than output channels (the head): one conv of the
                # concatenated planes, [xh|xl|xh] by [wh|wh|wl], sums the three
                # products in its accumulator, sparing two adds of the wide
                # output. Only where the input is narrow: the tensor cores'
                # sums over 3 x 9 x C_in terms stray further from exact than
                # three sums of 9 x C_in (chip_smoke.PLANE_TOL).
                y = F.conv2d(torch.cat((xh, xl, xh), 1), torch.cat((wh, wh, wl), 1), b,
                             padding=1)
            elif xh.shape[1] > wh.shape[0]:
                # Fewer output than input channels (the tail): xh*wh and xh*wl
                # as one conv's two halves, one pass over xh and one output
                # tile where three narrow convs would each fill one.
                c = wh.shape[0]
                both = F.conv2d(xh, torch.cat((wh, wl), 0), padding=1)
                y = both[:, :c] + F.conv2d(xl, wh, b, padding=1) + both[:, c:]
            else:
                y = (F.conv2d(xh, wh, b, padding=1) + F.conv2d(xl, wh, padding=1)
                     + F.conv2d(xh, wl, padding=1))
    return y.permute(0, 2, 3, 1).contiguous()


def _grads(g, x, w, mask):
    """(dx, dw) of one SAME 3x3 conv of NCHW-view x by OIHW w for the
    output gradient g, each where `mask` asks for it."""
    dx, dw, _ = torch.ops.aten.convolution_backward(
        g, x, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [mask[0], mask[1], False])
    return dx, dw


def _wgrad(g, x, w):
    """dw of the plane conv, summed in f32 over batch chunks of at most
    _WGRAD_ROWS pixels each."""
    n = max(1, _WGRAD_ROWS // (x.shape[2] * x.shape[3]))
    dw = None
    for i in range(0, x.shape[0], n):
        part = _grads(g[i : i + n], x[i : i + n], w, (False, True))[1]
        dw = part if dw is None else dw + part
    return dw


def _backward(g, saved: tuple, precision: str, need_x: bool, need_w: bool):
    """(dx, dw) of the class conv for the output gradient g, from what the
    forward saved: x and w at "highest", else the planes (xh, xl, wh, wl),
    where xl may be None if w's gradient is not wanted."""
    gc = _nchw(g.contiguous())
    if precision == "highest":
        x, w = saved
        with tf32_disabled():
            dx, dw = _grads(gc, _nchw(x), _oihw(w), (need_x, need_w))
    else:
        gh, gl = _planes(gc, precision)
        xh, xl, wh, wl = saved
        # dx = gh*'wh + gl*'wh + gh*'wl, dw = xh.gh + xh.gl + xl.gh
        terms = [(gh, xh, wh)] + ([(gl, xh, wh), (gh, xl, wl)] if gl is not None else [])
        # Fewer output than input channels (the tail) at "high": one dgrad
        # of the concatenated gradient planes [gh|gl|gh] by [wh|wh|wl]
        # stacked on the output axis sums the three terms in its
        # accumulator, sparing two adds of the input-wide dx.
        one_dgrad = gl is not None and wh.shape[0] < xh.shape[1]
        dx = dw = None
        with tf32_for_bf16_operands():
            if need_x and one_dgrad:
                dx = _grads(torch.cat((gh, gl, gh), 1), xh, torch.cat((wh, wh, wl), 0),
                            (True, False))[0]
            for gp, xp, wp in terms:
                if need_x and not one_dgrad:
                    # The dgrad reads only the shape and layout of its input.
                    d = _grads(gp, xh, wp, (True, False))[0]
                    dx = d if dx is None else dx + d
                if need_w:
                    d = _wgrad(gp, xp, wp)
                    dw = d if dw is None else dw + d
    dx = dx.permute(0, 2, 3, 1) if need_x else None
    dw = dw.permute(2, 3, 1, 0) if need_w else None
    return dx, dw


class _ClassConv(torch.autograd.Function):
    """The conv at its class; each forward and each backward is one span,
    conv.class. On the card autograd runs the backward on a thread of its
    own, so the forward's context goes with it. Applied where no gradient
    is wanted (under no_grad), autograd drops what the forward saves."""

    @staticmethod
    def forward(ctx, x, w, b, precision):
        ctx.precision = precision
        ctx.spans = contextvars.copy_context()
        with profiling.span("conv.class"):
            if precision == "highest":
                ctx.save_for_backward(x, w)
                return _forward(x, w, b, precision, None)
            planes = _operand_planes(x, w, precision)
            xh, xl, wh, wl = planes
            ctx.save_for_backward(xh, xl if ctx.needs_input_grad[1] else None, wh, wl)
            return _forward(x, w, b, precision, planes)

    @staticmethod
    def backward(ctx, g):
        return ctx.spans.run(_ClassConv._backward, ctx, g)

    @staticmethod
    def _backward(ctx, g):
        with profiling.span("conv.class"):
            need_x, need_w, need_b = ctx.needs_input_grad[:3]
            dx = dw = db = None
            if need_x or need_w:
                if ctx.precision != "highest":
                    profiling.count("conv.planes_kept")
                dx, dw = _backward(g, ctx.saved_tensors, ctx.precision, need_x, need_w)
            if need_b:
                db = g.sum(dim=(0, 1, 2))
        return dx, dw, db, None


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """SAME 3x3 conv + bias of NHWC x by HWIO w at `precision` ("highest",
    "high" or "default"), differentiable at the same class. Returns NHWC in
    x's dtype."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if x.dtype != torch.float32:
        y = F.conv2d(_nchw(x), _oihw(w.to(x.dtype)), padding=1).permute(0, 2, 3, 1)
        return y + b.to(x.dtype)
    return _ClassConv.apply(x, w.float(), b.float(), precision)
