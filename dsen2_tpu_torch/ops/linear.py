"""The plain linear layer of the port at an accuracy class.

x @ w + b for x [..., K] and w [K, N], as ops/conv.py computes a conv:

  "highest"  true f32, TF32 off.
  "high"     bf16x3: y = xh @ wh + xl @ wh + xh @ wl with f32 sums.
  "default"  one pass: y = xh @ wh with f32 sums.

The planes come from ops/conv.py's plane pass (one launch of
csrc/resblock_chain.cu::plane_kernel per f32 operand on the card, the plain
split elsewhere): f32 tensors holding bf16 values, whose GEMMs run in TF32
(core/device.py::tf32_for_bf16_operands), which rounds none of them, so each
product is exact in f32. The bias is added in the first GEMM's epilogue.
Forward only. Tensors of another dtype than f32 take a plain product in
their own dtype at every class, as conv3x3 does.
"""

from __future__ import annotations

import torch

from dsen2_tpu_torch.core.device import tf32_disabled, tf32_for_bf16_operands
from dsen2_tpu_torch.ops.conv import PRECISIONS, _planes

__all__ = ["linear"]


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """x [..., K] @ w [K, N] + b [N] at `precision` ("highest", "high" or
    "default"). Returns [..., N] in x's dtype."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype != torch.float32:
        y = torch.addmm(b.to(x.dtype), x2, w.to(x.dtype))
    elif precision == "highest":
        with tf32_disabled():
            y = torch.addmm(b.float(), x2, w.float())
    else:
        xh, xl = _planes(x2, precision)
        wh, wl = _planes(w.float().contiguous(), precision)
        with tf32_for_bf16_operands():
            y = torch.addmm(b.float(), xh, wh)
            if xl is not None:
                y.addmm_(xl, wh).addmm_(xh, wl)
    return y.view(*x.shape[:-1], w.shape[-1])
