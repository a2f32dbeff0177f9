"""RCAN in plain PyTorch, float32, TF32 off: the reference the port's RCAN
(dsen2_tpu_torch/models/rcan.py) is held to.

Written from Zhang et al., "Image Super-Resolution Using Very Deep Residual
Channel Attention Networks" (ECCV 2018, arXiv:1807.02758) and the authors'
code (github.com/yulunzhang/RCAN, model/rcan.py, model/common.py), not from
the port. Imports nothing of dsen2_tpu_torch and nothing of JAX. NCHW
tensors; weights as the port stores them (HWIO kernels, 1x1 convs as
[C_in, C_out] matrices, blocks stacked on leading [G, B] axes), transposed
here.

    F_0  = conv_head(x)                                   # no activation
    RCAB: y = conv2(relu(conv1(x))); s = sigmoid(Wu relu(Wd mean_hw(y) + bd) + bu)
          x <- x + s * y
    F_g  = F_{g-1} + conv_g(RCAB_B(... RCAB_1(F_{g-1})))
    F_DF = F_0 + conv_lsc(F_G)
    out  = conv_tail(F_DF) + inputs[-1]

Departures from the paper, in DSen2's 2x setting: no MeanShift (inputs are
reflectances / 2000, not RGB); no pixel-shuffle upsampler (the 20 m bands
come bilinearly upsampled, and the tail maps 64 features to the 6 bands);
DSen2's global residual, + the upsampled 20 m bands; the attention pools
over each image given (a patch, as RCAN's forward_chop pools per piece).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for cuDNN and matmuls."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def conv3x3(x: torch.Tensor, w_hwio: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), b, padding=1)


def channel_attention(y: torch.Tensor, wd, bd, wu, bu) -> torch.Tensor:
    """RCAN's CALayer: global average pool, 1x1 conv C -> R, ReLU, 1x1 conv
    R -> C, sigmoid; returns the scale [B, C, 1, 1]."""
    m = y.mean(dim=(2, 3), keepdim=True)
    z = torch.relu(F.conv2d(m, wd.t()[:, :, None, None], bd))
    return torch.sigmoid(F.conv2d(z, wu.t()[:, :, None, None], bu))


def rcab(x, w1, b1, w2, b2, wd, bd, wu, bu) -> torch.Tensor:
    y = conv3x3(torch.relu(conv3x3(x, w1, b1)), w2, b2)
    return x + channel_attention(y, wd, bd, wu, bu) * y


def forward(p: Dict[str, Dict[str, torch.Tensor]], inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The net on NCHW inputs (x10, x20_up), already divided by the
    reflectance scale. Call inside no_tf32() on a card."""
    blk, ca, grp = p["blocks"], p["ca"], p["groups"]
    f0 = conv3x3(torch.cat(list(inputs), dim=1), p["head"]["w"], p["head"]["b"])
    x = f0
    for g in range(blk["w1"].shape[0]):
        r = x
        for k in range(blk["w1"].shape[1]):
            r = rcab(r, blk["w1"][g, k], blk["b1"][g, k], blk["w2"][g, k], blk["b2"][g, k],
                     ca["wd"][g, k], ca["bd"][g, k], ca["wu"][g, k], ca["bu"][g, k])
        x = x + conv3x3(r, grp["w"][g], grp["b"][g])
    x = f0 + conv3x3(x, p["lsc"]["w"], p["lsc"]["b"])
    return conv3x3(x, p["tail"]["w"], p["tail"]["b"]) + inputs[-1]
