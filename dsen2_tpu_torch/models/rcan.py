"""RCAN, the Residual Channel Attention Network, in DSen2's setting.

Zhang et al., "Image Super-Resolution Using Very Deep Residual Channel
Attention Networks", ECCV 2018 (arXiv:1807.02758), as the authors' code
(github.com/yulunzhang/RCAN, model/rcan.py) writes its layers:

    RCAB:  y = conv2(relu(conv1(x)))
           s = sigmoid(Wu relu(Wd mean_hw(y) + bd) + bu)     # channel attention
           x <- x + s * y
    group: F_g = F_{g-1} + conv_g(RCAB_B(... RCAB_1(F_{g-1})))
    body:  F_DF = F_0 + conv_lsc(group_G(... group_1(F_0)))

with 3x3 SAME convs and biases everywhere, no residual scaling, and 1x1
convs C -> C / reduction -> C in the attention. Published widths: G = 10
groups of B = 20 RCABs, C = 64 features, reduction 16 (`rcan_2x`).

In DSen2's setting the net takes what DSen2 2x takes, concat(x10, x20_up)
on the 10 m grid divided by SCALE, and returns the 20 m bands at 10 m:

    F_0 = conv_head(x)                    # 10 -> C, no activation, as in RCAN
    out = conv_tail(F_DF) + inputs[-1]    # C -> 6, DSen2's global residual

Departures from the paper, each forced by that setting:
  - no MeanShift: the inputs are reflectances / SCALE, not RGB in [0, 255];
  - no pixel-shuffle upsampler: the 20 m bands arrive bilinearly upsampled to
    the 10 m grid, as DSen2 takes them, and the tail maps C to the 6 bands;
  - the attention pools over each patch the API feeds the net (128 x 128 at
    2x, border included), as RCAN's own test code (forward_chop) pools per
    piece of a large image.

Routing, as in models/s2net.py: "highest" runs plain f32 convs with TF32 off;
"high" (bf16x3) and "default" (one bf16 pass) run the body through the
hand-written kernels on a GPU (ops/channel_attention.rcan_body) and the class
conv of ops/conv.py with the plain gate elsewhere. The head and tail are the
class conv at every precision. The kernels take float32 activations only:
with them on, a bf16 compute_dtype raises. Inference only: no training path
yet.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dsen2_tpu_torch.models.s2net import _kernels_on, param_count
from dsen2_tpu_torch.ops.channel_attention import ca_gate_plain, rcan_body
from dsen2_tpu_torch.ops.conv import PRECISIONS, conv3x3
from dsen2_tpu_torch.utils import profiling

Params = Dict[str, Dict]

__all__ = ["RCANConfig", "rcan_2x", "init_params", "apply", "param_count"]


@dataclasses.dataclass(frozen=True)
class RCANConfig:
    """RCAN's architecture in DSen2's setting (see the module's doc)."""

    in_channels: Tuple[int, ...] = (4, 6)  # (10 m bands, 20 m bands)
    groups: int = 10
    blocks: int = 20  # RCABs per group
    features: int = 64
    reduction: int = 16  # the attention's C -> C / reduction -> C

    @property
    def out_channels(self) -> int:
        return self.in_channels[-1]

    @property
    def total_in_channels(self) -> int:
        return sum(self.in_channels)

    @property
    def squeeze(self) -> int:
        return self.features // self.reduction


def rcan_2x() -> RCANConfig:
    """RCAN at its published widths on DSen2's 2x inputs (20 m -> 10 m)."""
    return RCANConfig()


def init_params(gen: torch.Generator, cfg: RCANConfig) -> Params:
    """Fresh numpy parameters drawn from `gen` with torch.nn.Conv2d's default
    initialisation, which RCAN's code keeps: weights and biases U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), fan_in = kh * kw * C_in. (he_uniform, DSen2's, makes
    200 blocks without residual scaling overflow.) Layout, kernels HWIO:

      head:   w [3, 3, C_in, C], b [C]
      blocks: w1, w2 [G, B, 3, 3, C, C]; b1, b2 [G, B, C]
      ca:     wd [G, B, C, R], bd [G, B, R], wu [G, B, R, C], bu [G, B, C]
      groups: w [G, 3, 3, C, C], b [G, C]
      lsc:    w [3, 3, C, C], b [C]
      tail:   w [3, 3, C, C_out], b [C_out]
    """
    c, r, n_g, n_b = cfg.features, cfg.squeeze, cfg.groups, cfg.blocks

    def draw(shape, fan_in):
        bound = 1.0 / np.sqrt(fan_in)
        return ((torch.rand(shape, generator=gen) * 2 - 1) * bound).numpy()

    cin, cout = cfg.total_in_channels, cfg.out_channels
    return {
        "head": {"w": draw((3, 3, cin, c), 9 * cin), "b": draw((c,), 9 * cin)},
        "blocks": {"w1": draw((n_g, n_b, 3, 3, c, c), 9 * c), "b1": draw((n_g, n_b, c), 9 * c),
                   "w2": draw((n_g, n_b, 3, 3, c, c), 9 * c), "b2": draw((n_g, n_b, c), 9 * c)},
        "ca": {"wd": draw((n_g, n_b, c, r), c), "bd": draw((n_g, n_b, r), c),
               "wu": draw((n_g, n_b, r, c), r), "bu": draw((n_g, n_b, c), r)},
        "groups": {"w": draw((n_g, 3, 3, c, c), 9 * c), "b": draw((n_g, c), 9 * c)},
        "lsc": {"w": draw((3, 3, c, c), 9 * c), "b": draw((c,), 9 * c)},
        "tail": {"w": draw((3, 3, c, cout), 9 * c), "b": draw((cout,), 9 * c)},
    }


def _body(x: torch.Tensor, p: Params, precision: str) -> torch.Tensor:
    """The body with the class conv and the plain gate."""
    blk, ca, grp, lsc = p["blocks"], p["ca"], p["groups"], p["lsc"]
    n_g, n_b = blk["w1"].shape[:2]
    g_in = x
    for g in range(n_g):
        s = g_in
        for k in range(n_b):
            t = torch.relu(conv3x3(s, blk["w1"][g, k], blk["b1"][g, k], precision))
            y = conv3x3(t, blk["w2"][g, k], blk["b2"][g, k], precision)
            s = ca_gate_plain(s, y, ca["wd"][g, k], ca["bd"][g, k], ca["wu"][g, k],
                              ca["bu"][g, k])
        g_in = g_in + conv3x3(s, grp["w"][g], grp["b"][g], precision)
    return x + conv3x3(g_in, lsc["w"], lsc["b"], precision)


def apply(
    params: Params,
    inputs: Sequence[torch.Tensor],
    cfg: RCANConfig,
    *,
    precision: str = "highest",
    use_kernels: Optional[bool] = False,
) -> torch.Tensor:
    """Forward pass, with s2net.apply's contract: inputs are NHWC tensors
    (x10, x20_up) on the 10 m grid, already divided by SCALE; params are
    tensors (weights.params_to_torch of `init_params`'s layout). Returns the
    NHWC prediction of cfg.out_channels bands (still divided by SCALE). The
    channel attention pools over each image of the batch. Each call's body is
    the span s2net.rcan."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    x = torch.cat(list(inputs), dim=-1)
    x = conv3x3(x, params["head"]["w"], params["head"]["b"], precision)
    kernels = _kernels_on(use_kernels, precision, x.device)
    if kernels and precision == "highest":
        warnings.warn("use_kernels has no true-f32 path; precision='highest' uses plain "
                      "f32 convs (pass precision='high' for the bf16x3 kernels)")
        kernels = False
    if kernels and x.dtype != torch.float32:
        raise ValueError(f"RCAN's kernels take float32 activations, got {x.dtype}: use "
                         "compute_dtype float32, or use_kernels=False for plain convs")
    with profiling.span("s2net.rcan"):
        if kernels:
            x = rcan_body(x, params, passes=3 if precision == "high" else 1)
        else:
            x = _body(x, params, precision)
    x = conv3x3(x, params["tail"]["w"], params["tail"]["b"], precision)
    return x + inputs[-1]
