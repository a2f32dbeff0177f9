"""RCAN in plain PyTorch, float32, TF32 off, and its tiled mosaic.

Written from Zhang et al., ECCV 2018 (arXiv:1807.02758) and the authors' code
(github.com/yulunzhang/RCAN, model/rcan.py), not from dsen2_tpu_torch:

    F_0  = conv_head(concat(inputs))                      # no activation
    RCAB: y = conv2(relu(conv1(x))); s = sigmoid(Wu relu(Wd mean_hw(y) + bd) + bu)
          x <- x + s * y
    F_g  = F_{g-1} + conv_g(RCAB_B(... RCAB_1(F_{g-1})))
    out  = conv_tail(F_0 + conv_lsc(F_G)) + inputs[-1]

3x3 SAME convs with biases, 1x1 convs C -> C / reduction -> C in the
attention, no residual scaling. Departures from the paper, in DSen2's 2x
setting: no MeanShift (inputs are reflectances / SCALE); no pixel-shuffle
upsampler (the 20 m bands come bilinearly upsampled, the tail maps C to the
6 bands); DSen2's global residual (+ inputs[-1]); the attention pools over
each patch, border included, as RCAN's forward_chop pools per piece.
Tensors are NCHW; weights flat {"head.w": ...}, HWIO kernels, 1x1 convs as
[C_in, C_out] matrices, blocks stacked on leading [G, B] axes.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import net as refnet
from perfbench.reference.patches import SCALE, TileReference


def seeded(gen: torch.Generator, net: dict, device) -> Dict[str, torch.Tensor]:
    """torch.nn.Conv2d's default initialisation, which RCAN's code keeps:
    weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in = kh * kw
    * C_in, drawn on `device` from `gen` in one call per leaf, float32."""
    c, n_g, n_b = net["n_feats"], net["n_resgroups"], net["n_resblocks"]
    r = c // net["reduction"]
    cin, cout = sum(net["in_channels"]), net["in_channels"][-1]

    def draw(shape, fan_in):
        return (torch.rand(shape, generator=gen, device=device) * 2 - 1) / float(np.sqrt(fan_in))

    return {"head.w": draw((3, 3, cin, c), 9 * cin), "head.b": draw((c,), 9 * cin),
            "blocks.w1": draw((n_g, n_b, 3, 3, c, c), 9 * c),
            "blocks.b1": draw((n_g, n_b, c), 9 * c),
            "blocks.w2": draw((n_g, n_b, 3, 3, c, c), 9 * c),
            "blocks.b2": draw((n_g, n_b, c), 9 * c),
            "ca.wd": draw((n_g, n_b, c, r), c), "ca.bd": draw((n_g, n_b, r), c),
            "ca.wu": draw((n_g, n_b, r, c), r), "ca.bu": draw((n_g, n_b, c), r),
            "groups.w": draw((n_g, 3, 3, c, c), 9 * c), "groups.b": draw((n_g, c), 9 * c),
            "lsc.w": draw((3, 3, c, c), 9 * c), "lsc.b": draw((c,), 9 * c),
            "tail.w": draw((3, 3, c, cout), 9 * c), "tail.b": draw((cout,), 9 * c)}


def _conv(x: torch.Tensor, w_hwio: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), b, padding=1)


def _attention(y, wd, bd, wu, bu):
    """The CALayer: pool, 1x1 conv C -> R, ReLU, 1x1 conv R -> C, sigmoid."""
    z = torch.relu(F.conv2d(y.mean(dim=(2, 3), keepdim=True), wd.t()[:, :, None, None], bd))
    return torch.sigmoid(F.conv2d(z, wu.t()[:, :, None, None], bu))


def forward(p: Dict[str, torch.Tensor], inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The net on NCHW inputs already divided by SCALE. Callers set the
    precision (refnet.no_tf32 for the reference)."""
    f0 = _conv(torch.cat(list(inputs), dim=1), p["head.w"], p["head.b"])
    x = f0
    for g in range(p["blocks.w1"].shape[0]):
        r = x
        for k in range(p["blocks.w1"].shape[1]):
            y = _conv(torch.relu(_conv(r, p["blocks.w1"][g, k], p["blocks.b1"][g, k])),
                      p["blocks.w2"][g, k], p["blocks.b2"][g, k])
            r = r + _attention(y, p["ca.wd"][g, k], p["ca.bd"][g, k], p["ca.wu"][g, k],
                               p["ca.bu"][g, k]) * y
        x = x + _conv(r, p["groups.w"][g], p["groups.b"][g])
    x = f0 + _conv(x, p["lsc.w"], p["lsc.b"])
    return _conv(x, p["tail.w"], p["tail.b"]) + inputs[-1]


class RCANTileReference(TileReference):
    """TileReference's mosaic with RCAN as the net."""

    def net_forward(self, ins: List[torch.Tensor]) -> torch.Tensor:
        return forward(self.params, ins)

    def blocks(self, ids: Sequence[Tuple[int, int]], batch: int = 16) -> List[np.ndarray]:
        """The owned block of each patch (i, j) in `ids`, [h, w, C_out]
        float32 DN."""
        b = self.net["border"]
        out = []
        with refnet.no_tf32(), torch.no_grad():
            for s in range(0, len(ids), batch):
                part = ids[s:s + batch]
                ins = []
                for k in range(len(self.rasters)):
                    x = torch.as_tensor(np.stack([self._window(k, i, j) for i, j in part]),
                                        device=self.device)
                    ins.append((x if k == 0 else self._upsample(x)) / SCALE)
                pred = self.net_forward(ins) * SCALE
                pred = pred[:, :, b:b + self.interior, b:b + self.interior]
                pred = pred.permute(0, 2, 3, 1).cpu().numpy()
                for (i, j), v in zip(part, pred):
                    y0, y1, x0, x1 = self.owned(i, j)
                    out.append(v[:y1 - y0, :x1 - x0])
        return out
