"""The DSen2 residual CNN in plain PyTorch, float32, TF32 off.

Written from the paper and the reference's utils/DSen2Net.py (s2model,
resBlock), not from dsen2_tpu_torch:

    x = concat(inputs, channel axis)
    x = relu(conv3x3(x) + b)                     # head, F features
    repeat L times:                               # resBlock
        x = x + scale * (conv3x3(relu(conv3x3(x) + b1)) + b2)
    x = conv3x3(x) + b                            # tail, C_out bands
    out = x + inputs[-1]                          # global residual

with SAME zero padding. Tensors are NCHW; the weights come as the shipped
.npz stores them (HWIO kernels, the residual blocks stacked on a leading
axis) and are transposed here.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

LEAVES = ("head.w", "head.b", "blocks.w1", "blocks.b1", "blocks.w2", "blocks.b2",
          "tail.w", "tail.b")


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


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """A flat {"head.w": array, ...} dict of a weights .npz."""
    with np.load(path) as data:
        return {k: np.asarray(data[k], np.float32) for k in data.files}


def he_uniform(gen: torch.Generator, net: dict, device) -> Dict[str, torch.Tensor]:
    """Keras' he_uniform kernels (U(-l, l), l = sqrt(6 / fan_in), fan_in =
    9 * C_in) and zero biases, drawn on `device` from `gen` in one call per
    kernel group, in float32."""
    f, n_l = net["feature_size"], net["num_layers"]
    cin, cout = sum(net["in_channels"]), net["in_channels"][-1]

    def draw(shape, fan_in):
        lim = float(np.sqrt(6.0 / fan_in))
        return (torch.rand(shape, generator=gen, device=device) * 2 - 1) * lim

    z = lambda *s: torch.zeros(s, device=device)  # noqa: E731
    return {"head.w": draw((3, 3, cin, f), 9 * cin), "head.b": z(f),
            "blocks.w1": draw((n_l, 3, 3, f, f), 9 * f), "blocks.b1": z(n_l, f),
            "blocks.w2": draw((n_l, 3, 3, f, f), 9 * f), "blocks.b2": z(n_l, f),
            "tail.w": draw((3, 3, f, cout), 9 * f), "tail.b": z(cout)}


def to_device(flat: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
            .to(device=device, dtype=torch.float32) for k, v in flat.items()}


def _conv(x: torch.Tensor, w_hwio: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), b, padding=1)


def forward(p: Dict[str, torch.Tensor], inputs: Sequence[torch.Tensor],
            scale: float = 0.1) -> torch.Tensor:
    """The net on NCHW inputs already divided by the reflectance scale.
    Callers set the precision (no_tf32 for the reference)."""
    x = torch.relu(_conv(torch.cat(list(inputs), dim=1), p["head.w"], p["head.b"]))
    for k in range(p["blocks.w1"].shape[0]):
        t = torch.relu(_conv(x, p["blocks.w1"][k], p["blocks.b1"][k]))
        x = x + scale * _conv(t, p["blocks.w2"][k], p["blocks.b2"][k])
    return _conv(x, p["tail.w"], p["tail.b"]) + inputs[-1]
