"""HAT, the Hybrid Attention Transformer, in DSen2's setting.

Chen et al., "Activating More Pixels in Image Super-Resolution Transformer",
CVPR 2023 (arXiv:2205.04437), as the authors' code (github.com/XPixelGroup/
HAT, hat/archs/hat_arch.py) writes its layers. x is [B, H, W, C]; linears
and convs have biases; convs are 3x3 SAME:

    F0   = conv_{10->C}(inputs)
    x    = LN_pe(F0);  x = RHAG_G(... RHAG_1(x));  x = LN_f(x)
    out  = conv_{C->6}(conv_{C->C}(x) + F0) + inputs[-1]
    RHAG(x) = conv_{C->C}(OCAB(HAB_B(... HAB_1(x)))) + x
    HAB (shift s = 0 for odd blocks, M/2 for even ones, counting from 1):
         u = LN1(x)
         a = roll(WMSA(roll(u, -s), mask if s > 0), +s)
         c = CA(conv_{C/3->C}(GELU(conv_{C->C/3}(u))))          # CAB
         x = x + a + conv_scale * c
         x = x + fc2(GELU(fc1(LN2(x))))
    CA(y) = y * sigmoid(W2 relu(W1 mean_hw(y) + b1) + b2)         # RCAN's gate
    OCAB: u = LN1(x); queries from the M x M windows of u Wq, keys and
          values from the overlapping M_o x M_o windows of u Wk, u Wv
          (zero outside the image); x = x + proj(attention);
          x = x + fc2(GELU(fc1(LN2(x))))

with a learned relative-position bias in every attention (ops/
window_attention.py has the index arithmetic and the mask). Published widths
(`hat_2x`): C = 180, 6 RHAGs of 6 HABs, 6 heads, window 16, overlap ratio
0.5 (M_o = 24), MLP ratio 2, compress ratio 3, squeeze factor 30, conv
scale 0.01, LayerNorm eps 1e-5, exact (erf) GELU.

In DSen2's setting the net takes concat(x10, x20_up) / SCALE on the 10 m
grid, as DSen2 2x and RCAN do, and returns the 20 m bands at 10 m.
Departures, each forced by that setting:
  - no MeanShift: the inputs are reflectances / SCALE;
  - no pixel-shuffle upsampler: the 20 m bands arrive upsampled, the tail is
    SwinIR's upscale-1 conv C -> 6, plus DSen2's global residual;
  - the channel attention pools over each patch the API feeds the net
    (128 x 128 at 2x, border included), as RCAN's does here;
  - OCAB's bias index is the clean one, (y_k - y_q + M - 1)(M + M_o - 1) +
    (x_k - x_q + M - 1) in local coordinates; HAT's released code shifts it
    so that some indices wrap, a permutation of the same table.

Routing, as in models/rcan.py: "highest" runs plain f32 (TF32 off)
everywhere; "high" (bf16x3) and "default" (one bf16 pass) run the window
attention in its CUDA kernel on a GPU (ops/window_attention.py) and its plain
version at the class elsewhere. Convs are the class conv (ops/conv.py),
linears the class linear (ops/linear.py), LayerNorm, GELU and the gate plain
f32 at every class. The kernel takes float32 activations only: with it on, a
bf16 compute_dtype raises. Inference only: no training path yet.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dsen2_tpu_torch.models.s2net import _kernels_on
from dsen2_tpu_torch.ops.channel_attention import channel_scale
from dsen2_tpu_torch.ops.conv import PRECISIONS, conv3x3
from dsen2_tpu_torch.ops.linear import linear
from dsen2_tpu_torch.ops.window_attention import window_attention, window_attention_plain
from dsen2_tpu_torch.utils import profiling

Params = Dict[str, Dict]

__all__ = ["HATConfig", "hat_2x", "param_shapes", "init_params", "apply", "param_count"]

LN_EPS = 1e-5
_PASSES = {"high": 3, "default": 1}


@dataclasses.dataclass(frozen=True)
class HATConfig:
    """HAT's architecture in DSen2's setting (see the module's doc)."""

    in_channels: Tuple[int, ...] = (4, 6)  # (10 m bands, 20 m bands)
    embed_dim: int = 180
    groups: int = 6  # RHAGs
    blocks: int = 6  # HABs per RHAG
    heads: int = 6
    window: int = 16
    overlap_ratio: float = 0.5
    mlp_ratio: float = 2.0
    compress_ratio: int = 3
    squeeze_factor: int = 30
    conv_scale: float = 0.01

    @property
    def out_channels(self) -> int:
        return self.in_channels[-1]

    @property
    def total_in_channels(self) -> int:
        return sum(self.in_channels)

    @property
    def overlap_window(self) -> int:
        """M_o, the side of OCAB's key and value windows."""
        return int(self.window * self.overlap_ratio) + self.window

    @property
    def hidden(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)


def hat_2x() -> HATConfig:
    """HAT at its published widths on DSen2's 2x inputs (20 m -> 10 m)."""
    return HATConfig()


def param_shapes(cfg: HATConfig) -> Dict[str, Dict[str, tuple]]:
    """Every parameter's shape, in init_params's layout: kernels HWIO,
    linears [in, out] (x @ w), bias tables [entries, heads]; a HAB's
    parameters stacked on leading [G, B] axes, an OCAB's on [G]."""
    c, g, b, n = cfg.embed_dim, cfg.groups, cfg.blocks, cfg.heads
    cab, r, hid = c // cfg.compress_ratio, c // cfg.squeeze_factor, cfg.hidden
    sa, oca = (2 * cfg.window - 1) ** 2, (cfg.window + cfg.overlap_window - 1) ** 2
    cin, cout = cfg.total_in_channels, cfg.out_channels

    def block(*lead):
        return {"ln1_g": (*lead, c), "ln1_b": (*lead, c), "qkv_w": (*lead, c, 3 * c),
                "qkv_b": (*lead, 3 * c), "proj_w": (*lead, c, c), "proj_b": (*lead, c),
                "ln2_g": (*lead, c), "ln2_b": (*lead, c), "fc1_w": (*lead, c, hid),
                "fc1_b": (*lead, hid), "fc2_w": (*lead, hid, c), "fc2_b": (*lead, c)}

    return {
        "head": {"w": (3, 3, cin, c), "b": (c,)},
        "pe_norm": {"g": (c,), "b": (c,)},
        "hab": {**block(g, b), "rpb": (g, b, sa, n),
                "cab_w1": (g, b, 3, 3, c, cab), "cab_b1": (g, b, cab),
                "cab_w2": (g, b, 3, 3, cab, c), "cab_b2": (g, b, c),
                "ca_wd": (g, b, c, r), "ca_bd": (g, b, r), "ca_wu": (g, b, r, c),
                "ca_bu": (g, b, c)},
        "ocab": {**block(g), "rpb": (g, oca, n)},
        "groups": {"w": (g, 3, 3, c, c), "b": (g, c)},
        "norm": {"g": (c,), "b": (c,)},
        "body": {"w": (3, 3, c, c), "b": (c,)},
        "tail": {"w": (3, 3, c, cout), "b": (cout,)},
    }


def param_count(cfg: HATConfig) -> int:
    """Parameters of the net (20,392,674 for hat_2x)."""
    return sum(int(np.prod(s)) for sub in param_shapes(cfg).values() for s in sub.values())


def init_params(gen: torch.Generator, cfg: HATConfig) -> Params:
    """Fresh numpy parameters drawn from `gen`, one draw per leaf in
    param_shapes's order: convs (the CAB's and the channel attention's 1x1
    convs included) torch.nn.Conv2d's default initialisation, U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) for weights and biases; linears and bias tables HAT's
    truncated normal of std 0.02, and the linears' biases drawn from it too
    (HAT starts them at 0; drawn, a comparison sees them); LayerNorm weights
    1 + N(0, 0.1), biases N(0, 0.1)."""
    out: Params = {}
    for top, sub in param_shapes(cfg).items():
        out[top] = {}
        for name, shape in sub.items():
            if name.startswith("ln") or top in ("pe_norm", "norm"):
                v = torch.randn(shape, generator=gen) * 0.1 + (1.0 if name.endswith("g") else 0.0)
            elif name.startswith(("qkv", "proj", "fc", "rpb")):
                v = (torch.randn(shape, generator=gen) * 0.02).clamp(-2.0, 2.0)
            else:
                w = sub[_CONV_WEIGHT.get(name, name)]
                fan_in = w[-2] * (9 if name in _CONV3X3 else 1)
                v = (torch.rand(shape, generator=gen) * 2 - 1) / float(np.sqrt(fan_in))
            out[top][name] = v.numpy()
    return out


# The convs' leaves: each bias's weight, and the 3x3 kernels' names (the
# channel attention's are 1x1, [C_in, C_out] matrices).
_CONV_WEIGHT = {"b": "w", "cab_b1": "cab_w1", "cab_b2": "cab_w2", "ca_bd": "ca_wd",
                "ca_bu": "ca_wu"}
_CONV3X3 = {"w", "b", "cab_w1", "cab_b1", "cab_w2", "cab_b2"}


def _norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), g, b, LN_EPS)


def _mlp(x: torch.Tensor, p: Dict[str, torch.Tensor], precision: str) -> torch.Tensor:
    """x + fc2(GELU(fc1(LN2(x))))."""
    h = F.gelu(linear(_norm(x, p["ln2_g"], p["ln2_b"]), p["fc1_w"], p["fc1_b"], precision))
    return x + linear(h, p["fc2_w"], p["fc2_b"], precision)


def _attention(qkv, table, cfg: HATConfig, precision: str, kernels: bool, **geometry):
    if kernels:
        return window_attention(qkv, table, heads=cfg.heads, window=cfg.window,
                                passes=_PASSES[precision], **geometry)
    return window_attention_plain(qkv, table, heads=cfg.heads, window=cfg.window,
                                  passes=_PASSES.get(precision), **geometry)


def _hab(x, p, cfg: HATConfig, shift: int, precision: str, kernels: bool):
    u = _norm(x, p["ln1_g"], p["ln1_b"])
    qkv = linear(u, p["qkv_w"], p["qkv_b"], precision)
    a = _attention(qkv, p["rpb"], cfg, precision, kernels, shift=shift)
    del qkv
    a = linear(a, p["proj_w"], p["proj_b"], precision)
    y = conv3x3(F.gelu(conv3x3(u, p["cab_w1"], p["cab_b1"], precision)), p["cab_w2"],
                p["cab_b2"], precision)
    s = channel_scale(y.float().mean(dim=(1, 2)), p["ca_wd"], p["ca_bd"], p["ca_wu"], p["ca_bu"])
    x = x + a + s.to(y.dtype)[:, None, None, :] * (cfg.conv_scale * y)
    return _mlp(x, p, precision)


def _ocab(x, p, cfg: HATConfig, precision: str, kernels: bool):
    u = _norm(x, p["ln1_g"], p["ln1_b"])
    qkv = linear(u, p["qkv_w"], p["qkv_b"], precision)
    o = _attention(qkv, p["rpb"], cfg, precision, kernels, overlap=cfg.overlap_window)
    del qkv
    return _mlp(x + linear(o, p["proj_w"], p["proj_b"], precision), p, precision)


def _body(f0: torch.Tensor, params: Params, cfg: HATConfig, precision: str,
          kernels: bool) -> torch.Tensor:
    """conv_after_body(LN_f(RHAGs(LN_pe(F0)))) + F0. Each RHAG is the span
    hat.rhag; the counters hat.blocks and hat.ocabs count HABs and OCABs."""
    hab, ocab, grp = params["hab"], params["ocab"], params["groups"]
    x = _norm(f0, params["pe_norm"]["g"], params["pe_norm"]["b"])
    for g in range(cfg.groups):
        with profiling.span("hat.rhag"):
            r = x
            for k in range(cfg.blocks):
                shift = 0 if k % 2 == 0 else cfg.window // 2
                x = _hab(x, {n: v[g, k] for n, v in hab.items()}, cfg, shift, precision,
                         kernels)
            x = _ocab(x, {n: v[g] for n, v in ocab.items()}, cfg, precision, kernels)
            x = r + conv3x3(x, grp["w"][g], grp["b"][g], precision)
        profiling.count("hat.blocks", cfg.blocks)
        profiling.count("hat.ocabs")
    x = _norm(x, params["norm"]["g"], params["norm"]["b"])
    return conv3x3(x, params["body"]["w"], params["body"]["b"], precision) + f0


def apply(
    params: Params,
    inputs: Sequence[torch.Tensor],
    cfg: HATConfig,
    *,
    precision: str = "highest",
    use_kernels: Optional[bool] = False,
) -> torch.Tensor:
    """Forward pass, with s2net.apply's contract: inputs are NHWC tensors
    (x10, x20_up) on the 10 m grid, already divided by SCALE, whose H and W
    the window divides; params are tensors (weights.params_to_torch of
    `init_params`'s layout). Returns the NHWC prediction of cfg.out_channels
    bands (still divided by SCALE). The channel attention pools over each
    image of the batch. Each call's body is the span s2net.hat."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    h, w = inputs[0].shape[1:3]
    if h % cfg.window or w % cfg.window:
        raise ValueError(f"HAT's window {cfg.window} must divide the patch, got {h} x {w}")
    x = torch.cat(list(inputs), dim=-1)
    f0 = conv3x3(x, params["head"]["w"], params["head"]["b"], precision)
    kernels = _kernels_on(use_kernels, precision, f0.device)
    if kernels and precision == "highest":
        warnings.warn("use_kernels has no true-f32 path; precision='highest' uses plain "
                      "f32 attention (pass precision='high' for the bf16x3 kernel)")
        kernels = False
    if kernels and f0.dtype != torch.float32:
        raise ValueError(f"HAT's kernel takes float32 activations, got {f0.dtype}: use "
                         "compute_dtype float32, or use_kernels=False for plain attention")
    with profiling.span("s2net.hat"):
        x = _body(f0, params, cfg, precision, kernels)
    x = conv3x3(x, params["tail"]["w"], params["tail"]["b"], precision)
    return x + inputs[-1]
