"""HAT in plain PyTorch, float32, TF32 off: the reference the port's HAT
(dsen2_tpu_torch/models/hat.py) is held to.

Written from Chen et al., "Activating More Pixels in Image Super-Resolution
Transformer" (CVPR 2023, arXiv:2205.04437) and the authors' code
(github.com/XPixelGroup/HAT, hat/archs/hat_arch.py), not from the port.
Imports nothing of dsen2_tpu_torch and nothing of JAX. Inputs and output
NCHW, the layers on NHWC; weights as the port stores them (HWIO kernels,
linears [in, out], bias tables [entries, heads], a HAB's leaves stacked on
[G, B], an OCAB's on [G]). Every window's scores are materialised.

    F0   = conv(inputs);  x = LN_pe(F0)
    RHAG(x) = conv(OCAB(HAB_B(... HAB_1(x)))) + x
    HAB:  u = LN1(x); a = roll(WMSA(roll(u, -s)), +s) (s = 0, M/2, 0, ...)
          c = CA(conv(GELU(conv(u)))); x = x + a + conv_scale * c
          x = x + fc2(GELU(fc1(LN2(x))))
    OCAB: u = LN1(x); q from u's M x M windows, k and v from its M_o x M_o
          windows (zero outside the image); x = x + proj(attention);
          x = x + fc2(GELU(fc1(LN2(x))))
    out  = conv(conv(LN_f(RHAGs(x))) + F0) + inputs[-1]

Attention per window and head: softmax(q k^T / sqrt(d) + T[rpi] + mask) v,
rpi = (y_q - y_k + M - 1)(2M - 1) + (x_q - x_k + M - 1) in WMSA and
(y_k - y_q + M - 1)(M + M_o - 1) + (x_k - x_q + M - 1) in OCAB (query
coordinates 0..M-1, key 0..M_o-1); the shifted blocks' mask is -100 between
pixels of the rolled image whose row or column bands [0, n - M),
[n - M, n - s), [n - s, n) differ.

Departures from the paper, in DSen2's 2x setting: no MeanShift (inputs are
reflectances / 2000); no pixel-shuffle upsampler (the 20 m bands come
upsampled; the tail maps C to the 6 bands, SwinIR's upscale-1 conv);
DSen2's global residual, + the upsampled 20 m bands; the channel attention
pools over each image given (a patch); OCAB's clean bias index (HAT's code
shifts it so that some indices wrap, a permutation of the same table).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

EPS = 1e-5


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
    """SAME 3x3 conv of NHWC x."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1), b, padding=1)
    return y.permute(0, 2, 3, 1)


def layer_norm(x, g, b):
    return F.layer_norm(x, (x.shape[-1],), g, b, EPS)


def mlp(x, p):
    return x + F.gelu(layer_norm(x, p["ln2_g"], p["ln2_b"]) @ p["fc1_w"] + p["fc1_b"]) \
        @ p["fc2_w"] + p["fc2_b"]


def cab(u, p, conv_scale):
    """conv_scale * CA(conv(GELU(conv(u)))), the CA as RCAN's CALayer."""
    y = conv3x3(F.gelu(conv3x3(u, p["cab_w1"], p["cab_b1"])), p["cab_w2"], p["cab_b2"])
    z = torch.relu(y.mean(dim=(1, 2)) @ p["ca_wd"] + p["ca_bd"])
    s = torch.sigmoid(z @ p["ca_wu"] + p["ca_bu"])
    return conv_scale * (y * s[:, None, None, :])


def partition(t, m):
    """[B, H, W, C] -> [B * nW, m * m, C]."""
    b, h, w, c = t.shape
    return t.reshape(b, h // m, m, w // m, m, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, m * m, c)


def reverse(t, m, b, h, w):
    """[B * nW, m * m, C] -> [B, H, W, C]."""
    c = t.shape[-1]
    return t.reshape(b, h // m, w // m, m, m, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def coords(m):
    y, x = torch.meshgrid(torch.arange(m), torch.arange(m), indexing="ij")
    return y.reshape(-1), x.reshape(-1)


def rpi_sa(m):
    """calculate_rpi_sa: [m^2, m^2]."""
    y, x = coords(m)
    return (y[:, None] - y[None, :] + m - 1) * (2 * m - 1) + (x[:, None] - x[None, :] + m - 1)


def rpi_oca(m, mo):
    """The clean overlapping index: [m^2, mo^2]."""
    qy, qx = coords(m)
    ky, kx = coords(mo)
    return (ky[None, :] - qy[:, None] + m - 1) * (m + mo - 1) + (kx[None, :] - qx[:, None] + m - 1)


def attn_mask(h, w, m, s):
    """calculate_mask: [nW, m^2, m^2], 0 or -100."""
    img = torch.zeros((1, h, w, 1))
    cnt = 0
    for hs in (slice(0, -m), slice(-m, -s), slice(-s, None)):
        for ws in (slice(0, -m), slice(-m, -s), slice(-s, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    mw = partition(img, m)[..., 0]
    diff = mw[:, None, :] - mw[:, :, None]
    return diff.masked_fill(diff != 0, -100.0).masked_fill(diff == 0, 0.0)


def heads_of(t, n):
    """[nw, N, C] -> [nw, heads, N, d]."""
    return t.reshape(t.shape[0], t.shape[1], n, -1).transpose(1, 2)


def softmax_attention(q, k, v, bias, n, mask=None, nw=None):
    d = q.shape[-1] // n
    q, k, v = heads_of(q, n) * d ** -0.5, heads_of(k, n), heads_of(v, n)
    a = q @ k.transpose(-2, -1) + bias
    if mask is not None:
        a = (a.view(-1, nw, n, a.shape[-2], a.shape[-1]) + mask[None, :, None]).view(a.shape)
    o = torch.softmax(a, dim=-1) @ v
    return o.transpose(1, 2).reshape(q.shape[0], q.shape[2], -1)


def wmsa(u, p, n, m, s):
    """Shifted-window self-attention and its projection on u [B, H, W, C]."""
    b, h, w, c = u.shape
    if s:
        u = torch.roll(u, (-s, -s), (1, 2))
    qkv = partition(u, m) @ p["qkv_w"] + p["qkv_b"]
    bias = p["rpb"][rpi_sa(m)].permute(2, 0, 1)
    mask = attn_mask(h, w, m, s).to(u.device) if s else None
    o = softmax_attention(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], bias, n, mask,
                          (h // m) * (w // m))
    o = reverse(o @ p["proj_w"] + p["proj_b"], m, b, h, w)
    return torch.roll(o, (s, s), (1, 2)) if s else o


def ocab(x, p, n, m, mo):
    b, h, w, c = x.shape
    qkv = layer_norm(x, p["ln1_g"], p["ln1_b"]) @ p["qkv_w"] + p["qkv_b"]
    q = partition(qkv[..., :c], m)
    kv = F.unfold(qkv[..., c:].permute(0, 3, 1, 2), kernel_size=mo, stride=m,
                  padding=(mo - m) // 2)                     # [B, 2C * mo * mo, nW]
    kv = kv.view(b, 2, c, mo * mo, -1).permute(1, 0, 4, 3, 2).reshape(2, -1, mo * mo, c)
    bias = p["rpb"][rpi_oca(m, mo)].permute(2, 0, 1)
    o = softmax_attention(q, kv[0], kv[1], bias, n)
    x = x + reverse(o, m, b, h, w) @ p["proj_w"] + p["proj_b"]
    return mlp(x, p)


def hab(x, p, n, m, s, conv_scale):
    u = layer_norm(x, p["ln1_g"], p["ln1_b"])
    x = x + wmsa(u, p, n, m, s) + cab(u, p, conv_scale)
    return mlp(x, p)


def forward(params: Dict[str, Dict[str, torch.Tensor]], inputs: Sequence[torch.Tensor], *,
            heads: int, window: int, overlap: int, conv_scale: float = 0.01) -> torch.Tensor:
    """The net on NCHW inputs (x10, x20_up), already divided by the
    reflectance scale; `overlap` is M_o. Call inside no_tf32() on a card."""
    hp, op, grp = params["hab"], params["ocab"], params["groups"]
    n_g, n_b = hp["qkv_w"].shape[:2]
    f0 = conv3x3(torch.cat(list(inputs), dim=1).permute(0, 2, 3, 1), params["head"]["w"],
                 params["head"]["b"])
    x = layer_norm(f0, params["pe_norm"]["g"], params["pe_norm"]["b"])
    for g in range(n_g):
        r = x
        for k in range(n_b):
            x = hab(x, {a: v[g, k] for a, v in hp.items()}, heads, window,
                    0 if k % 2 == 0 else window // 2, conv_scale)
        x = ocab(x, {a: v[g] for a, v in op.items()}, heads, window, overlap)
        x = r + conv3x3(x, grp["w"][g], grp["b"][g])
    x = layer_norm(x, params["norm"]["g"], params["norm"]["b"])
    x = conv3x3(x, params["body"]["w"], params["body"]["b"]) + f0
    out = conv3x3(x, params["tail"]["w"], params["tail"]["b"])
    return out.permute(0, 3, 1, 2) + inputs[-1]
