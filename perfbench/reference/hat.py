"""HAT in plain PyTorch, float32, TF32 off, and its tiled mosaic.

Written from Chen et al., "Activating More Pixels in Image Super-Resolution
Transformer", CVPR 2023 (arXiv:2205.04437) and the authors' code
(github.com/XPixelGroup/HAT, hat/archs/hat_arch.py), not from
dsen2_tpu_torch. Layers on NHWC, every window's scores materialised:

    F0   = conv(concat(inputs));  x = LN_pe(F0)
    RHAG(x) = conv(OCAB(HAB_B(... HAB_1(x)))) + x
    HAB:  u = LN1(x); a = roll(WMSA(roll(u, -s)), +s), s = 0, M/2, 0, ...
          c = CA(conv(GELU(conv(u)))); x = x + a + conv_scale * c
          x = x + fc2(GELU(fc1(LN2(x))))
    OCAB: u = LN1(x); q from u's M x M windows, k and v from its M_o x M_o
          windows (zero outside the image, nn.Unfold's padding);
          x = x + proj(attention); x = x + fc2(GELU(fc1(LN2(x))))
    out  = conv(conv(LN_f(RHAGs(x))) + F0) + inputs[-1]

Attention per window and head: softmax(q k^T / sqrt(d) + T[rpi] + mask) v,
rpi = (y_q - y_k + M - 1)(2M - 1) + (x_q - x_k + M - 1) in WMSA and
(y_k - y_q + M - 1)(M + M_o - 1) + (x_k - x_q + M - 1) in OCAB (query
coordinates 0..M-1, key 0..M_o-1); HAT's mask (-100) between pixels of the
rolled image whose row or column bands [0, n - M), [n - M, n - s),
[n - s, n) differ. LayerNorm eps 1e-5, exact GELU.

Departures from the paper, in DSen2's 2x setting: no MeanShift (inputs are
reflectances / SCALE); no pixel-shuffle upsampler (the 20 m bands come
bilinearly upsampled; SwinIR's upscale-1 tail conv maps C to the 6 bands);
DSen2's global residual (+ inputs[-1]); the channel attention pools over
each patch, border included; OCAB's clean bias index (HAT's released code
shifts it so that some indices wrap, a permutation of the same table).
Weights flat {"hab.qkv_w": ...}: HWIO kernels, linears and the channel
attention's 1x1 convs as [C_in, C_out] matrices, bias tables [entries,
heads], a HAB's leaves stacked on leading [G, B] axes, an OCAB's on [G].
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import net as refnet
from perfbench.reference.patches import SCALE, TileReference

EPS = 1e-5


def dims(net: dict) -> dict:
    """The sizes the layers need, from a net entry in HAT's option names."""
    c, m = net["embed_dim"], net["window_size"]
    return dict(c=c, g=len(net["depths"]), b=net["depths"][0], heads=net["num_heads"][0], m=m,
                mo=int(m * net["overlap_ratio"]) + m, hid=int(c * net["mlp_ratio"]),
                cab=c // net["compress_ratio"], r=c // net["squeeze_factor"],
                cin=sum(net["in_channels"]), cout=net["in_channels"][-1])


def seeded(gen: torch.Generator, net: dict, device) -> Dict[str, torch.Tensor]:
    """Every parameter drawn on `device` from `gen`, one call per leaf,
    float32: convs (the channel attention's 1x1 ones too) torch.nn.Conv2d's
    default initialisation, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights
    and biases; linears, their biases and the bias tables HAT's truncated
    normal of std 0.02 (its bounds, +-2, lie 100 sigma out); LayerNorm
    weights 1 + N(0, 0.1), biases N(0, 0.1)."""
    d = dims(net)
    c, g, b, heads, m, mo = d["c"], d["g"], d["b"], d["heads"], d["m"], d["mo"]
    hid, cab, r = d["hid"], d["cab"], d["r"]

    def conv(shape, fan_in):
        return (torch.rand(shape, generator=gen, device=device) * 2 - 1) / float(np.sqrt(fan_in))

    def normal(shape, std=0.02, mean=0.0):
        v = torch.randn(shape, generator=gen, device=device) * std
        return (v.clamp(-2.0, 2.0) if std == 0.02 else v) + mean

    def block(*lead):
        return {"ln1_g": normal((*lead, c), 0.1, 1.0), "ln1_b": normal((*lead, c), 0.1),
                "qkv_w": normal((*lead, c, 3 * c)), "qkv_b": normal((*lead, 3 * c)),
                "proj_w": normal((*lead, c, c)), "proj_b": normal((*lead, c)),
                "ln2_g": normal((*lead, c), 0.1, 1.0), "ln2_b": normal((*lead, c), 0.1),
                "fc1_w": normal((*lead, c, hid)), "fc1_b": normal((*lead, hid)),
                "fc2_w": normal((*lead, hid, c)), "fc2_b": normal((*lead, c))}

    p = {"head.w": conv((3, 3, d["cin"], c), 9 * d["cin"]), "head.b": conv((c,), 9 * d["cin"]),
         "pe_norm.g": normal((c,), 0.1, 1.0), "pe_norm.b": normal((c,), 0.1)}
    hab = block(g, b)
    hab.update({"rpb": normal((g, b, (2 * m - 1) ** 2, heads)),
                "cab_w1": conv((g, b, 3, 3, c, cab), 9 * c), "cab_b1": conv((g, b, cab), 9 * c),
                "cab_w2": conv((g, b, 3, 3, cab, c), 9 * cab),
                "cab_b2": conv((g, b, c), 9 * cab),
                "ca_wd": conv((g, b, c, r), c), "ca_bd": conv((g, b, r), c),
                "ca_wu": conv((g, b, r, c), r), "ca_bu": conv((g, b, c), r)})
    ocab = block(g)
    ocab["rpb"] = normal((g, (m + mo - 1) ** 2, heads))
    p.update({"hab." + k: v for k, v in hab.items()})
    p.update({"ocab." + k: v for k, v in ocab.items()})
    p.update({"groups.w": conv((g, 3, 3, c, c), 9 * c), "groups.b": conv((g, c), 9 * c),
              "norm.g": normal((c,), 0.1, 1.0), "norm.b": normal((c,), 0.1),
              "body.w": conv((3, 3, c, c), 9 * c), "body.b": conv((c,), 9 * c),
              "tail.w": conv((3, 3, c, d["cout"]), 9 * c),
              "tail.b": conv((d["cout"],), 9 * c)})
    return p


def _conv(x, w_hwio, b):
    """SAME 3x3 conv of NHWC x."""
    return F.conv2d(x.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1), b,
                    padding=1).permute(0, 2, 3, 1)


def _ln(x, g, b):
    return F.layer_norm(x, (x.shape[-1],), g, b, EPS)


def _mlp(x, p):
    h = F.gelu(_ln(x, p["ln2_g"], p["ln2_b"]) @ p["fc1_w"] + p["fc1_b"])
    return x + h @ p["fc2_w"] + p["fc2_b"]


def _partition(t, m):
    b, h, w, c = t.shape
    return t.reshape(b, h // m, m, w // m, m, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, m * m, c)


def _reverse(t, m, b, h, w):
    c = t.shape[-1]
    return t.reshape(b, h // m, w // m, m, m, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def _coords(m, device):
    y, x = torch.meshgrid(torch.arange(m, device=device), torch.arange(m, device=device),
                          indexing="ij")
    return y.reshape(-1), x.reshape(-1)


def _mask(h, w, m, s, device):
    """HAT's calculate_mask: [nW, m^2, m^2], 0 or -100."""
    img = torch.zeros((1, h, w, 1), device=device)
    cnt = 0
    for hs in (slice(0, -m), slice(-m, -s), slice(-s, None)):
        for ws in (slice(0, -m), slice(-m, -s), slice(-s, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    mw = _partition(img, m)[..., 0]
    diff = mw[:, None, :] - mw[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


def _attend(q, k, v, bias, heads, mask=None):
    """softmax(q k^T / sqrt(d) + bias [+ mask]) v on windows [n, N, C]."""
    n, nq, c = q.shape
    d = c // heads

    def split(t):
        return t.reshape(t.shape[0], t.shape[1], heads, d).transpose(1, 2)

    a = split(q) * d ** -0.5 @ split(k).transpose(-2, -1) + bias
    if mask is not None:
        a = (a.view(-1, mask.shape[0], heads, nq, a.shape[-1]) + mask[None, :, None]).view(a.shape)
    return (torch.softmax(a, dim=-1) @ split(v)).transpose(1, 2).reshape(n, nq, c)


def _hab(x, p, heads, m, s, conv_scale):
    b, h, w, c = x.shape
    u = _ln(x, p["ln1_g"], p["ln1_b"])
    # WMSA on the rolled image's windows, rolled back.
    t = torch.roll(u, (-s, -s), (1, 2)) if s else u
    qkv = _partition(t, m) @ p["qkv_w"] + p["qkv_b"]
    y, xx = _coords(m, x.device)
    rpi = (y[:, None] - y[None, :] + m - 1) * (2 * m - 1) + (xx[:, None] - xx[None, :] + m - 1)
    o = _attend(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                p["rpb"][rpi].permute(2, 0, 1), heads, _mask(h, w, m, s, x.device) if s else None)
    a = _reverse(o @ p["proj_w"] + p["proj_b"], m, b, h, w)
    a = torch.roll(a, (s, s), (1, 2)) if s else a
    # CAB: the channel attention is RCAN's CALayer.
    yc = _conv(F.gelu(_conv(u, p["cab_w1"], p["cab_b1"])), p["cab_w2"], p["cab_b2"])
    sc = torch.sigmoid(torch.relu(yc.mean(dim=(1, 2)) @ p["ca_wd"] + p["ca_bd"]) @ p["ca_wu"]
                       + p["ca_bu"])
    x = x + a + conv_scale * (yc * sc[:, None, None, :])
    return _mlp(x, p)


def _ocab(x, p, heads, m, mo):
    b, h, w, c = x.shape
    qkv = _ln(x, p["ln1_g"], p["ln1_b"]) @ p["qkv_w"] + p["qkv_b"]
    kv = F.unfold(qkv[..., c:].permute(0, 3, 1, 2), kernel_size=mo, stride=m,
                  padding=(mo - m) // 2)                      # [B, 2C * mo^2, nW]
    kv = kv.view(b, 2, c, mo * mo, -1).permute(1, 0, 4, 3, 2).reshape(2, -1, mo * mo, c)
    qy, qx = _coords(m, x.device)
    ky, kx = _coords(mo, x.device)
    rpi = (ky[None, :] - qy[:, None] + m - 1) * (m + mo - 1) + (kx[None, :] - qx[:, None] + m - 1)
    o = _attend(_partition(qkv[..., :c], m), kv[0], kv[1], p["rpb"][rpi].permute(2, 0, 1), heads)
    return _mlp(x + _reverse(o, m, b, h, w) @ p["proj_w"] + p["proj_b"], p)


def forward(p: Dict[str, torch.Tensor], inputs: Sequence[torch.Tensor], net: dict) -> torch.Tensor:
    """The net on NCHW inputs already divided by SCALE; returns NCHW. Callers
    set the precision (refnet.no_tf32 for the reference)."""
    d = dims(net)
    heads, m, mo = d["heads"], d["m"], d["mo"]

    def leaves(prefix, *index):
        return {k[len(prefix):]: v[index] for k, v in p.items() if k.startswith(prefix)}

    f0 = _conv(torch.cat(list(inputs), dim=1).permute(0, 2, 3, 1), p["head.w"], p["head.b"])
    x = _ln(f0, p["pe_norm.g"], p["pe_norm.b"])
    for g in range(d["g"]):
        r = x
        for k in range(d["b"]):
            x = _hab(x, leaves("hab.", g, k), heads, m, 0 if k % 2 == 0 else m // 2,
                     net["conv_scale"])
        x = _ocab(x, leaves("ocab.", g), heads, m, mo)
        x = r + _conv(x, p["groups.w"][g], p["groups.b"][g])
    x = _conv(_ln(x, p["norm.g"], p["norm.b"]), p["body.w"], p["body.b"]) + f0
    return _conv(x, p["tail.w"], p["tail.b"]).permute(0, 3, 1, 2) + inputs[-1]


class HATTileReference(TileReference):
    """TileReference's mosaic with HAT as the net, a few patches at a time."""

    def blocks(self, ids: Sequence[Tuple[int, int]], batch: int = 8) -> List[np.ndarray]:
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
                pred = forward(self.params, ins, self.net) * SCALE
                pred = pred[:, :, b:b + self.interior, b:b + self.interior]
                pred = pred.permute(0, 2, 3, 1).cpu().numpy()
                for (i, j), v in zip(part, pred):
                    y0, y1, x0, x1 = self.owned(i, j)
                    out.append(v[:y1 - y0, :x1 - x0])
        return out
