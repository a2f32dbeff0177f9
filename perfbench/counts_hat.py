"""Operations and bytes of HAT's work in a cell, counted from its shapes.

As perfbench/counts.py does for DSen2, and never from the program's
counters. A net entry of a configuration gives HAT's own option names
(embed_dim C, depths, num_heads, window_size M, overlap_ratio, mlp_ratio,
compress_ratio) and the patch geometry (lr_factor, patch_size, border).

- Model FLOPs per patch pixel: 2 * 9 * C_in * C_out for every 3x3 conv (the
  head, each HAB's two CAB convs, each RHAG's conv, the conv after the body,
  the tail); 2 * C_in * C_out for every linear (each HAB's and OCAB's qkv,
  proj, fc1 and fc2); 4 * N_k * C for each attention (q k^T and p v; N_k =
  M^2 in a HAB, M_o^2 in an OCAB). The channel attention's 1x1 convs act on
  one pooled vector per patch and are left out (under 1e-6 of the rest).
- The window-attention kernel: each launch's operations, 4 N_k C per query
  pixel times the passes of the accuracy class, against q, k and v read
  once and the output written once at the class's operand width, 4 B an
  element at "high" (f32, or two bf16 planes) and 2 B at "default", the
  least any implementation of the class can move.
"""

from __future__ import annotations

from perfbench.counts import PASSES, tile_patches


def shape(net: dict) -> dict:
    """C, blocks per group, groups, M, M_o and the MLP and CAB widths."""
    c, m = net["embed_dim"], net["window_size"]
    return dict(c=c, groups=len(net["depths"]), blocks=net["depths"][0], m=m,
                mo=int(m * net["overlap_ratio"]) + m, hid=int(c * net["mlp_ratio"]),
                cab=c // net["compress_ratio"])


def attention_flops_per_px(net: dict) -> tuple:
    """(a HAB's, an OCAB's) attention FLOPs per query pixel."""
    s = shape(net)
    return 4 * s["m"] ** 2 * s["c"], 4 * s["mo"] ** 2 * s["c"]


def flops_per_px(net: dict) -> int:
    """Forward FLOPs per patch pixel of the whole net."""
    s = shape(net)
    c, hid, cab = s["c"], s["hid"], s["cab"]
    cin, cout = sum(net["in_channels"]), net["in_channels"][-1]
    linears = 2 * (c * 3 * c + c * c + c * hid + hid * c)
    hab_attn, ocab_attn = attention_flops_per_px(net)
    hab = linears + 2 * 9 * (c * cab + cab * c) + hab_attn
    ocab = linears + ocab_attn
    convs = 2 * 9 * (cin * c + (s["groups"] + 1) * c * c + c * cout)
    return s["groups"] * (s["blocks"] * hab + ocab) + convs


def tile_model_flops(h10: int, w10: int, net: dict) -> int:
    """Model FLOPs of one entry-point call on an h10 x w10 tile."""
    return tile_patches(h10, w10, net) * net["patch_size"] ** 2 * flops_per_px(net)


def attention_work(h10: int, w10: int, net: dict, precision: str):
    """(operations, bytes) the window-attention kernel must do for one call:
    every patch through every HAB's and OCAB's attention."""
    s = shape(net)
    px = tile_patches(h10, w10, net) * net["patch_size"] ** 2
    hab_attn, ocab_attn = attention_flops_per_px(net)
    flops = px * s["groups"] * (s["blocks"] * hab_attn + ocab_attn) * PASSES[precision]
    width = 4 if precision == "high" else 2
    nbytes = px * s["groups"] * (s["blocks"] + 1) * 4 * s["c"] * width
    return flops, nbytes


def launches(h10: int, w10: int, net: dict, batch: int) -> int:
    """Window-attention launches of one call: one per HAB and OCAB a batch."""
    s = shape(net)
    n = tile_patches(h10, w10, net)
    return -(-n // batch) * s["groups"] * (s["blocks"] + 1)
