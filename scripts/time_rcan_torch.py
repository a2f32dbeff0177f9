#!/usr/bin/env python3
"""Time RCAN's kernels on one NVIDIA GPU at the shape of the rcan.roi cell's
batches, [64, 128, 128, 64], at "high" and "default".

    python scripts/time_rcan_torch.py [--root DIR]

One JSON line per case, after the card's name and power limit: conv1 (the
conv kernel at C = 64 with the ReLU epilogue), conv2 (the pooling
epilogue), the gate (ca_gate_kernel), one RCAB (the three launches) and the
group conv (the residual epilogue at scale 1), launched as chip_smoke.py's
phase 8 launches them. Each: mean device time by CUDA events over 20 calls
after one warm-up; its operations and bytes (chip_smoke.rcan_work: products
x3 at bf16x3; each input read once and each output written once at its own
dtype, bf16 planes, f32 x, y and out, the per-warp sums, the packed
weights), its bound (operations at 989 TFLOP/s against bytes at 3.35 TB/s;
for a block, the sum of its three launches' bounds) and the share; the
plain version's time (ops/channel_attention, f32 convs with TF32 off) and a
library yardstick (cuDNN's conv in bf16 for a conv, the gate as PyTorch
ops), which the port never calls. To compare two versions on one card, run
the script of each --root in turns, a b b a.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 20


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_rcan_torch: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke

    sys.path.insert(0, os.path.abspath(args.root))
    from dsen2_tpu_torch.ops import channel_attention as ca
    from dsen2_tpu_torch.ops import resblock_chain as rc
    from dsen2_tpu_torch.ops._build import load_library

    card = chip_smoke.smi()
    print(f"nvidia-smi: {card}; package {rc.__file__}", flush=True)
    lib = load_library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = chip_smoke.RCAN_SHAPE
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device=dev)
    wt = torch.randn((3, 3, c, c), generator=gen, device=dev) * (9 * c) ** -0.5
    bias = torch.randn(c, generator=gen, device=dev) * 0.1
    wd, bd = torch.randn((c, 4), generator=gen, device=dev) * 0.1, torch.zeros(4, device=dev)
    wu, bu = torch.randn((4, c), generator=gen, device=dev) * 0.5, torch.zeros(c, device=dev)
    xb, wb = x.permute(0, 3, 1, 2).bfloat16(), wt.permute(3, 2, 0, 1).bfloat16()

    for precision, passes in (("high", 3), ("default", 1)):
        calls, buf = chip_smoke.rcan_launches(torch, lib, x, wt, bias, (wd, bd, wu, bu), passes)

        def rcab():
            calls["conv1"]()
            calls["conv2_pool"]()
            calls["gate"]()

        def plain_conv():
            rc._conv(x, wt, passes)

        def plain_gate():
            ca.ca_gate_plain(x, buf["y"], wd, bd, wu, bu)

        def library_conv():
            F.conv2d(xb, wb, None, padding=1)

        work = {case: chip_smoke.rcan_work(case, shape, passes) for case in chip_smoke.RCAN_CASES}
        bounds = {case: chip_smoke.roofline_ms(*work[case]) for case in work}
        # A block's three launches run one after another: its bound is the
        # sum of theirs.
        launches = ("conv1", "conv2_pool", "gate")
        work["rcab"] = tuple(sum(work[k][i] for k in launches) for i in (0, 1))
        bounds["rcab"] = (sum(bounds[k][0] for k in launches),
                          "+".join(bounds[k][1] for k in launches))
        cases = [("conv1", calls["conv1"], plain_conv, library_conv),
                 ("conv2_pool", calls["conv2_pool"], plain_conv, library_conv),
                 ("gate", calls["gate"], plain_gate, plain_gate),
                 ("rcab", rcab, None, None),
                 ("group_conv", calls["group_conv"], plain_conv, library_conv)]
        for name, fn, plain, library in cases:
            ms = chip_smoke.time_ms(torch, fn, iters=ITERS)
            bound, bound_by = bounds[name]
            row = dict(case=name, shape=list(shape), precision=precision, ms=round(ms, 4),
                       flop=work[name][0], bytes=work[name][1], bound_ms=round(bound, 4),
                       bound_by=bound_by, share_of_bound=round(bound / ms, 4), card=card)
            if plain is not None:
                row["plain_ms"] = round(chip_smoke.time_ms(torch, plain, iters=3), 4)
                row["library_ms"] = round(chip_smoke.time_ms(torch, library, iters=ITERS), 4)
            print(json.dumps(row), flush=True)
        del calls, buf
    return 0


if __name__ == "__main__":
    sys.exit(main())
