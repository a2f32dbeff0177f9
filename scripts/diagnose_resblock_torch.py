#!/usr/bin/env python3
"""Where the residual-block conv kernel's time goes, by ablation, on one GPU.

    python scripts/diagnose_resblock_torch.py

Builds the port's kernel source (dsen2_tpu_torch/csrc/resblock_chain.cu) as
it is and in ablated copies, each with one part of the work taken out,
into build/diagnose/ (all builds run in parallel), and times conv1 (ReLU
epilogue) and conv2 (residual epilogue, writing the next block's planes)
alone at B1's main-path shape [64,128,128,128], at both accuracy classes,
by CUDA events over 10 calls after one warm-up:

- base:            the kernel as committed;
- no_epilogue:     the epilogue stores nothing (its stores sit behind a
                   condition no launch meets, so the wgmmas still run; the
                   warpgroups still take turns);
- no_weight_copy:  no weight slice is copied (each CTA's stage barrier is
                   released at once, the pair's shared release still
                   paces the ring; the products read stale shared memory);
- no_window_copy:  no activation window is loaded (the window barrier is
                   released at once);
- compute_only:    all three taken out: the wgmma issue loop alone.

The same five variants ran on the earlier schedule (both warpgroups on one tile,
the epilogue at once): run this script of that tree to compare.

The ablated kernels compute wrong numbers; only their times mean anything.
Prints the card's name and power limit, then one JSON line per variant.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "dsen2_tpu_torch", "csrc", "resblock_chain.cu")
OUT = os.path.join(ROOT, "build", "diagnose")
SHAPE = (64, 128, 128, 128)
ITERS = 10

# The stores stay behind a condition no launch meets, so that the
# accumulators stay live: with no reader, ptxas deletes the wgmmas.
NO_EPILOGUE = [("          const bool keep = inside[r];",
                "          const bool keep = a.scale == -12345.f;")]
NO_WEIGHTS = [("          mbar_expect_tx(full(stage), K::STAGE_BYTES);",
               "          mbar_arrive(full(stage));"),
              ("          bulk_copy_multicast(stage_base + stage * K::STAGE_BYTES + rank * PART, src, PART,\n"
               "                              full(stage), (1u << kCluster) - 1);",
               "          (void)src;")]
NO_WINDOW = [("          mbar_expect_tx(win_full(wbuf), PLANES * kWinPlaneBytes);\n"
              "          for (int pl = 0; pl < PLANES; ++pl)\n",
              "          mbar_arrive(win_full(wbuf));\n"
              "          for (int pl = 0; pl < 0; ++pl)\n")]
VARIANTS = {
    "base": [],
    "no_epilogue": NO_EPILOGUE,
    "no_weight_copy": NO_WEIGHTS,
    "no_window_copy": NO_WINDOW,
    "compute_only": NO_EPILOGUE + NO_WEIGHTS + NO_WINDOW,
}


def build_all():
    from dsen2_tpu_torch.ops._build import _FLAGS, _nvcc

    with open(SRC) as fh:
        src = fh.read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        so = os.path.join(OUT, f"{name}.so")
        procs[name] = (so, subprocess.Popen([_nvcc(), *_FLAGS, "-o", so, cu],
                                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                            text=True))
    libs = {}
    for name, (so, p) in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err[-3000:]}")
        libs[name] = so
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("diagnose_resblock_torch: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from dsen2_tpu_torch.ops._build import _declare
    from dsen2_tpu_torch.ops.resblock_chain import pack_weights, split_planes

    card = chip_smoke.smi()
    print(f"nvidia-smi: {card}", flush=True)
    libs = build_all()
    b, h, w, c = SHAPE
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(0)
    x, w1, b1, _, _ = chip_smoke.case_inputs(torch, gen, SHAPE, 1, "float32")
    wt, bias = w1[0], b1[0]
    stream = torch.cuda.current_stream().cuda_stream
    flop = 2 * b * h * w * 9 * c * c
    for name, so in libs.items():
        lib = _declare(ctypes.CDLL(so))
        row = dict(variant=name, shape=list(SHAPE), card=card)
        for passes in (3, 1):
            packed = pack_weights(wt, passes)
            planes = split_planes(x, passes).contiguous()
            t, nxt = torch.empty_like(planes), torch.empty_like(planes)
            out = torch.empty_like(x)

            def conv1():
                return lib.dsen2_conv3x3(planes.data_ptr(), packed.data_ptr(), bias.data_ptr(),
                                         None, None, t.data_ptr(), b, h, w, c, 1.0, passes, 0,
                                         0, stream)

            def conv2():
                return lib.dsen2_conv3x3(t.data_ptr(), packed.data_ptr(), bias.data_ptr(),
                                         x.data_ptr(), out.data_ptr(), nxt.data_ptr(), b, h, w,
                                         c, 0.1, passes, 0, 1, stream)

            for label, fn in (("conv1", conv1), ("conv2", conv2)):
                if fn() != 0:
                    raise RuntimeError(f"{name} {label} launch failed")
                ms = chip_smoke.time_ms(torch, fn, iters=ITERS)
                bound = 1e3 * flop * passes / chip_smoke.PEAK_BF16_FLOPS
                row[f"{label}_passes{passes}_ms"] = round(ms, 4)
                row[f"{label}_passes{passes}_share_of_bound"] = round(bound / ms, 4)
        print(json.dumps(row), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
