#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines and its seconds:

1. environment: the card, its power limit, torch and CUDA, and the build of
   the CUDA kernels from dsen2_tpu_torch/csrc/ into build/kernels/, with
   ptxas's registers and spills for each kernel (any spill fails the run);
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes: error against a stated limit, kernel / plain / library
   times, the bound, the achieved bf16 TFLOP/s and the share of the bound;
   DSen2's head and tail kernels at dsen2_20's and dsen2_60's batches (F =
   128) and at VDSen2 2x's (F = 256) in both classes against the plane products in float64 (PLANE_TOL), the
   head's planes bit-equal to split_planes of its x, with times, bytes
   bound, share, the plain version's time and the class conv's;
3. the main path at full DSen2 width (6 blocks x 128 features) with the
   shipped weights: dsen2_20 and dsen2_60 on a seeded synthetic uint16
   2400 x 2400 scene at "high" and "default", each held to the port's own
   "highest" output, plus one B2-route run (patch 132, "default") and one
   run under torch.inference_mode(); every kernel's launch count must rise,
   and a dsen2_20 "high" run must count one head and one tail launch a batch
   and no plane pass;
4. the full-tile path: dsen2_20 on a seeded 10980 x 10980 uint16 tile at
   "high" and "default" through the banded engine (host output) and the
   one-shot path (device output, then one copy), each with its wall time,
   peak device memory and device idle share from one profiled call; the
   banded mosaic must equal the one-shot one and use less device memory;
   dsen2_60 banded; uint16 output against the rounded float32 one, with the
   bytes read back; the self-ensemble at 3000^2 (banded route) and 2400^2
   (whole-tile route) against the mean of the 8 transformed runs computed
   here; the B2 route (patch 132) banded; and the demo's run_scene on a
   seeded 600^2 .mat. Both kernels' launch counts must rise; the head and
   tail kernels' device time per tile at "high" and "default", with no
   cuDNN conv;
5. training: the class conv's plane pass against its plain split at
   PLANE_SHAPES, both classes (ms, bytes bound, share; bit-equal); the TF32
   plane convs of ops/conv.py (forward, dgrad, wgrad) held
   to the same plane convs in float64 within PLANE_TOL x max|ref|; fit for DSen2 2x
   at full width (batch 128 of 32^2 crops, 2 epochs) host-fed at "high" and
   staged at "default", whose loss must fall; the warm step time, patches/s,
   peak memory and the convs' share of one profiled step at each class, a
   step at "high" and "default" counting 42 plane passes and 14 backward
   calls on kept planes (conv.plane_passes, conv.planes_kept); one
   step's gradients at "high" and "default" against "highest" (E2E_TOL);
   1 + 1 resumed epochs against 2 straight; a few steps of the 6x net (96^2
   crops) and of VDSen2 2x with remat; `cli.train --smoke`. Training runs
   plain convs, so neither residual-block kernel may launch in this phase;
6. the production CLIs: whether the host has GDAL and Pillow with JPEG 2000;
   s2_supres --run_60 --output-dtype uint16 on a seeded full 10980^2 L1C
   product held in memory and read through safe_reader's GDAL seam (read,
   SR 6x, SR 2x and write seconds, wall, file size, and one profiled run's
   device idle share), its GeoTIFF's SR bands bit-equal to dsen2_20 /
   dsen2_60 on the same arrays, with the product's EPSG code and tiepoint,
   through the banded engine; the same on a seeded JP2 product through the
   Pillow backend at a pixel and a lon/lat ROI (or a line saying the JP2
   decoder is absent); create_patches on a seeded .mat scene, then
   --make-val-index and one streamed epoch of cli.train --stream at full
   width ("default"; finite loss, no kernel launch); convert_weights
   round-tripping the shipped DSen2 .npz. B1 must launch in every s2_supres
   run;
7. the mesh (dsen2_tpu_torch/parallel/) on meshes that repeat the one card:
   the shard workers' streams; dsen2_20 on phase 4's 10980^2 tile at
   "default" over 4 shards against phase 4's banded mosaic (wall, peak
   memory, bit-equality); dsen2_60 2400^2 "high" over 3 shards, the
   patch-132 route (B2) over 2, sr_tiles_sharded on 4 tiles over 4, and the
   mesh ensemble, each against the single-device result; one data-parallel
   train step (batch 128 of 32^2, "high", 2 shards) against the unsharded
   step, and a staged fit(mesh=) at "default" whose loss falls, neither
   launching a kernel; s2_supres --mesh 2 without a device must raise the
   too-few-devices error on a one-GPU machine. B1 and B2 must launch;
8. RCAN (ops/channel_attention.py): the conv kernel at C = 64 with its
   ReLU and residual epilogues, the pooling epilogue and the gate kernel,
   each against its plain version at the rcan.roi cell's batch shape
   [64, 128, 128, 64] in both classes, with times, bounds and shares (bytes
   at each launch's own dtypes); RCAN's body at published widths (10 x 20 x
   64) on that shape through rcan_body against rcan_body_plain at "high"
   and "default"; its launches, by the program's counters, must follow its
   groups and blocks;
9. one {"kernels": [...]} JSON line, B1's, B2's, the head's and the tail's
   launches counted over phases 3, 4, 6 and 7, the plane pass's over phases
   3 to 7 (phase 5's training), RCAN's three kernels' over phase 8's body
   runs;
10. the card's name and power limit, then {"ok": true, "device": {...}}.

Any failed check exits non-zero before the last line. Without a CUDA device,
or without the dsen2_tpu_torch package beside it, the script fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Published dense peaks of one H100 SXM (NVIDIA data sheet) and its HBM rate.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# Kernel vs plain version, as a fraction of max|plain|. bf16x3 and the plain
# version's emulated bf16x3 form the same products and differ only in the
# order of f32 sums. One pass rounds f32 operands to bf16 (8 bits of
# mantissa) where the plain version computes in f32; bf16 activations round
# the output to bf16.
KERNEL_TOL = {("float32", 3): 1e-4, ("float32", 1): 1e-2, ("bfloat16", 1): 1e-2}
# End to end, against the "highest" mosaic, as a fraction of its max DN.
E2E_TOL = {"high": 2e-4, "default": 1e-2}


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 3) -> float:
    """Mean device time of fn() over `iters` runs after one warm-up, by CUDA
    events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def library_chain(torch, x, w1, b1, w2, b2, scale, tf32):
    """The same K blocks as one cuDNN conv call per conv, channels-last, at
    the kernel's accuracy class. A yardstick only: the port never calls it."""
    F = torch.nn.functional
    y = x.permute(0, 3, 1, 2)
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        for k in range(w1.shape[0]):
            t = torch.relu(F.conv2d(y, w1[k].permute(3, 2, 0, 1), b1[k], padding=1))
            y = y + scale * F.conv2d(t, w2[k].permute(3, 2, 0, 1), b2[k], padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm
    return y.permute(0, 2, 3, 1)


def bound_ms(shape, k, passes, itemsize):
    """Least time on the card: operations at the bf16 tensor peak (x3 terms
    for bf16x3) against x read once, out written once and the f32 weights
    read once at the HBM rate. Returns (ms, bound_by, flop, bytes)."""
    b, h, w, c = shape
    flop = 2 * b * h * w * 9 * c * c * 2 * k * passes
    nbytes = 2 * b * h * w * c * itemsize + k * 2 * (9 * c * c + c) * 4
    ms, by = roofline_ms(flop, nbytes)
    return ms, by, flop, nbytes


# Phase 2's cases: (kernel, shape, K, dtype, passes). B1 at the main path's
# 2x and 6x patches in both classes, its edges (ragged H and W, bf16
# activations, VDSen2's C = 256), and B2 at the patch-132 route.
CASES = [
    ("chain", (64, 128, 128, 128), 2, "float32", 3),
    ("chain", (64, 128, 128, 128), 2, "float32", 1),
    ("chain", (64, 192, 192, 128), 2, "float32", 3),
    ("chain", (64, 192, 192, 128), 2, "float32", 1),
    ("chain", (2, 36, 20, 128), 2, "float32", 3),
    ("chain", (2, 36, 20, 128), 2, "bfloat16", 1),
    ("chain", (16, 64, 64, 256), 2, "float32", 3),
    ("block", (64, 132, 132, 128), 1, "float32", 1),
]


def case_inputs(torch, gen, shape, k, dtype):
    """x [B,H,W,C] of `dtype` and f32 w1, b1, w2, b2 for K blocks, drawn
    from `gen` at He-like scales."""
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device=gen.device).to(getattr(torch, dtype))
    wstd = (9 * c) ** -0.5
    w1 = torch.randn((k, 3, 3, c, c), generator=gen, device=gen.device) * wstd
    w2 = torch.randn((k, 3, 3, c, c), generator=gen, device=gen.device) * wstd
    b1 = torch.randn((k, c), generator=gen, device=gen.device) * 0.1
    b2 = torch.randn((k, c), generator=gen, device=gen.device) * 0.1
    return x, w1, b1, w2, b2


def case_calls(chain_mod, block_mod, kind, passes, x, w1, b1, w2, b2):
    """(kernel call, plain call) of one case: B1 runs all K blocks, B2 the
    first one."""
    if kind == "chain":
        def kern():
            return chain_mod.fused_resblock_chain(x, w1, b1, w2, b2, scale=0.1, passes=passes)

        def plain():
            return chain_mod.resblock_chain_plain(x, w1, b1, w2, b2, scale=0.1, passes=passes)
    else:
        def kern():
            return block_mod.fused_resblock(x, w1[0], b1[0], w2[0], b2[0], scale=0.1,
                                            tile_rows=4)

        def plain():
            return block_mod.fused_resblock_plain(x, w1[0], b1[0], w2[0], b2[0], scale=0.1)
    return kern, plain


def phase_kernels(torch, chain_mod, block_mod):
    """Each kernel against its plain version at main-path shapes."""
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(0)
    results = {}
    for kind, shape, k, dtype, passes in CASES:
        td = getattr(torch, dtype)
        x, w1, b1, w2, b2 = case_inputs(torch, gen, shape, k, dtype)
        kern, plain = case_calls(chain_mod, block_mod, kind, passes, x, w1, b1, w2, b2)
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        err = (got.float() - want.float()).abs().max().item()
        limit = KERNEL_TOL[(dtype, passes)] * want.float().abs().max().item()
        ok = bool(np.isfinite(err)) and err <= limit
        del got, want
        ms = time_ms(torch, kern)
        plain_ms = time_ms(torch, plain, iters=1)
        tf32 = dtype == "float32" and passes == 1
        wl = [t.to(td) for t in (w1, b1, w2, b2)]
        lib_ms = time_ms(torch, lambda: library_chain(torch, x, *wl, 0.1, tf32))
        lib_class = {("float32", 3): "f32 convs, TF32 off", ("float32", 1): "f32 convs, TF32 on",
                     ("bfloat16", 1): "bf16 convs"}[(dtype, passes)]
        if (dtype, passes) == ("float32", 1):
            # The one-pass class is bf16 operands with f32 sums: cuDNN's bf16
            # convs, not TF32, compute the same function.
            xb, wb = x.to(torch.bfloat16), [t.to(torch.bfloat16) for t in (w1, b1, w2, b2)]
            lib_tf32_ms = lib_ms
            lib_ms = time_ms(torch, lambda: library_chain(torch, xb, *wb, 0.1, False))
            lib_class = f"bf16 convs; f32 convs with TF32 on {lib_tf32_ms:.4f} ms"
            del xb, wb
        bms, by, flop, nbytes = bound_ms(shape, k, passes, x.element_size())
        print(f"kernel {kind} {list(shape)} K={k} {dtype} passes={passes}: "
              f"max_abs_err={err:.3e} (limit {KERNEL_TOL[(dtype, passes)]} x max|plain| = "
              f"{limit:.3e}) ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
              f"({lib_class}) bound_ms={bms:.4f} ({by}: {flop:.3e} flop at "
              f"{PEAK_BF16_FLOPS:.3e} bf16 flop/s, {nbytes:.3e} B at {PEAK_BYTES:.3e} B/s) "
              f"achieved {flop / (ms * 1e-3) / 1e12:.1f} bf16 TFLOP/s, "
              f"{100 * bms / ms:.1f} % of the bound -> {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"kernel {kind} {shape} {dtype} passes={passes} disagrees with its plain version")
        results[(kind, shape, dtype, passes)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bms, bound_by=by)
        del x, w1, w2, b1, b2
        torch.cuda.empty_cache()
    return results


# DSen2's head and tail kernels (ops/head_tail.py) at the main path's
# batches: (name, [B, H, W], input channels, output channels, F) of dsen2_20
# and dsen2_60 at F = 128, and of VDSen2's 2x net (the vdsen2.roi cell) at
# F = 256.
EDGE_CASES = (("2x", (64, 128, 128), (4, 6), 6, 128), ("6x", (64, 192, 192), (4, 6, 2), 2, 128),
              ("vd2x", (64, 128, 128), (4, 6), 6, 256))


def edge_work(kind, shape, cin, cout, f, passes):
    """(flop, bytes) the head or the tail must do for one call: the class's
    bf16 products; the inputs read once and x (and at the head its planes,
    which B1 reads) written once, or x read once and the residual and the
    output moved once, plus the f32 weights, at each buffer's dtype."""
    px = int(np.prod(shape))
    if kind == "head":
        flop = 2 * px * 9 * sum(cin) * f * passes
        nbytes = px * (4 * sum(cin) + 4 * f + 2 * f * (2 if passes == 3 else 1))
        return flop, nbytes + 4 * (9 * sum(cin) * f + f)
    flop = 2 * px * 9 * f * cout * passes
    return flop, px * (4 * f + 2 * 4 * cout) + 4 * (9 * f * cout + cout)


def phase_edges(torch):
    """The head and tail kernels against the class's plane products in
    float64 (within PLANE_TOL x max|ref|; the head's planes bit-equal to
    split_planes of its x) at EDGE_CASES in both classes: 20-call means, the
    bound (edge_work), the share, the plain version's time (head_plain with
    the planes, tail_plain) and the class conv's alone (cuDNN's TF32 plane
    convs, ops/conv.py::conv3x3) as the library yardstick. Returns {(kind,
    case, precision): result} in phase 2's form."""
    import torch.nn.functional as F

    from dsen2_tpu_torch.ops import head_tail
    from dsen2_tpu_torch.ops.conv import conv3x3
    from dsen2_tpu_torch.ops.resblock_chain import split_planes

    def ref(x, w, b, passes):
        xp, wp = split_planes(x, passes).double(), split_planes(w, passes).double()

        def conv(a, k):
            y = F.conv2d(a.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), padding=1)
            return y.permute(0, 2, 3, 1)

        y = conv(xp[0], wp[0])
        if passes == 3:
            y = y + conv(xp[1], wp[0]) + conv(xp[0], wp[1])
        return y + b.double()

    gen = torch.Generator(device="cuda").manual_seed(5)
    results = {}
    for case, shape, cin, cout, f in EDGE_CASES:
        inputs = [torch.rand((*shape, c), generator=gen, device="cuda") for c in cin]
        cat = torch.cat(inputs, dim=-1)
        hw = torch.randn((3, 3, sum(cin), f), generator=gen, device="cuda") * (
            9 * sum(cin)) ** -0.5
        hb = torch.randn((f,), generator=gen, device="cuda") * 0.1
        tw = torch.randn((3, 3, f, cout), generator=gen, device="cuda") * (9 * f) ** -0.5
        tb = torch.randn((cout,), generator=gen, device="cuda") * 0.1
        for prec in ("high", "default"):
            passes = 3 if prec == "high" else 1
            x, planes = head_tail.head(inputs, hw, hb, prec, planes=True)
            torch.cuda.synchronize()
            want = ref(cat, hw, hb, passes).clamp_min(0)
            errs = {"head": ((x.double() - want).abs().max() / want.abs().max()).item()}
            del want
            check(torch.equal(planes.view(torch.int16), split_planes(x, passes).view(torch.int16)),
                  f"head {case} {prec}: its planes differ from split_planes of its x")
            y = head_tail.tail(x, tw, tb, inputs[-1], prec)
            torch.cuda.synchronize()
            want = ref(x, tw, tb, passes) + inputs[-1].double()
            errs["tail"] = ((y.double() - want).abs().max() / want.abs().max()).item()
            del want, y, planes
            calls = {
                "head": (lambda: head_tail.head(inputs, hw, hb, prec, planes=True),
                         lambda: head_tail.head_plain(inputs, hw, hb, prec, planes=True),
                         lambda: conv3x3(cat, hw, hb, prec)),
                "tail": (lambda: head_tail.tail(x, tw, tb, inputs[-1], prec),
                         lambda: head_tail.tail_plain(x, tw, tb, inputs[-1], prec),
                         lambda: conv3x3(x, tw, tb, prec)),
            }
            for kind, (kern, plain, library) in calls.items():
                ms = time_ms(torch, kern, iters=20)
                plain_ms = time_ms(torch, plain, iters=20)
                lib_ms = time_ms(torch, library, iters=20)
                flop, nbytes = edge_work(kind, shape, cin, cout, f, passes)
                bms, by = roofline_ms(flop, nbytes)
                ok = errs[kind] <= PLANE_TOL
                print(f"{kind} kernel {case} {list(shape)} F={f} {prec}: max|err| "
                      f"{errs[kind]:.2e} x max|ref| against the plane products in float64 "
                      f"(limit {PLANE_TOL}); ms={ms:.4f} (20-call mean) plain_ms={plain_ms:.4f} "
                      f"library_ms={lib_ms:.4f} (the class conv, cuDNN's TF32 plane convs) "
                      f"bound_ms={bms:.4f} ({by}: {flop:.3e} flop, {nbytes:.3e} B) "
                      f"{100 * bms / ms:.1f} % of the bound -> {'ok' if ok else 'FAIL'}",
                      flush=True)
                check(ok, f"{kind} kernel {case} {prec} strays from the plane products")
                results[(kind, case, prec)] = dict(max_abs_err=errs[kind], ms=ms, plain_ms=plain_ms,
                                                   library_ms=lib_ms, bound_ms=bms, bound_by=by)
            del x
        del inputs, cat
        torch.cuda.empty_cache()
    return results


# RCAN's kernels (ops/channel_attention.py) at the rcan.roi cell's batch: 64
# patches of 128 x 128 at RCAN's 64 features.
RCAN_SHAPE = (64, 128, 128, 64)
RCAN_CASES = ("conv1", "conv2_pool", "gate", "group_conv")


def rcan_work(case, shape, passes, squeeze=4):
    """(flop, bytes) of one launch of an RCAN kernel on `shape`: its
    products (x3 at bf16x3) and what it reads and writes once each at its
    own dtype: bf16 planes (2 at bf16x3, 1 at one pass), f32 x, y, residual
    and out, the per-warp sums, the packed bf16 weights and the f32 biases.
    conv1 (ReLU epilogue): planes in, planes of t out. conv2_pool: planes
    in, y and the sums out. gate: x, y and the sums in, out and its planes
    out. group_conv (residual epilogue): planes and the residual in, out
    and its planes out."""
    from dsen2_tpu_torch.ops.channel_attention import pool_rows

    b, h, w, c = shape
    n, planes = b * h * w * c, 2 if passes == 3 else 1
    plane_bytes, sums = 2 * planes * n, b * pool_rows(h, w) * c * 4
    conv_flop = 2 * b * h * w * 9 * c * c * passes
    weights = 9 * c * c * 2 * planes + c * 4
    return {
        "conv1": (conv_flop, 2 * plane_bytes + weights),
        "conv2_pool": (conv_flop, plane_bytes + 4 * n + sums + weights),
        "gate": (0, 12 * n + plane_bytes + sums + (2 * c * squeeze + squeeze + c) * 4),
        "group_conv": (conv_flop, 2 * plane_bytes + 8 * n + weights),
    }[case]


def roofline_ms(flop, nbytes):
    """(ms, bound_by): operations at the bf16 tensor peak against bytes at
    the HBM rate, whichever takes longer."""
    t_ops, t_bytes = flop / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def rcan_launches(torch, lib, x, wt, bias, gate_w, passes):
    """Each RCAN kernel as rcan_body launches it, on x [B, H, W, 64], one
    conv's HWIO weights `wt` and `bias`, and the attention's (wd, bd, wu,
    bu): {case: call} and the buffers the calls write. conv1 reads x's
    planes; conv2_pool reads conv1's t; the gate reads x, conv2's y and sums;
    group_conv reads x's planes with x as the residual."""
    from dsen2_tpu_torch.ops import channel_attention as ca
    from dsen2_tpu_torch.ops import resblock_chain as rc

    b, h, w, c = x.shape
    wd, bd, wu, bu = gate_w
    planes = rc.split_planes(x, passes).contiguous()
    packed = rc.pack_weights(wt, passes)
    buf = dict(t=torch.empty_like(planes), y=torch.empty_like(x),
               pool=torch.empty((b, ca.pool_rows(h, w), c), device=x.device),
               gate_out=torch.empty_like(x), gate_planes=torch.empty_like(planes),
               conv_out=torch.empty_like(x), conv_planes=torch.empty_like(planes))
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def conv1():
        rc._check(lib.dsen2_conv3x3(planes.data_ptr(), packed.data_ptr(), bias.data_ptr(), None,
                                    None, buf["t"].data_ptr(), b, h, w, c, 1.0, passes, 0, 0,
                                    stream), "conv1")

    def conv2_pool():
        rc._check(lib.dsen2_conv3x3_pool(buf["t"].data_ptr(), packed.data_ptr(),
                                         bias.data_ptr(), buf["y"].data_ptr(),
                                         buf["pool"].data_ptr(), b, h, w, c, passes, stream),
                  "conv2")

    def gate():
        rc._check(lib.dsen2_ca_gate(x.data_ptr(), buf["y"].data_ptr(), buf["pool"].data_ptr(),
                                    wd.data_ptr(), bd.data_ptr(), wu.data_ptr(), bu.data_ptr(),
                                    buf["gate_out"].data_ptr(), buf["gate_planes"].data_ptr(),
                                    b, h, w, c, wd.shape[-1], passes, stream), "gate")

    def group_conv():
        rc._check(lib.dsen2_conv3x3(planes.data_ptr(), packed.data_ptr(), bias.data_ptr(),
                                    x.data_ptr(), buf["conv_out"].data_ptr(),
                                    buf["conv_planes"].data_ptr(), b, h, w, c, 1.0, passes, 0,
                                    1, stream), "group conv")

    return dict(conv1=conv1, conv2_pool=conv2_pool, gate=gate, group_conv=group_conv), buf


def phase_rcan(torch):
    """RCAN's kernels on the card: the conv kernel at C = 64 with its ReLU
    and residual epilogues, the pooling epilogue and ca_gate_kernel, each
    against its plain version at RCAN_SHAPE in both classes, with times,
    bounds and shares; then RCAN's body at published widths (10 groups x 20
    RCABs x 64 features) on RCAN_SHAPE through rcan_body against
    rcan_body_plain, at "high" and "default", the launches counted by the
    program's counters from just before these runs. Returns ({(case,
    precision): result}, launches of each kernel)."""
    from dsen2_tpu_torch.models import rcan
    from dsen2_tpu_torch.ops import channel_attention as ca
    from dsen2_tpu_torch.ops import resblock_chain as rc
    from dsen2_tpu_torch.ops._build import load_library
    from dsen2_tpu_torch.utils import profiling
    from dsen2_tpu_torch.weights import params_to_torch

    F = torch.nn.functional
    lib = load_library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    b, h, w, c = RCAN_SHAPE
    x = torch.randn(RCAN_SHAPE, generator=gen, device=dev)
    wt = torch.randn((3, 3, c, c), generator=gen, device=dev) * (9 * c) ** -0.5
    bias = torch.randn(c, generator=gen, device=dev) * 0.1
    gate_w = (torch.randn((c, 4), generator=gen, device=dev) * 0.2,
              torch.randn(4, generator=gen, device=dev),
              torch.randn((4, c), generator=gen, device=dev) * 0.5,
              torch.randn(c, generator=gen, device=dev))
    xb, wb = x.permute(0, 3, 1, 2).bfloat16(), wt.permute(3, 2, 0, 1).bfloat16()
    results = {}
    for precision, passes in (("high", 3), ("default", 1)):
        calls, buf = rcan_launches(torch, lib, x, wt, bias, gate_w, passes)
        tol = KERNEL_TOL[("float32", passes)]
        for case in RCAN_CASES:
            calls[case]()
            torch.cuda.synchronize()
            # The plain version of each case on the kernel's own inputs: y
            # from the kernel's t, the gate from the kernel's y and sums.
            t = buf["t"].float().sum(0)
            plain = {
                "conv1": lambda: torch.relu(rc._conv(x, wt, passes) + bias),
                "conv2_pool": lambda: rc._conv(t, wt, passes) + bias,
                "gate": lambda: ca._gate_from_pool(x, buf["y"], buf["pool"], *gate_w),
                "group_conv": lambda: x + (rc._conv(x, wt, passes) + bias),
            }[case]
            got = {"conv1": t, "conv2_pool": buf["y"], "gate": buf["gate_out"],
                   "group_conv": buf["conv_out"]}[case]
            want = plain()
            err = (got - want).abs().max().item()
            limit = (1e-6 if case == "gate" else tol) * want.abs().max().item()
            ok = bool(np.isfinite(err)) and err <= limit
            if case == "conv2_pool":
                sums = ca.pool_sums_plain(buf["y"])
                pool_err = (buf["pool"] - sums).abs().max().item()
                ok = ok and pool_err <= 1e-5 * sums.abs().max().item()
                err_text = f"max_abs_err={err:.3e}, sums {pool_err:.3e}"
            else:
                err_text = f"max_abs_err={err:.3e}"
            ms = time_ms(torch, calls[case], iters=20)
            plain_ms = time_ms(torch, plain, iters=1)
            if case == "gate":
                library_ms, lib_class = plain_ms, "the plain gate's PyTorch ops"
            else:
                library_ms = time_ms(torch, lambda: F.conv2d(xb, wb, None, padding=1), iters=20)
                lib_class = "cuDNN bf16 conv"
            flop, nbytes = rcan_work(case, RCAN_SHAPE, passes)
            bms, by = roofline_ms(flop, nbytes)
            print(f"rcan {case} {list(RCAN_SHAPE)} {precision}: {err_text} (limit "
                  f"{limit:.3e}) ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
                  f"{library_ms:.4f} ({lib_class}) bound_ms={bms:.4f} ({by}: {flop:.3e} flop, "
                  f"{nbytes:.4e} B) {100 * bms / ms:.1f} % of the bound -> "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"rcan {case} {precision} disagrees with its plain version")
            results[(case, precision)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                              library_ms=library_ms, bound_ms=bms, bound_by=by)
            del t, got, want
        del calls, buf
        torch.cuda.empty_cache()

    # The body at published widths, as the rcan.roi cell's batches run it.
    cfg = rcan.rcan_2x()
    params = params_to_torch(rcan.init_params(torch.Generator().manual_seed(2), cfg), dev)
    f0 = torch.randn(RCAN_SHAPE, generator=gen, device=dev) * 0.5
    n_rcab = cfg.groups * cfg.blocks
    before = profiling.counters()
    for precision, passes in (("high", 3), ("default", 1)):
        t0 = time.perf_counter()
        got = ca.rcan_body(f0, params, passes=passes)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        ms = time_ms(torch, lambda: ca.rcan_body(f0, params, passes=passes), iters=2)
        t0 = time.perf_counter()
        want = ca.rcan_body_plain(f0, params, passes=passes)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        err = (got - want).abs().max().item()
        limit = KERNEL_TOL[("float32", passes)] * want.abs().max().item()
        flop = rcan_work("conv1", RCAN_SHAPE, passes)[0] * (2 * n_rcab + cfg.groups + 1)
        print(f"rcan body {cfg.groups}x{cfg.blocks}x{cfg.features} {list(RCAN_SHAPE)} "
              f"{precision}: cold {cold:.3f} s, warm {ms:.2f} ms ({flop / (ms * 1e-3) / 1e12:.1f} "
              f"bf16 TFLOP/s of the convs), plain {plain_s:.3f} s; max|kernels - plain| "
              f"{err:.3e} (limit {limit:.3e}), max|plain| {want.abs().max().item():.3f}",
              flush=True)
        check(bool(torch.isfinite(got).all()) and err <= limit,
              f"rcan body {precision} strays from rcan_body_plain")
        del got, want
    after = profiling.counters()
    launches = {k: after.get(k, 0) - before.get(k, 0)
                for k in ("rcan.convs", "rcan.blocks", "rcan.gates")}
    print(f"rcan body launches: {launches} (counters rcan.convs, rcan.blocks, rcan.gates)",
          flush=True)
    calls = 2 * 4  # each class: the cold run, time_ms's warm-up and its two runs
    check(launches == {"rcan.convs": calls * (n_rcab + cfg.groups + 1),
                       "rcan.blocks": calls * n_rcab, "rcan.gates": calls * n_rcab},
          "rcan body launches do not follow its groups and blocks")
    del params, f0
    torch.cuda.empty_cache()
    return results, launches


def synthetic_scene(seed: int, h10: int):
    """A seeded uint16 scene on the 10/20/60 m grids: smooth fields of
    reflectance-like DN plus noise."""
    rng = np.random.default_rng(seed)

    def raster(h, c):
        coarse = rng.uniform(300, 6000, size=(h // 24 + 2, h // 24 + 2, c))
        field = np.repeat(np.repeat(coarse, 24, axis=0), 24, axis=1)[:h, :h]
        noise = rng.normal(0, 150, size=(h, h, c))
        return np.clip(field + noise, 0, 65535).astype(np.uint16)

    return raster(h10, 4), raster(h10 // 2, 6), raster(h10 // 6, 2)


def phase_main_path(torch, api, weights, chain_mod, block_mod, card):
    from dsen2_tpu_torch.core.config import InferConfig
    from dsen2_tpu_torch.utils import profiling

    models = os.path.join(HERE, "models")
    params20 = weights.load_params_npz(os.path.join(models, "s2_032_lr_1e-04.npz"))
    params60 = weights.load_params_npz(os.path.join(models, "s2_030_lr_1e-05.npz"))
    d10, d20, d60 = synthetic_scene(0, 2400)
    mp = d10.shape[0] * d10.shape[1] / 1e6
    runs = {
        "dsen2_20": (lambda cfg: api.dsen2_20(d10, d20, params=params20, infer_cfg=cfg), 128, 8),
        "dsen2_60": (lambda cfg: api.dsen2_60(d10, d20, d60, params=params60, infer_cfg=cfg),
                     192, 12),
    }
    chain_mod.fused_resblock_chain.launches = 0
    block_mod.fused_resblock.launches = 0
    for name, (run, patch, border) in runs.items():
        t0 = time.perf_counter()
        ref = run(InferConfig(patch_size=patch, border=border, precision="highest"))
        t_ref = time.perf_counter() - t0
        check(ref.shape[:2] == d10.shape[:2] and np.isfinite(ref).all(), f"{name} highest output")
        print(f"{name} precision=highest: {t_ref:.3f} s (plain f32 convs, TF32 off), "
              f"shape {ref.shape}", flush=True)
        for prec in ("high", "default"):
            cfg = InferConfig(patch_size=patch, border=border, precision=prec)
            t0 = time.perf_counter()
            out = run(cfg)
            cold = time.perf_counter() - t0
            warm = []
            for _ in range(3):
                t0 = time.perf_counter()
                out = run(cfg)
                warm.append(time.perf_counter() - t0)
            w = statistics.median(warm)
            diff = np.abs(out - ref)
            limit = E2E_TOL[prec] * np.abs(ref).max()
            rmse = float(np.sqrt(np.mean((out.astype(np.float64) - ref) ** 2)))
            print(f"{name} precision={prec}: cold {cold:.3f} s, warm {w:.3f} s (median of 3), "
                  f"{mp / w:.2f} MP/s on {card}; max|diff vs highest| {diff.max():.3f} DN "
                  f"(limit {limit:.3f}), rmse {rmse:.4f} DN", flush=True)
            check(out.shape == ref.shape and np.isfinite(out).all(), f"{name} {prec} output")
            check(diff.max() <= limit, f"{name} {prec} strays from highest")
            if name == "dsen2_20" and prec == "high":
                high20 = out

    # B2 route: patch 132 has no 8-row tile, so "default" takes fused_resblock.
    before = block_mod.fused_resblock.launches
    ref132 = runs["dsen2_20"][0](InferConfig(patch_size=132, border=8, precision="highest"))
    t0 = time.perf_counter()
    out132 = runs["dsen2_20"][0](InferConfig(patch_size=132, border=8, precision="default"))
    t132 = time.perf_counter() - t0
    diff = np.abs(out132 - ref132).max()
    limit = E2E_TOL["default"] * np.abs(ref132).max()
    print(f"dsen2_20 patch 132 default (fused_resblock): {t132:.3f} s; max|diff vs highest| "
          f"{diff:.3f} DN (limit {limit:.3f})", flush=True)
    check(block_mod.fused_resblock.launches > before, "patch 132 default did not reach B2")
    check(diff <= limit, "patch 132 default strays from highest")

    with torch.inference_mode():
        out_im = runs["dsen2_20"][0](InferConfig(patch_size=128, border=8, precision="high"))
    diff = np.abs(out_im - high20).max()
    print(f"dsen2_20 high under torch.inference_mode(): max|diff vs no_grad run| {diff:.3e} DN",
          flush=True)
    check(diff <= E2E_TOL["high"] * np.abs(high20).max(), "inference_mode run differs")

    launches = {"fused_resblock_chain": chain_mod.fused_resblock_chain.launches,
                "fused_resblock": block_mod.fused_resblock.launches}
    print(f"main-path launches: {launches}", flush=True)
    for k, n in launches.items():
        check(n > 0, f"{k} was not launched on the main path")

    # Where the device time goes in one warm dsen2_20 "high" run.
    from torch.profiler import ProfilerActivity, profile

    cfg = InferConfig(patch_size=128, border=8, precision="high")
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runs["dsen2_20"][0](cfg)
        wall = time.perf_counter() - t0
    # Each batch runs one head and one tail kernel, and no plane pass.
    passes, heads, tails, patches = (
        profiling.counters().get(k, 0) - before.get(k, 0)
        for k in ("conv.plane_passes", "s2net.heads", "s2net.tails", "infer.patches"))
    batches = -(-patches // cfg.batch_size)
    print(f"dsen2_20 high: {heads:.0f} head and {tails:.0f} tail launches, {passes:.0f} plane "
          f"passes in {batches:.0f} batches of up to {cfg.batch_size} patches (counters "
          f"s2net.heads, s2net.tails, conv.plane_passes)", flush=True)
    check(heads == tails == batches and passes == 0,
          "dsen2_20 high: the head and tail do not run as one kernel each a batch")
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profile dsen2_20 high: wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / (wall * 1e3):.1f} %)", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<5d} {e.key[:90]}")
    return launches


# Phase 4's sizes: a whole L1C tile on the 10 m grid, tiled from a seeded
# scene of TILE_BASE px; the ensemble at a banded and a whole-tile size.
FULL_TILE, TILE_BASE = 10980, 2196
ENSEMBLE_SIZES = ((3000, "banded"), (2400, "whole-tile"))


def tiled_scene(seed: int, h10: int, base: int):
    """A seeded uint16 scene of h10 x h10 px (h10 a multiple of `base`),
    tiled from synthetic_scene(seed, base) so that no float64 temporary of
    the whole tile exists."""
    reps = h10 // base
    return tuple(np.tile(r, (reps, reps, 1)) for r in synthetic_scene(seed, base))


def engine_d2h_bytes() -> int:
    """Bytes the banded engine has read back in this process (the
    engine.d2h_bytes counter): it moves only on the banded route."""
    from dsen2_tpu_torch.utils import profiling

    return profiling.counters().get("engine.d2h_bytes", 0)


def timed(torch, fn):
    """(result, wall s, peak device bytes) of one call, host clock around
    work that ends in a synchronise."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def device_profile(torch, fn, top: int = 0) -> dict:
    """Run fn once under torch.profiler (device activity only) and return,
    in seconds: "wall"; "busy", the union of the device's activity intervals
    (None if the trace holds no device event); "kernels", "HtoD" and
    "DtoH", summed over streams; "edges", the wall time before the first and
    after the last device activity; "gaps", the idle time between device
    activities in gaps over 1 ms. Prints the `top` costliest device
    entries."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type.name == "CUDA")
    out = {"wall": wall, "busy": None, "kernels": 0.0, "HtoD": 0.0, "DtoH": 0.0,
           "edges": None, "gaps": 0.0}
    busy, end = 0.0, None
    for a, b, name in spans:
        kind = "HtoD" if "HtoD" in name else "DtoH" if "DtoH" in name else "kernels"
        out[kind] += (b - a) / 1e6
        if end is not None and a - end > 1e3:
            out["gaps"] += (a - end) / 1e6
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    if spans:
        out["busy"] = busy / 1e6
        out["edges"] = wall - (end - spans[0][0]) / 1e6
    if top:
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
            print(f"  {e.self_device_time_total / 1e3:10.2f} ms  x{e.count:<6d} {e.key[:90]}")
    return out


# The aten ops under which cuDNN runs the plain convs, forward and backward.
CONV_OPS = ("aten::cudnn_convolution", "aten::convolution_backward")


def conv_ms(torch, fn) -> dict:
    """One call of fn under torch.profiler (host and device): the device ms
    spent under CONV_OPS ("ms", in "calls" calls) and in all device kernels
    ("device_ms"), and the profile's key averages ("events")."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    convs = [e for e in events if e.key in CONV_OPS]
    return {"ms": sum(e.device_time_total for e in convs) / 1e3,
            "calls": sum(e.count for e in convs),
            "device_ms": sum(e.self_device_time_total for e in events
                             if e.device_type.name == "CUDA") / 1e3,
            "events": events}


def idle_text(p: dict) -> str:
    if p["busy"] is None:
        return "device idle share not measured (no device events in the trace)"
    return (f"profiled wall {p['wall']:.3f} s, device busy {p['busy']:.3f} s, idle share "
            f"{100 * (1 - p['busy'] / p['wall']):.1f} % (before the first and after the last "
            f"device activity {p['edges']:.3f} s, in gaps over 1 ms {p['gaps']:.3f} s); "
            f"kernels {p['kernels']:.3f} s, HtoD {p['HtoD']:.3f} s, DtoH {p['DtoH']:.3f} s "
            f"summed over streams")


def ensemble_reference(rasters, run):
    """Mean of the 8 dihedral-transformed runs run(rasters), inverted, in
    float32 on the host, summed in code order."""
    from dsen2_tpu_torch.ops.dihedral import dihedral_np, inverse_code

    acc = None
    for code in range(8):
        out = run([dihedral_np(r, code) for r in rasters])
        back = dihedral_np(out, inverse_code[code])
        acc = back if acc is None else acc + back
    return acc / np.float32(8)


def phase_full_tile(torch, api, weights, chain_mod, block_mod, card):
    """The full-tile path, the uint16 output, the ensemble and the demo."""
    import scipy.io

    from dsen2_tpu_torch.cli import demo
    from dsen2_tpu_torch.core.config import InferConfig, dsen2_2x

    models = os.path.join(HERE, "models")
    params20 = weights.load_params_npz(os.path.join(models, "s2_032_lr_1e-04.npz"))
    params60 = weights.load_params_npz(os.path.join(models, "s2_030_lr_1e-05.npz"))
    t0 = time.perf_counter()
    d10, d20, d60 = tiled_scene(1, FULL_TILE, TILE_BASE)
    mp = d10.shape[0] * d10.shape[1] / 1e6
    print(f"full tile: {d10.shape} uint16 scene built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    chain_mod.fused_resblock_chain.launches = 0
    block_mod.fused_resblock.launches = 0

    f32_default = None
    for prec in ("high", "default"):
        cfg = InferConfig(patch_size=128, border=8, precision=prec)

        def banded():
            return api.dsen2_20(d10, d20, params=params20, infer_cfg=cfg)

        def one_shot():
            return api._run([d10, d20], 2, dsen2_2x(), params20, cfg,
                            device_output=True).cpu().numpy()

        rows = {}
        for name, fn in (("banded", banded), ("one-shot", one_shot)):
            d2h0 = engine_d2h_bytes()
            _, cold, _ = timed(torch, fn)
            blocks = chain_mod.fused_resblock_chain.launches
            out, warm, peak = timed(torch, fn)
            blocks = chain_mod.fused_resblock_chain.launches - blocks
            prof = device_profile(torch, fn, top=10 if name == "banded" else 0)
            d2h = engine_d2h_bytes() - d2h0
            print(f"dsen2_20 {FULL_TILE}^2 {prec} {name}: cold {cold:.3f} s, warm {warm:.3f} s, "
                  f"{mp / warm:.2f} MP/s on {card}; peak device memory {peak / 2**30:.2f} GiB; "
                  f"{idle_text(prof)}; read back by the engine in 3 calls: {d2h} B; "
                  f"B1 blocks in one call: {blocks}", flush=True)
            check(out.shape == (*d10.shape[:2], 6) and np.isfinite(out).all(),
                  f"dsen2_20 {FULL_TILE}^2 {prec} {name} output")
            check(d2h == (3 * out.nbytes if name == "banded" else 0),
                  f"dsen2_20 {FULL_TILE}^2 {prec} {name} took the wrong route")
            rows[name] = (out, peak)
        convs = conv_ms(torch, banded)
        edge = {k: sum(e.self_device_time_total for e in convs["events"]
                       if e.device_type.name == "CUDA" and k in e.key) / 1e3
                for k in ("head_kernel", "tail_kernel")}
        print(f"dsen2_20 {FULL_TILE}^2 {prec} banded: head kernel {edge['head_kernel']:.2f} ms, "
              f"tail kernel {edge['tail_kernel']:.2f} ms per tile, of {convs['device_ms']:.2f} "
              f"ms on the device; {convs['calls']} cuDNN conv calls (the class conv's head and "
              f"tail: 0.892 + 0.271 s of cuDNN's TF32 convs in a traced dsen2.tile window, "
              f"PERF.md §6)",
              flush=True)
        check(convs["calls"] == 0 and edge["head_kernel"] > 0 and edge["tail_kernel"] > 0,
              f"dsen2_20 {FULL_TILE}^2 {prec}: the head and tail did not run as kernels")
        (b, peak_b), (o, peak_o) = rows["banded"], rows["one-shot"]
        diff = float(np.abs(b - o).max())
        limit = E2E_TOL[prec] * float(np.abs(o).max())
        print(f"banded vs one-shot {prec}: max|diff| {diff:.3e} DN (limit {limit:.3f}), "
              f"bit-equal {bool(np.array_equal(b, o))}; peak {peak_b / 2**30:.2f} vs "
              f"{peak_o / 2**30:.2f} GiB", flush=True)
        check(diff <= limit, f"banded {prec} differs from one-shot")
        check(peak_b < peak_o, f"banded {prec} peak memory not below one-shot's")
        if prec == "default":
            f32_default = b
        del rows, b, o

    cfg = InferConfig(patch_size=192, border=12, precision="default")
    _, cold, _ = timed(torch, lambda: api.dsen2_60(d10, d20, d60, params=params60, infer_cfg=cfg))
    out60, warm, peak = timed(
        torch, lambda: api.dsen2_60(d10, d20, d60, params=params60, infer_cfg=cfg))
    print(f"dsen2_60 {FULL_TILE}^2 default banded: cold {cold:.3f} s, warm {warm:.3f} s, "
          f"{mp / warm:.2f} MP/s; peak device memory {peak / 2**30:.2f} GiB", flush=True)
    check(out60.shape == (*d10.shape[:2], 2) and np.isfinite(out60).all(),
          "dsen2_60 banded output")
    del out60

    # B2 route: patch 132 has no 8-row tile, so "default" takes fused_resblock.
    cfg = InferConfig(patch_size=132, border=8, precision="default")
    blocks = block_mod.fused_resblock.launches
    out132, wall, peak = timed(torch, lambda: api.dsen2_20(d10, d20, params=params20,
                                                           infer_cfg=cfg))
    blocks = block_mod.fused_resblock.launches - blocks
    print(f"dsen2_20 {FULL_TILE}^2 patch 132 default banded (fused_resblock): {wall:.3f} s, "
          f"{mp / wall:.2f} MP/s; peak device memory {peak / 2**30:.2f} GiB; B2 blocks {blocks}",
          flush=True)
    check(out132.shape == (*d10.shape[:2], 6) and np.isfinite(out132).all() and blocks > 0,
          "dsen2_20 patch 132 banded output or its B2 launches")
    del out132

    cfg = InferConfig(patch_size=128, border=8, precision="default", output_dtype="uint16")
    timed(torch, lambda: api.dsen2_20(d10, d20, params=params20, infer_cfg=cfg))
    d2h0 = engine_d2h_bytes()
    u16, warm, _ = timed(torch, lambda: api.dsen2_20(d10, d20, params=params20, infer_cfg=cfg))
    d2h = engine_d2h_bytes() - d2h0
    want = np.clip(np.round(f32_default), 0, 65535)
    diff = float(np.abs(u16.astype(np.float32) - want).max())
    print(f"dsen2_20 {FULL_TILE}^2 default uint16: warm {warm:.3f} s, {mp / warm:.2f} MP/s; "
          f"{d2h} B read back ({d2h / f32_default.nbytes:.3f} of float32's); max|diff vs "
          f"rounded float32| {diff:.0f} DN", flush=True)
    check(u16.dtype == np.uint16 and d2h == u16.nbytes, "uint16 output or its d2h bytes")
    check(diff <= 1, "uint16 output strays from the rounded float32 one")
    banded_default = f32_default  # phase 7 holds the mesh run against it
    del u16, want, f32_default, d10, d20, d60

    cfg = InferConfig(patch_size=128, border=8, precision="default")
    for h10, route in ENSEMBLE_SIZES:
        rasters = synthetic_scene(2, h10)[:2]
        timed(torch, lambda: api.dsen2_20(*rasters, params=params20, infer_cfg=cfg,
                                          ensemble=True))
        ens, warm, peak = timed(torch, lambda: api.dsen2_20(
            *rasters, params=params20, infer_cfg=cfg, ensemble=True))
        want = ensemble_reference(
            rasters, lambda rs: api.dsen2_20(*rs, params=params20, infer_cfg=cfg))
        diff = float(np.abs(ens - want).max())
        limit = E2E_TOL["default"] * float(np.abs(want).max())
        print(f"ensemble {h10}^2 default ({route} route): warm {warm:.3f} s, "
              f"{h10 * h10 / 1e6 / warm:.2f} MP/s, peak device memory {peak / 2**30:.2f} GiB; "
              f"max|diff vs mean of 8 runs| {diff:.3e} DN (limit {limit:.3f})", flush=True)
        check(ens.shape == want.shape and np.isfinite(ens).all(), f"ensemble {h10}^2 output")
        check(diff <= limit, f"ensemble {h10}^2 differs from the mean of its 8 runs")

    scene_dir = os.path.join(HERE, "build", "smoke_scene")
    os.makedirs(scene_dir, exist_ok=True)
    im10, im20, im60 = synthetic_scene(3, 600)
    path = os.path.join(scene_dir, "synthetic_600.mat")
    scipy.io.savemat(path, {"im10": im10, "im20": im20, "im60": im60})
    t0 = time.perf_counter()
    res = demo.run_scene(path, deep=False, plots=False, out_dir=os.path.join(scene_dir, "out"))
    print(f"demo run_scene 600^2: {time.perf_counter() - t0:.3f} s; {res}", flush=True)
    check(all(np.isfinite(v) for k, v in res.items() if k != "scene") and
          {"rmse_dsen2_20", "rmse_bicubic_20", "rmse_dsen2_60"} <= set(res),
          "demo run_scene results")

    launches = {"fused_resblock_chain": chain_mod.fused_resblock_chain.launches,
                "fused_resblock": block_mod.fused_resblock.launches}
    print(f"full-tile path launches: {launches}", flush=True)
    for k, n in launches.items():
        check(n > 0, f"{k} was not launched on the full-tile path")
    return launches, banded_default


# Phase 5's data: the reference's 2x training crops, N train + val samples.
TRAIN_N, VAL_N, TRAIN_BATCH = 1024, 128, 128


def training_set(seed: int, n: int, hw: int, in_channels):
    """Seeded crops at the reference's shapes, divided by SCALE as the CLI
    does: reflectance-like DN in [0, 10000) for every input, and a label
    that is a fixed smooth function of them (the last input plus a tanh of
    a fixed mix of the first), so that the loss has something to learn."""
    from dsen2_tpu_torch.core.bands import SCALE

    rng = np.random.default_rng(seed)
    xs = [(rng.random((n, hw, hw, c), dtype=np.float32) * 10000 / SCALE).astype(np.float32)
          for c in in_channels]
    mix = np.random.default_rng(1000).standard_normal((in_channels[0], in_channels[-1]))
    label = xs[-1] + 0.25 * np.tanh(xs[0] @ mix.astype(np.float32) - 2.5)
    return xs, label.astype(np.float32)


def split(xs, label, n_train):
    return (tuple(x[:n_train] for x in xs), label[:n_train],
            tuple(x[n_train:] for x in xs), label[n_train:])


# The class's plane convs on the card against the same plane convs in
# float64, as a fraction of max|ref|. f32 sums over up to 32768 terms (the
# chunked wgrad) in any order stay near 5e-6; TF32 rounding of f32 operands
# costs about 3e-4 (both measured on an H100, PERF.md §6).
PLANE_TOL = 1e-5


def rel_err(a, ref) -> float:
    return ((a.double() - ref).abs().max() / ref.abs().max()).item()


def plane_convs_f64(conv_mod, x, w, g, prec):
    """(y, dx, dw) of ops/conv.py's class formula with the planes of x, w
    and g convolved in float64, in conv_mod's NHWC / HWIO layouts."""
    import torch.nn.functional as F

    xh, xl = (None if p is None else p.double() for p in conv_mod._planes(conv_mod._nchw(x), prec))
    wh, wl = (None if p is None else p.double() for p in conv_mod._planes(conv_mod._oihw(w), prec))
    gh, gl = (None if p is None else p.double()
              for p in conv_mod._planes(conv_mod._nchw(g.contiguous()), prec))
    terms = [(gh, xh, wh)] + ([(gl, xh, wh), (gh, xl, wl)] if gl is not None else [])
    y = F.conv2d(xh, wh, padding=1)
    if xl is not None:
        y = y + F.conv2d(xl, wh, padding=1) + F.conv2d(xh, wl, padding=1)
    dx = dw = 0
    for gp, xp, wp in terms:
        a, b = conv_mod._grads(gp, xp, wp, (True, True))
        dx, dw = dx + a, dw + b
    return y.permute(0, 2, 3, 1), dx.permute(0, 2, 3, 1), dw.permute(2, 3, 1, 0)


@contextlib.contextmanager
def plane_convs_in_f32(conv_mod):
    """Run ops/conv.py's plane convs with TF32 off instead of on."""
    saved = conv_mod.tf32_for_bf16_operands
    conv_mod.tf32_for_bf16_operands = conv_mod.tf32_disabled
    try:
        yield
    finally:
        conv_mod.tf32_for_bf16_operands = saved


# The class conv's operands whose split phase 5 times: a DSen2 2x training
# step's body activation and a dsen2.tile batch's tail input.
PLANE_SHAPES = ((128, 32, 32, 128), (64, 128, 128, 128))


def plane_pass_times(torch, conv_mod) -> dict:
    """The plane pass (ops/conv.py::_kernel_planes) against the plain split
    (_plain_planes: five kernels at "high", two at "default") on the NCHW
    view of each PLANE_SHAPES operand, at both classes: 20-call means, the
    bytes bound (v in, each plane out, f32, at the HBM rate) and the pass's
    share of it. Fails on any bit difference. Returns {(shape, precision):
    result} in phase 2's form."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for shape in PLANE_SHAPES:
        v = conv_mod._nchw(torch.randn(shape, generator=gen, device="cuda"))
        for prec in ("high", "default"):
            got, want = conv_mod._kernel_planes(v, prec), conv_mod._plain_planes(v, prec)
            for a, b in zip(got, want):
                check((a is None and b is None) or
                      torch.equal(a.view(torch.int32), b.view(torch.int32)),
                      f"plane pass {list(shape)} {prec} differs from the plain split")
            del got, want
            ms = time_ms(torch, lambda: conv_mod._kernel_planes(v, prec), iters=20)
            plain = time_ms(torch, lambda: conv_mod._plain_planes(v, prec), iters=20)
            nbytes = 4 * v.numel() * (3 if prec == "high" else 2)
            bound = nbytes / PEAK_BYTES * 1e3
            print(f"plane pass {list(shape)} {prec}: {ms:.4f} ms (20-call mean), plain split "
                  f"{plain:.4f} ms; bound {bound:.4f} ms ({nbytes / v.numel():.0f} B an element "
                  f"at {PEAK_BYTES / 1e12:.2f} TB/s), {100 * bound / ms:.1f} % of it; "
                  "bit-equal", flush=True)
            results[(shape, prec)] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, library_ms=plain,
                                          bound_ms=bound, bound_by="bytes")
        del v
    torch.cuda.empty_cache()
    return results


def step_times(torch, loop, cfg, params_np, batch, precision, remat=False, steps=10):
    """ms of each of `steps` warm train_steps on one device-resident batch
    (CUDA events, after 3 warm-up steps), and the peak device memory."""
    from dsen2_tpu_torch.core.config import TrainConfig
    from dsen2_tpu_torch.train.nadam import make_optimizer
    from dsen2_tpu_torch.weights import params_to_torch

    params = params_to_torch(params_np, "cuda")
    for t in params.values():
        for v in t.values():
            v.requires_grad_()
    opt = make_optimizer(params, TrainConfig())
    inputs, target = batch

    def step():
        return loop.train_step(params, opt, inputs, target, cfg, precision, remat)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times, torch.cuda.max_memory_allocated(), step


def phase_training(torch, chain_mod, block_mod, card):
    """Training at full width: the exactness of the TF32 plane convs, fit for
    DSen2 2x host-fed at "high" and staged at "default", step times and the
    conv share per class, one step's gradients against "highest", resume
    against a straight run, the 6x net, VDSen2 with remat and the CLI smoke.
    Training runs plain convs only, so neither kernel may launch here."""
    from dsen2_tpu_torch.cli import train as train_cli
    from dsen2_tpu_torch.core.config import TrainConfig, dsen2_2x, dsen2_6x
    from dsen2_tpu_torch.models import s2net
    from dsen2_tpu_torch.ops import conv as conv_mod
    from dsen2_tpu_torch.train import fit, loop, restore_fit_state
    from dsen2_tpu_torch.train.losses import mae
    from dsen2_tpu_torch.utils import profiling
    from dsen2_tpu_torch.weights import params_to_numpy, params_to_torch

    import torch.nn.functional as F

    out_root = os.path.join(HERE, "build", "smoke_train")
    if os.path.isdir(out_root):
        shutil.rmtree(out_root)
    chain_mod.fused_resblock_chain.launches = 0
    block_mod.fused_resblock.launches = 0

    planes = plane_pass_times(torch, conv_mod)

    # The class convs of the planes (forward, dgrad, wgrad) in TF32 against
    # the same plane convs in float64, at the training steps' conv shapes;
    # TF32 off and raw f32 operands through TF32 are printed beside them.
    gen = torch.Generator(device="cuda").manual_seed(0)
    for cin, cout, hw, b in ((10, 128, 32, 128), (128, 128, 32, 128), (128, 6, 32, 128),
                             (12, 128, 96, 128), (128, 128, 96, 128), (128, 2, 96, 128),
                             (256, 256, 32, 8)):
        x = torch.randn((b, hw, hw, cin), generator=gen, device="cuda")
        w = torch.randn((3, 3, cin, cout), generator=gen, device="cuda") / (9 * cin) ** 0.5
        g = torch.randn((b, hw, hw, cout), generator=gen, device="cuda")
        for prec in ("high", "default"):
            ref = plane_convs_f64(conv_mod, x, w, g, prec)

            def forward():
                return conv_mod._forward(x, w, None, prec, conv_mod._operand_planes(x, w, prec))

            def both():
                planes = conv_mod._operand_planes(x, w, prec)
                return [conv_mod._forward(x, w, None, prec, planes),
                        *conv_mod._backward(g, planes, prec, True, True)]

            got = both()
            with plane_convs_in_f32(conv_mod):
                f32 = both()
            errs = [rel_err(a, r) for a, r in zip(got, ref)]
            errs_f32 = [rel_err(a, r) for a, r in zip(f32, ref)]
            t_tf32 = time_ms(torch, forward)
            with plane_convs_in_f32(conv_mod):
                t_f32 = time_ms(torch, forward)
            print(f"plane convs {cin}->{cout} [{b},{hw},{hw}] {prec}: max|diff|/max|ref| against "
                  f"float64: TF32 y {errs[0]:.2e} dx {errs[1]:.2e} dw {errs[2]:.2e} (limit "
                  f"{PLANE_TOL}); TF32 off y {errs_f32[0]:.2e} dx {errs_f32[1]:.2e} dw "
                  f"{errs_f32[2]:.2e}; forward {t_tf32:.3f} ms TF32, {t_f32:.3f} ms TF32 off",
                  flush=True)
            check(max(errs) <= PLANE_TOL, f"TF32 plane convs {cin}->{cout} {prec} stray from "
                  "float64")
        xc, wc = conv_mod._nchw(x), conv_mod._oihw(w)
        raw = F.conv2d(xc.double(), wc.double(), padding=1)
        with conv_mod.tf32_for_bf16_operands():
            tf32_raw = F.conv2d(xc, wc, padding=1)
        print(f"  raw f32 operands through TF32, forward: max|diff|/max|ref| "
              f"{rel_err(tf32_raw, raw):.2e} (what TF32 rounding costs)", flush=True)
        del x, w, g, ref, got, f32, xc, wc, raw, tf32_raw
        torch.cuda.empty_cache()

    # DSen2 2x at full width, batch 128, 2 epochs: host-fed at "high",
    # staged at "default".
    cfg = dsen2_2x()
    n_train, n_val = TRAIN_N, VAL_N
    xs, label = training_set(0, n_train + n_val, 32, cfg.in_channels)
    data = split(xs, label, n_train)
    params0 = s2net.init_params(torch.Generator().manual_seed(0), cfg)
    rates = {}
    for prec, staged in (("high", False), ("default", True)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, hist = fit(cfg, TrainConfig(batch_size=TRAIN_BATCH), *data, params=params0,
                      epochs=2, precision=prec, stage_data=staged, verbose=True)
        wall = time.perf_counter() - t0
        rates[prec] = 2 * n_train / wall
        print(f"fit DSen2 2x {prec} {'staged' if staged else 'host-fed'}: {n_train} + {n_val} "
              f"crops of 32^2, batch {TRAIN_BATCH}, 2 epochs in {wall:.3f} s (cold, "
              f"{rates[prec]:.1f} train patches/s with val and set-up); loss "
              f"{hist['loss']}, val {hist['val_loss']}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        check(np.isfinite(hist["loss"] + hist["val_loss"]).all(), f"fit {prec} losses")
        check(hist["loss"][1] < hist["loss"][0], f"fit {prec}: the loss did not fall")

    # Step time, throughput, memory and conv share per class.
    batch = (tuple(torch.as_tensor(x[:TRAIN_BATCH], device="cuda") for x in xs),
             torch.as_tensor(label[:TRAIN_BATCH], device="cuda"))
    for prec in ("highest", "high", "default"):
        times, peak, step = step_times(torch, loop, cfg, params0, batch, prec)
        if prec != "highest":
            # A step splits x and w of its 14 convs in the forward and g in
            # the backward, each in one plane pass, and the backward takes
            # the forward's planes.
            before = profiling.counters()
            step()
            torch.cuda.synchronize()
            got = [profiling.counters().get(k, 0) - before.get(k, 0)
                   for k in ("conv.plane_passes", "conv.planes_kept")]
            print(f"train step DSen2 2x {prec}: {got[0]} plane passes, {got[1]} backward "
                  "calls on kept planes (counters conv.plane_passes, conv.planes_kept)",
                  flush=True)
            check(got == [42, 14], f"train step {prec} does not split through the plane pass "
                  "or does not keep its planes")
        ms = statistics.median(times)
        convs = conv_ms(torch, step)
        print(f"train step DSen2 2x {prec}, batch {TRAIN_BATCH} x 32^2: {ms:.3f} ms (median of "
              f"{len(times)} warm steps, CUDA events; min {min(times):.3f}, max "
              f"{max(times):.3f}), {TRAIN_BATCH / ms * 1e3:.1f} patches/s on {card}; peak "
              f"device memory {peak / 2**30:.2f} GiB; convs {convs['ms']:.3f} of "
              f"{convs['device_ms']:.3f} ms device time in one profiled step "
              f"({100 * convs['ms'] / convs['device_ms']:.1f} %, {convs['calls']} conv calls)",
              flush=True)
        if prec == "high":
            for e in sorted((e for e in convs["events"] if e.device_type.name == "CUDA"),
                            key=lambda e: -e.self_device_time_total)[:6]:
                print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")
        del step
    torch.cuda.empty_cache()

    # One step's gradients at each class against "highest".
    params = params_to_torch(params0, "cuda")
    leaves = s2net.param_leaves(params)
    for t in leaves:
        t.requires_grad_()

    def grads(prec):
        pred = s2net.apply(params, batch[0], cfg, precision=prec)
        return torch.autograd.grad(mae(pred, batch[1]), leaves)

    ref = grads("highest")
    for prec in ("high", "default"):
        worst = max(((a - r).abs().max() / r.abs().max()).item()
                    for a, r in zip(grads(prec), ref))
        print(f"one step's gradients {prec} vs highest: worst max|diff|/max|g| over the "
              f"{len(ref)} parameter tensors {worst:.3e} (limit {E2E_TOL[prec]})", flush=True)
        check(worst <= E2E_TOL[prec], f"{prec} gradients stray from highest")
    del params, leaves, ref
    torch.cuda.empty_cache()

    # Resume: 1 epoch, restore_fit_state, 1 more, against 2 straight, with
    # cuDNN's deterministic algorithms (its default wgrad may use atomics).
    n_sub = 3 * TRAIN_BATCH
    sub = split([x[:n_sub] for x in xs], label[:n_sub], 2 * TRAIN_BATCH)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        kw = dict(params=params0, precision="high", verbose=False)
        tc_a = TrainConfig(batch_size=TRAIN_BATCH, augment=True, state_every=0,
                           out_dir=os.path.join(out_root, "resume_a"))
        st_a, h_a = fit(cfg, tc_a, *sub, epochs=2, **kw)
        tc_b = dataclasses.replace(tc_a, state_every=1, out_dir=os.path.join(out_root, "resume_b"))
        fit(cfg, tc_b, *sub, epochs=1, **kw)
        rs = restore_fit_state(os.path.join(tc_b.out_dir, f"{tc_b.model_nr}state"), cfg, tc_b)
        kw.pop("params")
        st_b, h_b = fit(cfg, tc_b, *sub, epochs=2, **kw, **rs)
    finally:
        torch.use_deterministic_algorithms(False)
    pa, pb = params_to_numpy(st_a.params), params_to_numpy(st_b.params)
    bit_equal = h_a == h_b and all(np.array_equal(pa[t][k], pb[t][k]) for t, k in s2net.PARAM_NAMES)
    rel = max(float(np.abs(pa[t][k] - pb[t][k]).max() / np.abs(pa[t][k]).max())
              for t, k in s2net.PARAM_NAMES)
    print(f"resume 1 + 1 epochs vs 2 straight (high, augment, deterministic algorithms): "
          f"history {h_b['loss']} vs {h_a['loss']}; bit-equal {bit_equal}; worst params "
          f"max|diff|/max|p| {rel:.3e}", flush=True)
    check(bit_equal or (rel <= 1e-5 and np.allclose(h_a["loss"], h_b["loss"], rtol=1e-5)),
          "resumed run differs from the straight one")

    # The 6x net (96^2 crops, batch 128) and VDSen2 2x (32 x 256, remat,
    # batch 8): a few steps each.
    for name, cfg_x, hw, batch_size, n_steps, prec, remat in (
            ("DSen2 6x", dsen2_6x(), 96, TRAIN_BATCH, 3, "default", False),
            ("VDSen2 2x", dsen2_2x(deep=True), 32, 8, 4, "high", True)):
        xs_x, label_x = training_set(1, (n_steps + 1) * batch_size, hw, cfg_x.in_channels)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, hist = fit(cfg_x, TrainConfig(batch_size=batch_size),
                      *split(xs_x, label_x, n_steps * batch_size),
                      params=s2net.init_params(torch.Generator().manual_seed(1), cfg_x),
                      epochs=1, precision=prec, remat=remat, verbose=False)
        wall = time.perf_counter() - t0
        sub_batch = (tuple(torch.as_tensor(x[:batch_size], device="cuda") for x in xs_x),
                     torch.as_tensor(label_x[:batch_size], device="cuda"))
        times, peak, _ = step_times(torch, loop, cfg_x, s2net.init_params(
            torch.Generator().manual_seed(1), cfg_x), sub_batch, prec, remat, steps=5)
        ms = statistics.median(times)
        print(f"fit {name} {prec}{' remat' if remat else ''}: {n_steps} steps of batch "
              f"{batch_size} x {hw}^2 in {wall:.3f} s (cold), loss {hist['loss']}, val "
              f"{hist['val_loss']}; warm step {ms:.3f} ms (median of {len(times)}), "
              f"{batch_size / ms * 1e3:.1f} patches/s, peak device memory "
              f"{peak / 2**30:.2f} GiB", flush=True)
        check(np.isfinite(hist["loss"] + hist["val_loss"]).all(), f"fit {name} losses")
        del xs_x, label_x, sub_batch
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rc = train_cli.main(["--smoke", "--path", os.path.join(out_root, "cli") + "/"])
    print(f"cli.train --smoke: rc {rc} in {time.perf_counter() - t0:.3f} s", flush=True)
    check(rc == 0 and os.path.isdir(os.path.join(out_root, "cli", "network_data",
                                                 "s2_038_state")), "cli.train --smoke")

    launches = {"fused_resblock_chain": chain_mod.fused_resblock_chain.launches,
                "fused_resblock": block_mod.fused_resblock.launches}
    print(f"training path launches: {launches} (training runs plain convs only)", flush=True)
    check(not any(launches.values()), "training launched a residual-block kernel")
    return rates["default"], planes


# Phase 6: the production CLIs. An L1C product's bands per resolution, in the
# order and with the descriptions of GDAL's SENTINEL2 driver.
PRODUCT_BANDS = {10: ("B4", "B3", "B2", "B8"), 20: ("B5", "B6", "B7", "B8A", "B11", "B12"),
                 60: ("B1", "B9", "B10")}
WAVELENGTH_NM = {"B1": 443, "B2": 490, "B3": 560, "B4": 665, "B5": 705, "B6": 740, "B7": 783,
                 "B8": 842, "B8A": 865, "B9": 945, "B10": 1375, "B11": 1610, "B12": 2190}
PRODUCT_EPSG, PRODUCT_ULX, PRODUCT_ULY = 32633, 399960.0, 5000040.0
# The JP2 product's 10 m side (encoding it takes seconds) and its ROI, inclusive.
JP2_SIZE, JP2_ROI = 1200, (120, 240, 839, 959)
# The .mat scene create_patches cuts into training crops.
PATCH_SCENE = 1200


def product_rasters(seed: int, h10: int, base: int = 0):
    """Seeded uint16 rasters of an L1C product: 4, 6 and 3 bands on the 10,
    20 and 60 m grids, tiled from a `base` px scene when base is given."""
    d10, d20, d60 = tiled_scene(seed, h10, base) if base else synthetic_scene(seed, h10)
    return d10, d20, np.concatenate([d60, d60[:, :, :1]], axis=2)


class _MemoryBand:
    def __init__(self, desc: str):
        self._desc = desc

    def GetDescription(self) -> str:
        return self._desc


class _MemoryRaster:
    """One resolution of the product, a GDAL dataset's read surface over an
    [H, W, C] array."""

    def __init__(self, arr: np.ndarray, res: int):
        self._chw = np.moveaxis(arr, -1, 0)
        self._res = res
        self.RasterCount, self.RasterYSize, self.RasterXSize = self._chw.shape

    def GetRasterBand(self, i: int) -> _MemoryBand:
        b = PRODUCT_BANDS[self._res][i - 1]
        return _MemoryBand(f"{b}, central wavelength {WAVELENGTH_NM[b]} nm")

    def GetGeoTransform(self) -> tuple:
        return (PRODUCT_ULX, float(self._res), 0.0, PRODUCT_ULY, 0.0, -float(self._res))

    def GetProjection(self) -> str:
        return f'PROJCS["WGS 84 / UTM zone 33N",AUTHORITY["EPSG","{PRODUCT_EPSG}"]]'

    def ReadAsArray(self, xoff, yoff, xsize, ysize, buf_xsize=None, buf_ysize=None):
        return self._chw[:, yoff:yoff + ysize, xoff:xoff + xsize]


def gdal_product(d10, d20, d60):
    """A stand-in `osgeo.gdal` module serving (d10, d20, d60) as an L1C
    product with three resolution subdatasets, as GDAL's SENTINEL2 driver
    presents one (tests/test_safe_cli_e2e.py drives the same seam), and with
    no GTiff driver, so that write_bands takes the built-in GeoTIFF writer.
    Returns (module, product name)."""
    import types

    name = "MEMORY_MTD_MSIL1C.xml"
    subs = {f"SENTINEL2_L1C:{name}:{res}m:EPSG_{PRODUCT_EPSG}": (
        f"Bands {', '.join(PRODUCT_BANDS[res])} with {res}m resolution, UTM 33N",
        _MemoryRaster(arr, res)) for res, arr in ((10, d10), (20, d20), (60, d60))}
    product = types.SimpleNamespace(
        GetSubDatasets=lambda: [(k, desc) for k, (desc, _) in subs.items()])
    gdal = types.ModuleType("osgeo.gdal")
    gdal.Open = lambda n: product if n == name else subs[n][1] if n in subs else None
    gdal.GetDriverByName = lambda n: None
    gdal.DCAP_CREATE = "DCAP_CREATE"
    return gdal, name


@contextlib.contextmanager
def installed_gdal(gdal):
    """Make `gdal` the importable osgeo.gdal inside the block."""
    import types

    osgeo = types.ModuleType("osgeo")
    osgeo.gdal = gdal
    saved = {k: sys.modules.get(k) for k in ("osgeo", "osgeo.gdal")}
    sys.modules["osgeo"], sys.modules["osgeo.gdal"] = osgeo, gdal
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


@contextlib.contextmanager
def timed_calls(*targets):
    """Wrap each (module, name) function so that the wall seconds of its
    calls are appended to the yielded dict under `name`; restore them after."""
    times, saved = {}, []
    for mod, name in targets:
        fn = getattr(mod, name)

        def wrapper(*a, _fn=fn, _name=name, **kw):
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            times.setdefault(_name, []).append(time.perf_counter() - t0)
            return out

        saved.append((mod, name, fn))
        setattr(mod, name, wrapper)
    try:
        yield times
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def check_geotiff(read_tiff, path, sr20, sr60, xmin, ymin, what):
    """The SR bands of a GeoTIFF written by s2_supres equal sr20 then sr60 bit
    for bit, in the product's CRS with the ROI's corner as the tiepoint."""
    t = read_tiff(path)
    names = t["descriptions"]
    check(len(names) == sr20.shape[2] + sr60.shape[2] and all(n.startswith("SR") for n in names),
          f"{what}: bands {names}")
    for i, n in enumerate(names):
        want = sr20[:, :, i] if i < sr20.shape[2] else sr60[:, :, i - sr20.shape[2]]
        check(t["bands"][n].dtype == want.dtype and np.array_equal(t["bands"][n], want),
              f"{what}: band {n} differs from the API's")
    check(t["geokeys"].get(3072) == PRODUCT_EPSG, f"{what}: GeoKey EPSG {t['geokeys']}")
    check(t["tiepoint"][3:5] == [PRODUCT_ULX + 10 * xmin, PRODUCT_ULY - 10 * ymin]
          and t["pixel_scale"] == [10.0, 10.0, 0.0], f"{what}: tiepoint {t['tiepoint']}")
    return t


def phase_production(torch, api, weights, chain_mod, block_mod, card, staged_rate):
    """The production entry points on the card: s2_supres on a full 10980^2
    product held in memory (through safe_reader's GDAL seam) and on a JP2
    product through the Pillow backend, create_patches into cli.train
    --stream, and convert_weights. Returns the kernels' launches in the CLI
    runs."""
    import importlib.util

    import scipy.io

    from dsen2_tpu_torch.cli import convert_weights, create_patches, s2_supres
    from dsen2_tpu_torch.cli import train as train_cli
    from dsen2_tpu_torch.core.config import InferConfig
    from dsen2_tpu_torch.data import safe_pil, safe_reader
    from dsen2_tpu_torch.geo.utm import utm_inverse
    from dsen2_tpu_torch.io import writers
    from dsen2_tpu_torch.train import loop

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from safe_product import build_safe
    from tiff_reader import read_tiff

    pillow = importlib.util.find_spec("PIL") is not None
    has_jp2 = safe_pil.available()
    print(f"host: GDAL (osgeo) {'present' if importlib.util.find_spec('osgeo') else 'absent'}; "
          f"Pillow {__import__('PIL').__version__ if pillow else 'absent'}, JPEG 2000 "
          f"{'readable' if has_jp2 else 'not readable'}", flush=True)

    out_dir = os.path.join(HERE, "build", "smoke_cli")
    if os.path.isdir(out_dir):
        shutil.rmtree(out_dir)
    os.makedirs(out_dir)
    launches = {"fused_resblock_chain": 0, "fused_resblock": 0}

    def run_cli(argv):
        """s2_supres.main(argv), its wall s and the kernels' launches in it."""
        chain_mod.fused_resblock_chain.launches = 0
        block_mod.fused_resblock.launches = 0
        t0 = time.perf_counter()
        rc = s2_supres.main(argv)
        wall = time.perf_counter() - t0
        got = {"fused_resblock_chain": chain_mod.fused_resblock_chain.launches,
               "fused_resblock": block_mod.fused_resblock.launches}
        for k, n in got.items():
            launches[k] += n
        check(rc == 0, f"s2_supres {argv} returned {rc}")
        check(got["fused_resblock_chain"] > 0, f"s2_supres {argv} did not launch B1")
        return wall, got

    # The full product, in memory, through the GDAL seam.
    t0 = time.perf_counter()
    d10, d20, d60 = product_rasters(4, FULL_TILE, TILE_BASE)
    gdal, name = gdal_product(d10, d20, d60)
    print(f"product {FULL_TILE}^2: {sum(a.nbytes for a in (d10, d20, d60))} B of uint16 in "
          f"{d10.shape[2]} + {d20.shape[2]} + {d60.shape[2]} bands, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    tif = os.path.join(out_dir, "full.tif")
    argv = [name, tif, "--run_60", "--output-dtype", "uint16"]
    d2h0 = engine_d2h_bytes()
    with installed_gdal(gdal), timed_calls((safe_reader, "read_safe"), (api, "dsen2_60"),
                                           (api, "dsen2_20"), (writers, "write_bands")) as parts:
        wall, got = run_cli(argv)
    d2h = engine_d2h_bytes() - d2h0
    size = os.path.getsize(tif)
    other = wall - sum(v[0] for v in parts.values())
    print(f"s2_supres {FULL_TILE}^2 --run_60 uint16 on {card}: wall {wall:.3f} s = read "
          f"{parts['read_safe'][0]:.3f} s + SR 6x {parts['dsen2_60'][0]:.3f} s + SR 2x "
          f"{parts['dsen2_20'][0]:.3f} s + write {parts['write_bands'][0]:.3f} s + other "
          f"{other:.3f} s; GeoTIFF {size} B; read back by the engine {d2h} B; launches {got}",
          flush=True)
    check(d2h == FULL_TILE * FULL_TILE * 8 * 2, "s2_supres did not take the banded engine")
    cfg20 = InferConfig(patch_size=128, border=8, output_dtype="uint16")
    cfg60 = InferConfig(patch_size=192, border=12, output_dtype="uint16")
    sr60 = api.dsen2_60(d10, d20, d60[:, :, :2], infer_cfg=cfg60)
    sr20 = api.dsen2_20(d10, d20, infer_cfg=cfg20)
    t0 = time.perf_counter()
    check_geotiff(read_tiff, tif, sr20, sr60, 0, 0, f"s2_supres {FULL_TILE}^2")
    print(f"s2_supres {FULL_TILE}^2: the 8 SR bands equal dsen2_20 / dsen2_60 on the same "
          f"arrays bit for bit; EPSG {PRODUCT_EPSG}, tiepoint of the product (checked in "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    del sr20, sr60
    with installed_gdal(gdal):
        prof = device_profile(torch, lambda: run_cli(argv))
    print(f"s2_supres {FULL_TILE}^2 profiled: {idle_text(prof)}", flush=True)
    del d10, d20, d60, gdal

    # A JP2 product through the Pillow backend, at a pixel and a lon/lat ROI.
    if not has_jp2:
        print("jp2 decoder: absent on this machine", flush=True)
    else:
        t0 = time.perf_counter()
        mtd, arrays = build_safe(os.path.join(out_dir, "jp2"), np.random.default_rng(5),
                                 h10=JP2_SIZE, epsg=PRODUCT_EPSG, ulx=PRODUCT_ULX,
                                 uly=PRODUCT_ULY)
        print(f"JP2 product {JP2_SIZE}^2 (13 bands) encoded in {time.perf_counter() - t0:.1f} s",
              flush=True)
        x0, y0, x1, y1 = JP2_ROI
        corners = (*utm_inverse(PRODUCT_ULX + (x0 + 0.5) * 10, PRODUCT_ULY - (y0 + 0.5) * 10,
                                PRODUCT_EPSG % 100, True),
                   *utm_inverse(PRODUCT_ULX + (x1 + 0.5) * 10, PRODUCT_ULY - (y1 + 0.5) * 10,
                                PRODUCT_EPSG % 100, True))

        def window(res):
            f = res // 10
            return np.stack([arrays[b][y0 // f:(y1 + 1) // f, x0 // f:(x1 + 1) // f]
                             for b in PRODUCT_BANDS[res][:2 if res == 60 else None]], axis=-1)

        sr60 = api.dsen2_60(window(10), window(20), window(60),
                            infer_cfg=InferConfig(patch_size=192, border=12))
        sr20 = api.dsen2_20(window(10), window(20), infer_cfg=InferConfig(patch_size=128,
                                                                          border=8))
        for how, flags in (("roi_x_y", ["--roi_x_y", f"{x0},{y0},{x1},{y1}"]),
                           ("roi_lon_lat", ["--roi_lon_lat", ",".join(map(repr, corners))])):
            tif = os.path.join(out_dir, f"jp2_{how}.tif")
            wall, got = run_cli([mtd, tif, "--run_60", *flags])
            check_geotiff(read_tiff, tif, sr20, sr60, x0, y0, f"s2_supres JP2 --{how}")
            print(f"s2_supres JP2 {JP2_SIZE}^2 --{how} ({x1 - x0 + 1}^2 px, float32): wall "
                  f"{wall:.3f} s; SR bands equal the API's bit for bit; launches {got}",
                  flush=True)

    # create_patches on a .mat scene, then one streamed epoch at full width.
    prefix = os.path.join(HERE, "build", "smoke_patches")
    if os.path.isdir(prefix):
        shutil.rmtree(prefix)
    os.makedirs(prefix)
    im10, im20, im60 = synthetic_scene(6, PATCH_SCENE)
    mat = os.path.join(prefix, f"SYNTH_{PATCH_SCENE}.mat")
    scipy.io.savemat(mat, {"im10": im10, "im20": im20, "im60": im60})
    t0 = time.perf_counter()
    rc = create_patches.main([mat, "--save_prefix", prefix + "/", "--seed", "0"])
    t_cp = time.perf_counter() - t0
    rc_val = create_patches.main(["--make-val-index", "--save_prefix", prefix + "/"])
    tile = os.path.join(prefix, "train", f"SYNTH_{PATCH_SCENE}.SAFE")
    check(rc == 0 and rc_val == 0 and os.path.isfile(os.path.join(tile, "data20_gt.npy"))
          and os.path.isfile(os.path.join(prefix, "train", "val_index.npy")),
          "create_patches or --make-val-index")
    print(f"create_patches {PATCH_SCENE}^2 .mat: {t_cp:.3f} s for "
          f"{np.load(os.path.join(tile, 'data10.npy'), mmap_mode='r').shape[0]} crops", flush=True)

    seen = {}
    fit = loop.fit

    def recording_fit(cfg, tcfg, train_inputs, *a, **kw):
        t0 = time.perf_counter()
        out = fit(cfg, tcfg, train_inputs, *a, **kw)
        seen.update(wall=time.perf_counter() - t0, history=out[1], n_train=train_inputs.n_train)
        return out

    chain_mod.fused_resblock_chain.launches = 0
    block_mod.fused_resblock.launches = 0
    loop.fit = recording_fit
    try:
        rc = train_cli.main(["--path", prefix + "/", "--stream", "--epochs", "1",
                             "--precision", "default", "--model-nr", "s2_601_"])
    finally:
        loop.fit = fit
    hist = seen["history"]
    trained = {"fused_resblock_chain": chain_mod.fused_resblock_chain.launches,
               "fused_resblock": block_mod.fused_resblock.launches}
    print(f"cli.train --stream DSen2 2x default, 1 epoch: {seen['n_train']} train patches in "
          f"{seen['wall']:.3f} s ({seen['n_train'] / seen['wall']:.1f} patches/s with val and "
          f"set-up; phase 5 staged default: {staged_rate:.1f}); loss {hist['loss']}, val "
          f"{hist['val_loss']}; launches {trained}", flush=True)
    check(rc == 0 and np.isfinite(hist["loss"] + hist["val_loss"]).all(),
          "cli.train --stream loss")
    check(not any(trained.values()), "streamed training launched a residual-block kernel")

    src = os.path.join(HERE, "models", "s2_032_lr_1e-04.npz")
    dst = os.path.join(out_dir, "s2_032_roundtrip.npz")
    rc = convert_weights.main([src, dst])
    a, b = weights.load_params_npz(src), weights.load_params_npz(dst)
    same = a.keys() == b.keys() and all(
        a[t].keys() == b[t].keys() and all(np.array_equal(a[t][k], b[t][k]) for k in a[t])
        for t in a)
    print(f"convert_weights .npz -> .npz round trip: rc {rc}, bit-equal {same} (.hdf5 needs "
          f"h5py; tests/test_torch_io.py holds it to the JAX CLI)", flush=True)
    check(rc == 0 and same, "convert_weights round trip")
    return launches


# Phase 7's scene side for the 2400^2 runs (phase 3's scene).
MESH_SCENE = 2400


def phase_mesh(torch, api, weights, chain_mod, block_mod, card, banded_default, gpu):
    """The mesh on meshes that repeat the card `gpu`: sharded inference at
    full width against the single-device results, data-parallel training
    against the unsharded step, and --mesh 2's error on one GPU. Returns the
    kernels' launches in the inference runs."""
    from dsen2_tpu_torch.cli import s2_supres
    from dsen2_tpu_torch.core.config import InferConfig, TrainConfig, dsen2_2x
    from dsen2_tpu_torch.models import s2net
    from dsen2_tpu_torch.parallel import inference as pinf
    from dsen2_tpu_torch.parallel import make_mesh, make_train_step
    from dsen2_tpu_torch.train import fit
    from dsen2_tpu_torch.train.nadam import make_optimizer
    from dsen2_tpu_torch.weights import params_to_torch

    def mesh_of(n):
        return make_mesh([gpu] * n)

    def counts():
        return (chain_mod.fused_resblock_chain.launches, block_mod.fused_resblock.launches)

    models = os.path.join(HERE, "models")
    params20 = weights.load_params_npz(os.path.join(models, "s2_032_lr_1e-04.npz"))
    params60 = weights.load_params_npz(os.path.join(models, "s2_030_lr_1e-05.npz"))
    chain_mod.fused_resblock_chain.launches = 0
    block_mod.fused_resblock.launches = 0

    # Each shard worker runs on a stream of its own, which the kernels'
    # wrappers read as the thread's current stream.
    seen = {}

    def probe(s):
        seen[s] = torch.cuda.current_stream(gpu).cuda_stream
        return [torch.zeros(1, device=gpu)]

    pinf.run_on_shards([gpu] * 4, probe)
    default_stream = torch.cuda.current_stream(gpu).cuda_stream
    print(f"shard workers' current streams: {len(set(seen.values()))} distinct of 4, the "
          f"caller's default among them: {default_stream in seen.values()}", flush=True)
    check(len(set(seen.values())) == 4 and default_stream not in seen.values(),
          "shard workers do not run on streams of their own")

    # 1. The 10980^2 tile over 4 shards against phase 4's banded mosaic.
    d10, d20, _ = tiled_scene(1, FULL_TILE, TILE_BASE)
    cfg = InferConfig(patch_size=128, border=8, precision="default")
    mesh4 = mesh_of(4)
    b1 = counts()[0]
    _, cold, _ = timed(torch, lambda: api.dsen2_20(d10, d20, params=params20, infer_cfg=cfg,
                                                   mesh=mesh4))
    out, warm, peak = timed(torch, lambda: api.dsen2_20(d10, d20, params=params20,
                                                        infer_cfg=cfg, mesh=mesh4))
    b1 = counts()[0] - b1
    diff = float(np.abs(out - banded_default).max())
    limit = E2E_TOL["default"] * float(np.abs(banded_default).max())
    print(f"dsen2_20 {FULL_TILE}^2 default over [cuda:0] x 4: cold {cold:.3f} s, warm "
          f"{warm:.3f} s on {card}; peak device memory {peak / 2**30:.2f} GiB; max|diff vs "
          f"phase 4's banded mosaic| {diff:.3e} DN (limit {limit:.3f}), bit-equal "
          f"{bool(np.array_equal(out, banded_default))}; B1 blocks in two calls {b1}",
          flush=True)
    check(out.shape == banded_default.shape and np.isfinite(out).all(),
          "sharded 10980^2 output")
    check(diff <= limit and b1 > 0, "sharded 10980^2 mosaic strays from the banded one")
    del out, d10, d20

    def against_single(name, sharded, single, prec):
        t0 = time.perf_counter()
        got = sharded()
        wall = time.perf_counter() - t0
        want = single()
        diff = float(np.abs(got - want).max())
        limit = E2E_TOL[prec] * float(np.abs(want).max())
        print(f"{name}: {wall:.3f} s; max|diff vs one device| {diff:.3e} DN (limit "
              f"{limit:.3f}), bit-equal {bool(np.array_equal(got, want))}", flush=True)
        check(got.shape == want.shape and np.isfinite(got).all() and diff <= limit,
              f"{name} strays from the single-device result")

    # 2-5. dsen2_60 over 3 shards (uneven band heights, a flush row), the
    # patch-132 route over 2, the fleet of 4 tiles over 4, the ensemble.
    d10, d20, d60 = synthetic_scene(0, MESH_SCENE)
    cfg = InferConfig(patch_size=192, border=12, precision="high")
    against_single(f"dsen2_60 {MESH_SCENE}^2 high over [cuda:0] x 3",
                   lambda: api.dsen2_60(d10, d20, d60, params=params60, infer_cfg=cfg,
                                        mesh=mesh_of(3)),
                   lambda: api.dsen2_60(d10, d20, d60, params=params60, infer_cfg=cfg),
                   "high")
    cfg = InferConfig(patch_size=132, border=8, precision="default")
    b2 = counts()[1]
    against_single(f"dsen2_20 {MESH_SCENE}^2 patch 132 default over [cuda:0] x 2 (fused_resblock)",
                   lambda: api.dsen2_20(d10, d20, params=params20, infer_cfg=cfg,
                                        mesh=mesh_of(2)),
                   lambda: api.dsen2_20(d10, d20, params=params20, infer_cfg=cfg),
                   "default")
    check(counts()[1] > b2, "the patch-132 mesh run did not reach B2")
    cfg = InferConfig(patch_size=128, border=8, precision="default")
    tiles = [synthetic_scene(10 + i, MESH_SCENE)[:2] for i in range(4)]
    stacks = [np.stack([t[i] for t in tiles]) for i in range(2)]
    against_single(f"sr_tiles_sharded 4 tiles of {MESH_SCENE}^2 default over [cuda:0] x 4",
                   lambda: pinf.sr_tiles_sharded(params20, stacks, 2, dsen2_2x(), cfg,
                                                 mesh4),
                   lambda: np.stack([api.dsen2_20(*t, params=params20, infer_cfg=cfg)
                                     for t in tiles]),
                   "default")
    del tiles, stacks
    d10, d20 = synthetic_scene(2, MESH_SCENE)[:2]
    against_single(f"ensemble {MESH_SCENE}^2 default over [cuda:0] x 4",
                   lambda: api.dsen2_20(d10, d20, params=params20, infer_cfg=cfg,
                                        ensemble=True, mesh=mesh4),
                   lambda: api.dsen2_20(d10, d20, params=params20, infer_cfg=cfg,
                                        ensemble=True),
                   "default")
    launches = {"fused_resblock_chain": counts()[0], "fused_resblock": counts()[1]}
    print(f"mesh inference launches: {launches}", flush=True)
    for k, n in launches.items():
        check(n > 0, f"{k} was not launched on the mesh path")

    # 6. One data-parallel step, 2 shards, against the unsharded step.
    tcfg = dsen2_2x()
    xs, label = training_set(0, TRAIN_BATCH, 32, tcfg.in_channels)
    params0 = s2net.init_params(torch.Generator().manual_seed(0), tcfg)
    inputs = tuple(torch.as_tensor(x, device=gpu) for x in xs)
    target = torch.as_tensor(label, device=gpu)

    def one_step(mesh):
        params = {t: {k: v.clone().requires_grad_(True) for k, v in sub.items()}
                  for t, sub in params_to_torch(params0, gpu).items()}
        step = make_train_step(tcfg, make_optimizer(params, TrainConfig()), mesh=mesh,
                               precision="high")
        loss = float(step(params, inputs, target)["loss"])
        return loss, [t.grad for t in s2net.param_leaves(params)]

    before = counts()
    loss1, g1 = one_step(None)
    loss2, g2 = one_step(mesh_of(2))
    worst = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(g2, g1))
    print(f"data-parallel step DSen2 2x high, batch {TRAIN_BATCH} x 32^2 over [cuda:0] x 2: "
          f"loss {loss2:.7f} vs unsharded {loss1:.7f}; worst max|diff|/max|g| over the "
          f"{len(g1)} gradients {worst:.3e} (limit {E2E_TOL['high']})", flush=True)
    check(abs(loss2 - loss1) <= E2E_TOL["high"] * abs(loss1) and worst <= E2E_TOL["high"],
          "the data-parallel step strays from the unsharded one")

    # 7. A staged fit over 2 shards at "default": the loss falls.
    data = split(*training_set(1, 8 * TRAIN_BATCH + 64, 32, tcfg.in_channels),
                 8 * TRAIN_BATCH)
    t0 = time.perf_counter()
    _, hist = fit(tcfg, TrainConfig(batch_size=TRAIN_BATCH), *data, params=params0, epochs=2,
                  precision="default", stage_data=True, mesh=mesh_of(2), verbose=False)
    print(f"fit staged default over [cuda:0] x 2: 2 epochs of {8 * TRAIN_BATCH} crops in "
          f"{time.perf_counter() - t0:.3f} s (cold); loss {hist['loss']}, val "
          f"{hist['val_loss']}", flush=True)
    check(np.isfinite(hist["loss"] + hist["val_loss"]).all() and hist["loss"][1] < hist["loss"][0],
          "the staged mesh fit's loss did not fall")
    check(counts() == before, "mesh training launched a residual-block kernel")

    # 8. --mesh 2 without a device needs two GPUs.
    if torch.cuda.device_count() == 1:
        try:
            s2_supres.main([os.path.join(HERE, "build", "none", "MTD_MSIL1C.xml"), "out.tif",
                            "--mesh", "2"])
            msg = None
        except ValueError as e:
            msg = str(e)
        print(f"s2_supres --mesh 2 on one GPU: ValueError {msg!r}", flush=True)
        check(msg == "mesh 2x1 needs 2 devices, have 1", "--mesh 2 on one GPU did not raise")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    from dsen2_tpu_torch.infer import api
    from dsen2_tpu_torch import weights
    from dsen2_tpu_torch.ops import _build, resblock, resblock_chain
    from dsen2_tpu_torch.utils import profiling

    card = smi()
    print(f"device: {torch.cuda.get_device_name(0)}; count {torch.cuda.device_count()}")
    print(f"nvidia-smi: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    _build.load_library()
    log = _build.build_log
    print(f"kernel build: {log['seconds']:.2f} s -> {os.path.basename(log['path'])}")
    for line in log["ptxas"]:
        print(f"  ptxas: {line}")
    check(any("bytes spill" in line for line in log["ptxas"]),
          "no ptxas report for the kernels' library")
    spills = [line for line in log["ptxas"] if re.search(r"\b[1-9]\d* bytes spill", line)]
    check(not spills, f"ptxas reports register spills: {spills}")
    print(f"phase 1: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    res = phase_kernels(torch, resblock_chain, resblock)
    edges = phase_edges(torch)
    print(f"phase 2: {time.perf_counter() - t0:.1f} s", flush=True)

    def counted():
        c = profiling.counters()
        return {k: c.get(k, 0) for k in ("conv.plane_passes", "s2net.heads", "s2net.tails")}

    t0 = time.perf_counter()
    counted0 = counted()
    launches = phase_main_path(torch, api, weights, resblock_chain, resblock, card)
    print(f"phase 3: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    full, banded_default = phase_full_tile(torch, api, weights, resblock_chain,
                                           resblock, card)
    launches = {k: n + full[k] for k, n in launches.items()}
    print(f"phase 4: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    staged_rate, planes = phase_training(torch, resblock_chain, resblock, card)
    print(f"phase 5: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    cli = phase_production(torch, api, weights, resblock_chain, resblock, card,
                           staged_rate)
    launches = {k: n + cli.get(k, 0) for k, n in launches.items()}
    print(f"phase 6: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    mesh = phase_mesh(torch, api, weights, resblock_chain, resblock, card, banded_default,
                      torch.device("cuda", torch.cuda.current_device()))
    launches = {k: n + mesh.get(k, 0) for k, n in launches.items()}
    # The plane pass runs in phase 5's training alone; the head and tail on
    # the main path of phases 3, 4, 6 and 7.
    launches.update({k: n - counted0[k] for k, n in counted().items()})
    del banded_default
    print(f"phase 7: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    rcan_res, rcan_launches_n = phase_rcan(torch)
    print(f"phase 8: {time.perf_counter() - t0:.1f} s", flush=True)

    main_b1 = res[("chain", (64, 128, 128, 128), "float32", 3)]
    main_b2 = res[("block", (64, 132, 132, 128), "float32", 1)]
    kernels = [
        dict(name="fused_resblock_chain", route="cuda",
             source="dsen2_tpu_torch/csrc/resblock_chain.cu",
             replaces="dsen2_tpu/ops/pallas/resblock_chain.py:194",
             launches=launches["fused_resblock_chain"], **main_b1),
        dict(name="fused_resblock", route="cuda",
             source="dsen2_tpu_torch/csrc/resblock_chain.cu",
             replaces="dsen2_tpu/ops/pallas/resblock.py:151",
             launches=launches["fused_resblock"], **main_b2),
    ]
    # RCAN's kernels: "high", the rcan.roi cell's class, at RCAN_SHAPE;
    # launches in phase 8's runs of the body at published widths.
    rcan_src = "dsen2_tpu_torch/csrc/resblock_chain.cu"
    for name, case, counter in (("dsen2_conv3x3 (C=64, ReLU and residual epilogues)", "conv1",
                                 "rcan.convs"),
                                ("dsen2_conv3x3_pool (C=64, pooling epilogue)", "conv2_pool",
                                 "rcan.blocks"),
                                ("dsen2_ca_gate (ca_gate_kernel)", "gate", "rcan.gates")):
        kernels.append(dict(name=name, route="cuda", source=rcan_src,
                            replaces="none: the JAX package has no RCAN",
                            launches=rcan_launches_n[counter], **rcan_res[(case, "high")]))
    # The class conv's plane pass: "high" at a training step's body operand;
    # launches in phases 3 to 7 (training's, phase 5).
    kernels.append(dict(name="dsen2_class_planes (plane_kernel)", route="cuda",
                        source="dsen2_tpu_torch/csrc/resblock_chain.cu", replaces="none",
                        launches=launches["conv.plane_passes"],
                        **planes[(PLANE_SHAPES[0], "high")]))
    # DSen2's head and tail: "high" at dsen2_20's batch; launches in phases 3
    # to 7.
    for kind, counter in (("head", "s2net.heads"), ("tail", "s2net.tails")):
        kernels.append(dict(name=f"dsen2_{kind} ({kind}_kernel)", route="cuda",
                            source="dsen2_tpu_torch/csrc/resblock_chain.cu",
                            replaces="none: the JAX package's XLA convs",
                            launches=launches[counter],
                            **edges[(kind, "2x", "high")]))
    print(f"total: {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(f"nvidia-smi: {smi()}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
