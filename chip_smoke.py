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
3. the main path at full DSen2 width (6 blocks x 128 features) with the
   shipped weights: dsen2_20 and dsen2_60 on a seeded synthetic uint16
   2400 x 2400 scene at "high" and "default", each held to the port's own
   "highest" output, plus one B2-route run (patch 132, "default") and one
   run under torch.inference_mode(); every kernel's launch count must rise;
4. one {"kernels": [...]} JSON line;
5. the card's name and power limit, then {"ok": true, "device": {...}}.

Any failed check exits non-zero before the last line. Without a CUDA device,
or without the dsen2_tpu_torch package beside it, the script fails.
"""

from __future__ import annotations

import json
import os
import re
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
    t_ops, t_bytes = flop / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flop, nbytes


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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runs["dsen2_20"][0](cfg)
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profile dsen2_20 high: wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / (wall * 1e3):.1f} %)", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<5d} {e.key[:90]}")
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
    print(f"phase 2: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    launches = phase_main_path(torch, api, weights, resblock_chain, resblock, card)
    print(f"phase 3: {time.perf_counter() - t0:.1f} s", flush=True)

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
    print(f"total: {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(f"nvidia-smi: {smi()}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
