#!/usr/bin/env python3
"""Planted faults in HAT's window attention, read by the hat.roi cell's
check at the cell's own size, on the card.

    python3 perfbench/faults_hat.py --seeds 1,2 [--faults dropped_mask,masked_padding]

dropped_mask: the shifted blocks' attention without its mask (the -100.0
between pixels of different bands of the rolled patch). masked_padding:
OCAB's keys outside the patch left out of the softmax, where they should
take part in it as zero vectors. The faulted geometry runs the plain
version (ops/window_attention.window_attention_plain) at the cell's class,
the others the kernel. For each fault and seed, in one process: the cell's
set-up and one request, then its check; one JSON line each, as
perfbench/calibrate.py prints them. The benchmark's own runs never run this.
"""

import contextlib
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULTS = ("dropped_mask", "masked_padding")


def masked_padding_chunk(qkv, table, heads, window, overlap):
    """OCAB's part of window_attention's _plain_chunk with the keys outside
    the patch masked out (a score of -1e9) instead of zero vectors; products
    in qkv's dtype."""
    from dsen2_tpu_torch.ops import window_attention as wa

    b, h, w, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    # Each window's outside keys, found from an image of ones.
    inside = wa._key_windows(qkv.new_ones((1, h, w, 1)), window, overlap)[..., 0] > 0
    q = wa._windows(qkv[..., :c], window)
    k = wa._key_windows(qkv[..., c:2 * c], window, overlap)
    v = wa._key_windows(qkv[..., 2 * c:], window, overlap)
    n, nq, nk = q.shape[0], q.shape[1], k.shape[1]
    q = q.reshape(n, nq, heads, d).transpose(1, 2) * d ** -0.5
    k = k.reshape(n, nk, heads, d).transpose(1, 2)
    v = v.reshape(n, nk, heads, d).transpose(1, 2)
    idx = wa.relative_index(window, overlap).to(qkv.device)
    s = q @ k.transpose(-2, -1) + table.to(q.dtype)[idx].permute(2, 0, 1)
    s = s.view(b, -1, heads, nq, nk).masked_fill(~inside[None, :, None, None, :], -1e9)
    o = torch.softmax(s.view(n, heads, nq, nk), -1) @ v
    o = o.transpose(1, 2).reshape(b, h // window, w // window, window, window, c)
    return o.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


@contextlib.contextmanager
def planted(fault: str):
    """The program's HAT runs with `fault` in its window attention."""
    from dsen2_tpu_torch.models import hat
    from dsen2_tpu_torch.ops import window_attention as wa

    kernel, mask, chunk = hat.window_attention, wa.shift_mask, wa._plain_chunk
    faulted = "shift" if fault == "dropped_mask" else "overlap"

    def attend(qkv, table, **geometry):
        if not geometry.get(faulted):
            return kernel(qkv, table, **geometry)
        return wa.window_attention_plain(qkv, table, **geometry)

    def masked(qkv, table, heads, window, shift, overlap, passes):
        if not overlap:
            return chunk(qkv, table, heads, window, shift, overlap, passes)
        return masked_padding_chunk(qkv, table, heads, window, overlap)

    hat.window_attention = attend
    if fault == "dropped_mask":
        wa.shift_mask = lambda *a: mask(*a) * 0
    else:
        wa._plain_chunk = masked
    try:
        yield
    finally:
        hat.window_attention, wa.shift_mask, wa._plain_chunk = kernel, mask, chunk


def main() -> int:
    import argparse
    import gc
    import json

    sys.path[0] = ROOT
    from perfbench import generators, harness
    from perfbench.trace import Tracer

    harness.cache_env(ROOT)
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", required=True)
    p.add_argument("--faults", default=",".join(FAULTS))
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("faults_hat: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell("hat.roi")
    for fault in args.faults.split(","):
        if fault not in FAULTS:
            raise ValueError(f"no fault {fault!r} (have {FAULTS})")
        for seed in (int(s) for s in args.seeds.split(",") if s):
            t0 = time.perf_counter()
            with planted(fault):
                make = generators.load(cell.traffic["generator"])
                d = make(cell.config, cell.traffic, seed, "cuda", Tracer(False))
                d.setup()
                rec = d.request(0)
            d.free()
            print(json.dumps({"cell": cell.name, "role": fault, "seed": seed,
                              "readings": d.check(), "request_s": rec["end"] - rec["start"],
                              "total_s": time.perf_counter() - t0}), flush=True)
            del d
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
