#!/usr/bin/env python3
"""A control for a limit in perfbench/limits/: the program run at the
precision just below the one its cell states, which the cell's check must
call not correct.

    python3 perfbench/controls.py --workload dsen2.tile.default --seeds 1,2,3

fp8_weights: below "default" (one pass of bf16 operands, f32 sums) comes
float8 e4m3, the other operand format of the H100's tensor cores. The
program is given its weights in e4m3 as a deployment with a scale per
tensor stores them: each weight array scaled so that its largest |w| is 448
(e4m3's largest finite value), rounded to e4m3 and scaled back. The
reference keeps the float32 weights. For each seed, in one process: the
cell's set-up and one request at the cell's own size with that control,
then the cell's check; one JSON line per seed, as perfbench/calibrate.py
prints them. The benchmark's own runs never run this.
"""

import contextlib
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fp8_e4m3(v) -> torch.Tensor:
    """v rounded to float8 e4m3 under a scale that maps max|v| to 448."""
    v = torch.as_tensor(v).float()
    top = v.abs().max()
    if top == 0:
        return v.clone()
    scale = 448.0 / top
    return (v * scale).to(torch.float8_e4m3fn).float() / scale


@contextlib.contextmanager
def fp8_weights():
    """The tile generators' program calls take e4m3-rounded weights."""
    from perfbench.generators import tile

    nested = tile.nested
    tile.nested = lambda flat: nested({k: fp8_e4m3(v) for k, v in flat.items()})
    try:
        yield
    finally:
        tile.nested = nested


def main() -> int:
    import argparse
    import json

    sys.path[0] = ROOT
    from perfbench import generators, harness
    from perfbench.trace import Tracer

    harness.cache_env(ROOT)
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",") if s):
        t0 = time.perf_counter()
        with fp8_weights():
            make = generators.load(cell.traffic["generator"])
            d = make(cell.config, cell.traffic, seed, "cuda", Tracer(False))
            d.setup()
            rec = d.request(0)
        d.free()
        print(json.dumps({"cell": cell.name, "role": "fp8_weights", "seed": seed,
                          "readings": d.check(), "request_s": rec["end"] - rec["start"],
                          "total_s": time.perf_counter() - t0}), flush=True)
        del d
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
