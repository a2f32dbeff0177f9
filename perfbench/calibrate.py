#!/usr/bin/env python3
"""Readings that the limits in perfbench/limits/ are set from, on the card.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--half-batch-seeds 7,8,9]

For each seed, in one process: the cell's set-up and one request of its
traffic at the cell's own size, then the cell's check against the plain
reference. --seeds runs the program as the cell states it (the lower
readings); --control-seeds runs the program's own one-pass path, precision
"default", where the cell states "high" (the control); --half-batch-seeds
(training cells) compares the program with the reference fed half of each
batch (the fault "half of the batch left out"). One JSON line per seed;
the benchmark's own runs never run this.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import argparse
    import gc
    import json

    sys.path[0] = ROOT
    from perfbench import generators, harness
    from perfbench.trace import Tracer

    harness.cache_env(ROOT)
    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--half-batch-seeds", default="")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    runs = [("program", None, 1.0, s) for s in args.seeds.split(",") if s]
    runs += [("control", "default", 1.0, s) for s in args.control_seeds.split(",") if s]
    runs += [("half_batch", None, 0.5, s) for s in args.half_batch_seeds.split(",") if s]
    for role, precision, keep, seed in runs:
        t0 = time.perf_counter()
        make = generators.load(cell.traffic["generator"])
        d = make(cell.config, cell.traffic, int(seed), "cuda", Tracer(False), precision=precision)
        d.setup()
        t1 = time.perf_counter()
        rec = d.request(0)
        d.free()
        readings = d.check(keep=keep) if keep != 1.0 else d.check()
        print(json.dumps({"cell": cell.name, "role": role, "seed": int(seed),
                          "readings": readings, "request_s": rec["end"] - rec["start"],
                          "setup_s": t1 - t0, "total_s": time.perf_counter() - t0}),
              flush=True)
        del d
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
