#!/usr/bin/env python3
"""Run one benchmark cell of dsen2_tpu_torch once and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the dsen2_tpu_torch package. The
cells are BENCHMARK.json's workloads; perfbench/harness.py says how one is
run. The last line of standard output is one JSON object (correct,
attempted, failed, metrics, device[, breakdown], checks); the numbers the
check compared, each with its limit, are also the last lines of standard
error. Without a CUDA device, or with fewer than the cell asks for, the run
fails and prints no result. It never imports JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path[0] = ROOT  # import perfbench and the program from the checkout
    from perfbench import harness

    harness.cache_env(ROOT)
    return harness.main(sys.argv[1:], T_START)


if __name__ == "__main__":
    sys.exit(main())
