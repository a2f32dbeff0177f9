#!/usr/bin/env python3
"""HAT's window-attention kernel and HAT's net on one NVIDIA GPU, alone:
chip_smoke.py's phase 9 with the kernel library's build report.

    python scripts/time_hat_torch.py

Prints the card's name and power limit, ptxas's registers and spills for
each kernel of csrc/window_attention.cu (a spill fails the run), then phase
9's lines (each geometry and class against float64 with ms, plain ms,
library ms, bound and share; the net at published widths on a batch of 64
patches at "high" and "default" against the reference) and one JSON line of
its results.
"""

from __future__ import annotations

import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_hat_torch: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from dsen2_tpu_torch.ops import _build

    print(f"nvidia-smi: {chip_smoke.smi()}", flush=True)
    _build.build("window_attention")
    log = _build.build_log["window_attention"]
    print(f"kernel build: {log['seconds']:.2f} s -> {os.path.basename(log['path'])}")
    for line in log["ptxas"]:
        print(f"  ptxas: {line}")
    spills = [line for line in log["ptxas"] if re.search(r"\b[1-9]\d* bytes spill", line)]
    chip_smoke.check(not spills, f"ptxas reports register spills: {spills}")
    res, launches = chip_smoke.phase_hat(torch)
    print(json.dumps({"results": {f"{c} {p}": v for (c, p), v in res.items()},
                      "launches": launches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
