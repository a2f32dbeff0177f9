#!/usr/bin/env python3
"""Time the port's residual-block kernels, B1 (`fused_resblock_chain`) and B2
(`fused_resblock`), on one NVIDIA GPU at chip_smoke.py's phase-2 cases, for
the `dsen2_tpu_torch` package found under --root.

    python scripts/time_resblock_torch.py [--root DIR]

To compare two versions of the kernels on one card, unpack the other
version's package into a directory that .gitignore lists and run this
script in turns in one session, a b b a:

    for r in build/old . . build/old; do python scripts/time_resblock_torch.py --root $r; done

Cases, inputs, bound and timer are chip_smoke.py's (this checkout's, whatever
--root is). Prints the card's name and power limit, then one JSON line per
case: mean device time by CUDA events over 20 calls after one warm-up, the
bound and its share, and the device time of one more call by kernel
(torch.profiler).
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

    if not torch.cuda.is_available():
        print("time_resblock_torch: needs a CUDA device", file=sys.stderr)
        return 2
    # chip_smoke imports no package of the port at module level, so the
    # package below comes from --root.
    sys.path.insert(0, ROOT)
    import chip_smoke

    sys.path.insert(0, os.path.abspath(args.root))
    from dsen2_tpu_torch.ops import resblock, resblock_chain

    root = os.path.relpath(os.path.abspath(args.root))
    card = chip_smoke.smi()
    print(f"nvidia-smi: {card}; package {resblock_chain.__file__}", flush=True)
    for kind, shape, k, dtype, passes in chip_smoke.CASES:
        gen = torch.Generator(device=torch.device("cuda")).manual_seed(0)
        inputs = chip_smoke.case_inputs(torch, gen, shape, k, dtype)
        run = chip_smoke.case_calls(resblock_chain, resblock, kind, passes, *inputs)[0]
        ms = chip_smoke.time_ms(torch, run, iters=ITERS)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        # Device time of one call by kernel name: where the call's time goes.
        split = {e.key[:72]: round(e.self_device_time_total / 1e3, 4)
                 for e in prof.key_averages() if e.self_device_time_total > 0}
        bound, by, _, _ = chip_smoke.bound_ms(shape, k, passes, inputs[0].element_size())
        print(json.dumps(dict(root=root, kernel=kind, shape=list(shape), K=k, dtype=dtype,
                              passes=passes, ms=round(ms, 4), bound_ms=round(bound, 4),
                              bound_by=by, share_of_bound=round(bound / ms, 4), card=card,
                              kernels_ms=split)), flush=True)
        del inputs, run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
