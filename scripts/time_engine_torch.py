#!/usr/bin/env python3
"""Time the port's banded engine end to end on one NVIDIA GPU: `dsen2_20` on
chip_smoke.py's seeded 10980 x 10980 uint16 tile with the shipped weights,
for the `dsen2_tpu_torch` package found under --root.

    python scripts/time_engine_torch.py [--root DIR]

To compare two versions of the package on one card, unpack the other into a
directory that .gitignore lists and run this script in turns, a b b a:

    for r in build/old . . build/old; do python scripts/time_engine_torch.py --root $r; done

For `high` and `default` float32 output and `default` uint16 output, prints
one JSON line: the wall seconds of CALLS warm calls (host clock around a
call that ends in a synchronise, after one warm-up call), MP/s of the best,
peak device memory, and from one more call under torch.profiler the device's
idle share with chip_smoke.device_profile's seconds (busy, kernels, copies,
idle at the edges and in gaps).
Scene, timer and profile are chip_smoke.py's (this checkout's).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = 2
RUNS = (("high", "float32"), ("default", "float32"), ("default", "uint16"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_engine_torch: needs a CUDA device", file=sys.stderr)
        return 2
    # chip_smoke imports no package of the port at module level, so the
    # package below comes from --root.
    sys.path.insert(0, ROOT)
    import chip_smoke

    sys.path.insert(0, os.path.abspath(args.root))
    from dsen2_tpu_torch import weights
    from dsen2_tpu_torch.core.config import InferConfig
    from dsen2_tpu_torch.infer import api

    root = os.path.relpath(os.path.abspath(args.root))
    card = chip_smoke.smi()
    print(f"nvidia-smi: {card}; package {api.__file__}", flush=True)
    params = weights.load_params_npz(os.path.join(ROOT, "models", "s2_032_lr_1e-04.npz"))
    d10, d20, _ = chip_smoke.tiled_scene(1, chip_smoke.FULL_TILE, chip_smoke.TILE_BASE)
    mp = d10.shape[0] * d10.shape[1] / 1e6
    for prec, out_dtype in RUNS:
        cfg = InferConfig(patch_size=128, border=8, precision=prec, output_dtype=out_dtype)

        def run():
            return api.dsen2_20(d10, d20, params=params, infer_cfg=cfg)

        chip_smoke.timed(torch, run)
        walls, peak = [], 0
        for _ in range(CALLS):
            _, wall, peak = chip_smoke.timed(torch, run)
            walls.append(wall)
        prof = chip_smoke.device_profile(torch, run)
        idle = None if prof["busy"] is None else 1 - prof["busy"] / prof["wall"]
        print(json.dumps(dict(
            root=root, precision=prec, output_dtype=out_dtype, wall_s=walls,
            mp_s=mp / min(walls), peak_gib=peak / 2**30, idle_share=idle, profile_s=prof,
            card=card,
        )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
