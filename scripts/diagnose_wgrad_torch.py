#!/usr/bin/env python3
"""How accurate cuDNN's weight gradient of the class conv's planes is on one
NVIDIA GPU, by how many pixels one call reduces over.

    python scripts/diagnose_wgrad_torch.py

For the training steps' conv shapes (chip_smoke.py phase 5), takes the bf16
planes of seeded x and output gradient g (dsen2_tpu_torch/ops/conv.py's
_planes) and computes dw = x . g three ways: one cuDNN call over the whole
batch in TF32, the same with TF32 off (f32), and ops/conv.py's _wgrad, which
calls cuDNN in TF32 over batch chunks of at most _WGRAD_ROWS pixels and adds
the chunks in f32. Prints, for each, max|dw - ref| / max|ref| against the
same dw in float64 and the mean ms of 5 calls (CUDA events).
"""

from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (C_in, C_out, H = W, batch): the 2x head, block and tail at batch 128 of
# 32^2, the 6x head, block and tail at batch 128 of 96^2, a VDSen2 block.
SHAPES = ((10, 128, 32, 128), (128, 128, 32, 128), (128, 6, 32, 128),
          (12, 128, 96, 128), (128, 128, 96, 128), (128, 2, 96, 128), (256, 256, 32, 8))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("diagnose_wgrad_torch: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from dsen2_tpu_torch.core.device import tf32_disabled, tf32_for_bf16_operands
    from dsen2_tpu_torch.ops import conv

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"{card}; torch {torch.__version__}, cuDNN {torch.backends.cudnn.version()}; "
          f"_WGRAD_ROWS {conv._WGRAD_ROWS}")

    def whole(g, x, w, scope):
        with scope():
            return conv._grads(g, x, w, (False, True))[1]

    def chunked(g, x, w):
        with tf32_for_bf16_operands():
            return conv._wgrad(g, x, w)

    def ms(fn, iters=5):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    gen = torch.Generator(device="cuda").manual_seed(0)
    for cin, cout, hw, b in SHAPES:
        x = torch.randn((b, hw, hw, cin), generator=gen, device="cuda")
        w = torch.randn((3, 3, cin, cout), generator=gen, device="cuda") / (9 * cin) ** 0.5
        g = torch.randn((b, hw, hw, cout), generator=gen, device="cuda")
        xh = conv._planes(conv._nchw(x), "default")[0]
        gh = conv._planes(conv._nchw(g), "default")[0]
        wc = conv._oihw(w)
        ref = conv._grads(gh.double(), xh.double(), wc.double(), (False, True))[1]
        parts = []
        for name, fn in (("whole batch TF32", lambda: whole(gh, xh, wc, tf32_for_bf16_operands)),
                         ("whole batch f32", lambda: whole(gh, xh, wc, tf32_disabled)),
                         ("chunked TF32 (the port)", lambda: chunked(gh, xh, wc))):
            err = ((fn().double() - ref).abs().max() / ref.abs().max()).item()
            parts.append(f"{name} {err:.2e}, {ms(fn):.3f} ms")
        print(f"wgrad {cin}->{cout} [{b},{hw},{hw}] ({b * hw * hw} px): " + "; ".join(parts),
              flush=True)
        del x, w, g, xh, gh, wc, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
