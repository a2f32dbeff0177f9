"""b1_roofline.tile: the least time the H100 needs for the work kernel B1
(the residual blocks) must do in the traced requests, counted from the
cell's shapes (perfbench/counts.b1_work: the class's bf16 products against
989 TFLOP/s, x read once, out written once and the weights once per call
against 3.35 TB/s), over the device time of B1's calls in them (CUDA events
on its stream around each call of s2net.fused_resblock_chain), in %."""
from perfbench import counts, readers


def read(ctx):
    c = ctx.traced_counts
    if not ctx.b1_device_s or not c.get("b1_flops") or not readers.of_kind(
            ctx.traced_records, "tile"):
        return None
    bound, _ = counts.bound_s(c["b1_flops"], c["b1_bytes"])
    return 100.0 * bound / ctx.b1_device_s
