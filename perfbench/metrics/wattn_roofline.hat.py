"""wattn_roofline.hat: the least time the H100 needs for the window-attention
work of the traced requests, counted from the cell's shapes
(perfbench/counts_hat.attention_work: 4 N_k C operations per query pixel per
HAB and OCAB times the class's passes against 989 TFLOP/s; q, k and v read
once and the output written once at the class's operand width against
3.35 TB/s), over the device time of the window-attention kernel
(window_attention_kernel) in the trace, found by name, in %."""
import re

from perfbench import counts
from perfbench.readers import of_kind

KERNEL = re.compile(r"window_attention_kernel")


def read(ctx):
    t, c = ctx.trace, ctx.traced_counts
    if t is None or not c.get("wattn_flops") or not of_kind(ctx.traced_records, "tile"):
        return None
    device_s = sum(v for k, v in t.kernel_s.items() if KERNEL.search(k))
    if not device_s:
        return None
    bound, _ = counts.bound_s(c["wattn_flops"], c["wattn_bytes"])
    return 100.0 * bound / device_s
