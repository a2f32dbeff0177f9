"""rcan_conv_roofline.rcan: the least time the H100 needs for the work of
RCAN's body convs in the traced requests, counted from the cell's shapes
(perfbench/counts_rcan.body_conv_work: the class's bf16 products of all
G (2 B + 1) + 1 body convs against 989 TFLOP/s; the body's input read once,
its output written once and the weights once per call against 3.35 TB/s),
over the device time of the conv kernel's C = 64 instantiations in the
trace, found by name, in %."""
import re

from perfbench import counts
from perfbench.readers import of_kind

C64 = re.compile(r"conv_kernel<\s*float\s*,\s*64\s*,")


def read(ctx):
    t, c = ctx.trace, ctx.traced_counts
    if t is None or not c.get("rcan_conv_flops") or not of_kind(ctx.traced_records, "tile"):
        return None
    device_s = sum(v for k, v in t.kernel_s.items() if C64.search(k))
    if not device_s:
        return None
    bound, _ = counts.bound_s(c["rcan_conv_flops"], c["rcan_conv_bytes"])
    return 100.0 * bound / device_s
