"""gate_roofline.rcan: the least time the H100 needs for the bytes RCAN's
channel gates must move in the traced requests (perfbench/counts_rcan.
gate_bytes: x and y read and x + s * y written, f32, 12 C bytes per patch
pixel per RCAB, against 3.35 TB/s), over the device time of the gate kernel
(ca_gate_kernel) in the trace, found by name, in %."""
import re

from perfbench import counts
from perfbench.readers import of_kind

GATE = re.compile(r"ca_gate_kernel")


def read(ctx):
    t, c = ctx.trace, ctx.traced_counts
    if t is None or not c.get("gate_bytes") or not of_kind(ctx.traced_records, "tile"):
        return None
    device_s = sum(v for k, v in t.kernel_s.items() if GATE.search(k))
    if not device_s:
        return None
    return 100.0 * c["gate_bytes"] / counts.PEAK_BYTES / device_s
