"""gate_us.rcan: device microseconds per launch of RCAN's gate kernel
(ca_gate_kernel, found by name in the trace) in the traced requests: its
device time over the launches the program's counter rcan.gates counted in
them (the generator takes the counter before and after each request)."""
import re

GATE = re.compile(r"ca_gate_kernel")


def read(ctx):
    t = ctx.trace
    gates = sum(r.get("gates", 0) for r in ctx.traced_records)
    if t is None or not gates:
        return None
    device_s = sum(v for k, v in t.kernel_s.items() if GATE.search(k))
    return 1e6 * device_s / gates if device_s else None
