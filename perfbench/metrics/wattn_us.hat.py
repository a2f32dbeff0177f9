"""wattn_us.hat: device microseconds per launch of the window-attention
kernel (window_attention_kernel, found by name in the trace) in the traced
requests: its device time over the launches the program's counter hat.attn
counted in them (the generator takes the counter before and after each
request)."""
import re

KERNEL = re.compile(r"window_attention_kernel")


def read(ctx):
    t = ctx.trace
    launches = sum(r.get("attn", 0) for r in ctx.traced_records)
    if t is None or not launches:
        return None
    device_s = sum(v for k, v in t.kernel_s.items() if KERNEL.search(k))
    return 1e6 * device_s / launches if device_s else None
