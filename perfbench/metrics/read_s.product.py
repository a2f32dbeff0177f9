"""read_s.product: mean seconds per untraced product request of
data.safe_reader.read_safe, by the host clock around the call (wrapped
from perfbench, as chip_smoke.timed_calls does)."""
from perfbench import readers


def read(ctx):
    return readers.mean_part(ctx, "product", "read")
