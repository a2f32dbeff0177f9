"""write_s.product: mean seconds per untraced product request of
io.writers.write_bands, by the host clock around the call (wrapped from
perfbench, as chip_smoke.timed_calls does)."""
from perfbench import readers


def read(ctx):
    return readers.mean_part(ctx, "product", "write")
