"""sr_s.product: mean seconds per untraced product request of infer.api.dsen2_60 +
dsen2_20 inside the CLI, by the host clock around the calls (wrapped from
perfbench, as chip_smoke.timed_calls does)."""
from perfbench import readers


def read(ctx):
    return readers.mean_part(ctx, "product", "sr")
