"""edge_idle_share.tile: device idle time before the first and after the
last device activity of each entry-point call (dsen2_60, dsen2_20), the
banded engine's pipeline fill and drain: its seconds per traced request as
a share of an untraced request's wall, in %. Calls are the benchmark's host
spans around them; device activity is the profiler's."""
from perfbench import readers


def read(ctx):
    t = ctx.trace
    if t is None or not t.device:
        return None
    edges = [t.edge_idle_s(a, b) for a, b, _ in t.spans_named("perfbench.call.")]
    if not edges or any(e is None for e in edges):
        return None
    return readers.traced_share(ctx, "tile", sum(edges))
