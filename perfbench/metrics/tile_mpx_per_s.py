"""tile_mpx_per_s: 10 m pixels (millions) super-resolved per second by the
window's tile requests: all their pixels over all their time, the request
in flight at the deadline included, the benchmark's copies of the sampled
blocks left out; host clock."""
from perfbench import readers


def read(ctx):
    return readers.rate(ctx, "tile", "mpx")
