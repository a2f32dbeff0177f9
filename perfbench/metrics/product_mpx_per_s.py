"""product_mpx_per_s: 10 m pixels (millions) super-resolved per second by the
window's product requests (s2_supres.main, SAFE product in, GeoTIFF
written): all their pixels over all their time, the request in flight at
the deadline included, the benchmark's read-back and delete of each file
left out; host clock."""
from perfbench import readers


def read(ctx):
    return readers.rate(ctx, "product", "mpx")
