"""idle_share.product: the share of a request's wall in which the device runs
nothing: 1 - the device's busy seconds per traced request (the union of
its activity intervals in the profiler's trace) / the wall seconds of an
untraced request of the same window, in %. Kernel times on the device do
not depend on the profiler; the host's pace does."""
from perfbench import readers


def read(ctx):
    return readers.idle_share(ctx, "product")
