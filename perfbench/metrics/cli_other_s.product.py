"""cli_other_s.product: mean seconds per untraced product request of the rest of
s2_supres.main: the request's wall minus read, SR and write (chiefly the
band concatenation), by the host clock around the wrapped calls."""
from perfbench import readers


def read(ctx):
    return readers.mean_part(ctx, "product", "other")
