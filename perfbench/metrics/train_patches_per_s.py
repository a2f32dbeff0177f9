"""train_patches_per_s: training patches per second through fit, epochs
with their validation and bookkeeping, over all the window's calls' time,
the call in flight at the deadline included; host clock."""
from perfbench import readers


def read(ctx):
    return readers.rate(ctx, "train", "patches")
