"""mfu.train: model FLOPs of the untraced requests of the window, counted from
the cell's shapes (perfbench/counts.py; training 3x the forward), over
their wall time, as a share of the H100's dense bf16 peak (989 TFLOP/s),
in %."""
from perfbench import readers


def read(ctx):
    return readers.mfu(ctx, "train")
