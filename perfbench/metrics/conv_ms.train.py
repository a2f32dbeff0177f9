"""conv_ms.train: device ms per training step of cuDNN's convolution
kernels (the class conv's forward, data and weight gradients; named by
readers.CONV_KERNEL) in the profiler's device trace, over every step of
the traced stretch of the window (the validation batches' forward convs
included)."""
from perfbench import readers


def read(ctx):
    conv, steps = readers.conv_device_s(ctx), readers.train_steps(ctx)
    if conv is None or not steps:
        return None
    return 1e3 * conv / steps
