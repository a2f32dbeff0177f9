"""other_device_ms.train: device ms per traced training step of every device op
but cuDNN's convolution kernels (plane splits, adds, casts, the wgrad
chunks' sums, the MAE loss, Nadam, copies), from the profiler's device
trace."""
from perfbench import readers


def read(ctx):
    conv, steps = readers.conv_device_s(ctx), readers.train_steps(ctx)
    if conv is None or not steps:
        return None
    return 1e3 * (sum(ctx.trace.kernel_s.values()) - conv) / steps
