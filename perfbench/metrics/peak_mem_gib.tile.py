"""peak_mem_gib.tile: the most device memory the program's allocator held
during the window (torch.cuda.max_memory_allocated after a reset at the
window's start), in GiB."""
from perfbench import readers


def read(ctx):
    if ctx.window_peak_bytes is None or not readers.of_kind(ctx.records, "tile"):
        return None
    return ctx.window_peak_bytes / 2**30
