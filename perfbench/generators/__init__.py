"""Traffic generators: the general code that reads a traffic mix's file.

A traffic file in perfbench/traffic/ names its generator ("generator":
"tile") and gives its parameters; perfbench/generators/<name>.py holds a
class `Generator` with this life cycle, which perfbench/harness.py runs:

    d = Generator(config, traffic, seed, device, tracer, precision=None)
    d.setup()                  # inputs and weights from the seed, warm-up
    rec = d.request(i)         # one request of the window: a dict with
                               # "start", "end" (perf_counter seconds) and
                               # the work it did ("mpx", "patches", ...)
    d.free()                   # drop the program's state
    d.check() -> {name: value} # the numbers compared with their limits
    d.counts(records) -> dict  # work of the window counted from its shapes

`precision` overrides the accuracy class the traffic states (the control
runs the program's own one-pass path, "default").
"""

from __future__ import annotations

import importlib

import numpy as np


def load(name: str):
    """The Generator class of perfbench/generators/<name>.py."""
    if not name.replace("_", "").isalnum():
        raise ValueError(f"bad generator name {name!r}")
    return importlib.import_module(f"perfbench.generators.{name}").Generator


def seed_int(*parts: int) -> int:
    """A 63-bit integer drawn from a seed sequence over `parts`: distinct
    streams for the tiles, samples and weights of one --seed."""
    words = [int(p) % (1 << 64) for p in parts]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))
