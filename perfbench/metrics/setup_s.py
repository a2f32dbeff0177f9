"""setup_s: seconds from the process's start to the first timed request
(imports, inputs and weights from the seed, the kernels' build or load, the
warm-up), by the host clock."""


def read(ctx):
    return ctx.setup_s
