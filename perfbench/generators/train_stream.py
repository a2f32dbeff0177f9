"""Training through fit fed from the host: the train generator's traffic,
life cycle and check, with "stage_data": false.

fit's host route (train/loop.py) indexes and augments each batch on a
producer thread, copies it to the device and runs the step that
parallel.make_train_step returns, one batch at a time; it never calls
staged.masked_mean, where the train generator reads the first steps'
losses. Here set-up reads them from that step's results instead (one
readback a step for the first STEPS steps of set-up only); the optimizer's
first moment and the parameters after STEPS steps are read as the train
generator reads them.
"""

from __future__ import annotations

from perfbench.generators import train


class Generator(train.Generator):
    def __init__(self, config: dict, traffic: dict, seed: int, device, tracer, precision=None):
        if traffic["stage_data"]:
            raise ValueError("train_stream feeds fit from the host: stage_data must be false")
        super().__init__(config, traffic, seed, device, tracer, precision=precision)

    def setup(self) -> None:
        with observe_step_losses(self.seen):
            super().setup()


class observe_step_losses:
    """Inside the block, append the loss of each of fit's first STEPS
    training steps to seen["loss"], from the step make_train_step returns
    (validation runs make_eval_step's, which is not watched)."""

    def __init__(self, seen: dict):
        self.seen = seen

    def __enter__(self):
        from dsen2_tpu_torch import parallel

        seen = self.seen
        self._orig = make = parallel.make_train_step

        def make_train_step(*a, **kw):
            step = make(*a, **kw)

            def observed(params, inputs, target):
                m = step(params, inputs, target)
                if len(seen["loss"]) < train.STEPS:
                    seen["loss"].append(float(m["loss"]))
                return m

            return observed

        parallel.make_train_step = make_train_step
        return self

    def __exit__(self, *exc):
        from dsen2_tpu_torch import parallel

        parallel.make_train_step = self._orig
        return False
