"""Training through fit: staged epochs of the DSen2 net on seeded crops.

Traffic parameters: head (the net of the configuration), crops (seeded
hw x hw crops, frozen.training_set), hw, batch, val_fraction (the trailing
share held out for validation), stage_data.

Set-up builds the training state from the seed (the configuration's
weights, fit's own Nadam) and runs fit's first call, epoch 0, with its
first three steps observed: each step's loss, the optimizer's first
moment after step 1 (its first gradient times 1 - beta_1) and the
parameters after step 3. The window then calls fit again and again, one
epoch a call, every call resuming the parameters, optimizer state and
history the last one returned. The check follows the same three steps with
the plain reference, and holds the window's calls to what needs none: the
optimizer has counted every step of set-up and window, every leaf that the
reference moves has moved over the window, and every epoch's losses are
finite.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import counts, frozen
from perfbench.generators import seed_int
from perfbench.generators.tile import make_weights, nested
from perfbench.reference import compare
from perfbench.reference import train as reftrain

STEPS = 3


class Generator:
    def __init__(self, config: dict, traffic: dict, seed: int, device, tracer, precision=None):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.tracer = torch.device(device), tracer
        self.precision = precision or traffic.get("precision", config["precision"])
        self.net = config["nets"][traffic["head"]]
        self.seen = {"loss": [], "m1": None, "end": None, "names": None}
        self.window = {}  # parameters before and after the window, and its end state
        self.calls = 0

    def _train_config(self):
        from dsen2_tpu_torch.core.config import TrainConfig

        return TrainConfig(batch_size=self.traffic["batch"], seed=self.seed % (1 << 63),
                           val_fraction=self.traffic["val_fraction"])

    def _model_config(self):
        from dsen2_tpu_torch.core.config import ModelConfig

        n = self.net
        return ModelConfig(in_channels=tuple(n["in_channels"]), num_layers=n["num_layers"],
                           feature_size=n["feature_size"], residual_scale=n["residual_scale"])

    def _fit(self, epochs: int):
        from dsen2_tpu_torch.train import loop

        state, hist = self.state, self.history
        start = 0 if state is None else state.epoch
        kw = {} if state is None else {"opt_state": state.opt_state}
        self.state, self.history = loop.fit(
            self._model_config(), self._train_config(), self.train_x, self.train_y,
            self.val_x, self.val_y, params=self.params if state is None else state.params,
            epochs=start + epochs, start_epoch=start, history=hist, precision=self.precision,
            stage_data=self.traffic["stage_data"], verbose=False, device=self.device, **kw)

    def setup(self) -> None:
        tr = self.traffic
        t0 = time.perf_counter()
        xs, label = frozen.training_set(seed_int(self.seed, 1, 0), tr["crops"], tr["hw"],
                                        self.net["in_channels"])
        self.n_train = int(round(tr["crops"] * (1 - tr["val_fraction"])))
        self.inputs, self.label = xs, label
        self.train_x = tuple(x[:self.n_train] for x in xs)
        self.train_y = label[:self.n_train]
        self.val_x = tuple(x[self.n_train:] for x in xs)
        self.val_y = label[self.n_train:]
        self.flat = make_weights(self.net, self.seed, 0, "cpu")
        self.params = nested({k: np.asarray(v) for k, v in self.flat.items()})
        self.state, self.history = None, None
        t1 = time.perf_counter()
        with observe_first_steps(self.seen):
            self._fit(1)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.window["before"] = _leaves(self.state.params)
        self.setup_parts = {"inputs and weights": round(t1 - t0, 2),
                            "epoch 0": round(time.perf_counter() - t1, 2)}

    def steps_per_epoch(self) -> int:
        """fit's steps in one epoch: the last batch is a short one."""
        return -(-self.n_train // self.traffic["batch"])

    def request(self, i: int) -> dict:
        rec = {"kind": "train", "start": time.perf_counter()}
        with self.tracer.span("request"):
            self._fit(1)
        rec["end"] = time.perf_counter()
        self.calls += 1
        rec["patches"] = self.n_train
        rec["steps"] = self.steps_per_epoch()
        return rec

    def free(self) -> None:
        self.tracer.close()
        if self.state is not None:
            self.window["after"] = _leaves(self.state.params)
            self.window["steps"] = [float(st["step"]) for st in
                                    self.state.opt_state["state"].values()]
            self.window["losses"] = [float(v) for key in ("loss", "val_loss")
                                     for v in self.history[key]]
        self.state = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def check(self, keep: float = 1.0) -> dict:
        """loss_gap: the largest |loss - reference loss| / reference loss of
        the first three steps; grad_gap: the worst leaf's gap between the
        norms of the first gradient (from the optimizer's first moment) and
        the reference's; change_gap: the same for the parameters' change
        over the three steps, over the leaves the reference moves. A `keep`
        below 1 runs the reference with that share of each batch (a planted
        fault, for calibration)."""
        seen = self.seen
        if len(seen["loss"]) < STEPS or seen["m1"] is None or seen["end"] is None:
            return {"loss_gap": float("inf"), "grad_gap": float("inf"),
                    "change_gap": float("inf")}
        tc = self._train_config()
        rows = reftrain.batches(tc.seed, self.n_train, self.traffic["batch"], STEPS)
        opt = reftrain.KerasNadam(tc.lr, tc.beta1, tc.beta2, tc.eps, tc.schedule_decay)
        ref = reftrain.first_steps(self.flat, self.train_x, self.train_y, rows, self.net, opt,
                                   self.device, keep=keep)
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(seen["loss"], ref["loss"]))
        g_ref = compare.leaf_norms(ref["grad"])
        g_got = {k: v / (1 - tc.beta1) for k, v in compare.leaf_norms(seen["m1"]).items()}
        start = {k: torch.as_tensor(np.asarray(v)) for k, v in self.flat.items()}
        d_ref = compare.leaf_norms({k: ref["end"][k] - ref["start"][k] for k in ref["end"]})
        d_got = compare.leaf_norms({k: seen["end"][k].cpu() - start[k].to(seen["end"][k].dtype)
                                    for k in seen["end"]})
        moved = compare.moved_leaves(g_ref)
        return {"loss_gap": loss_gap, "grad_gap": compare.worst_leaf_gap(g_got, g_ref),
                "change_gap": compare.worst_leaf_gap(d_got, d_ref, moved),
                **self._window_checks(moved)}

    def _window_checks(self, moved) -> dict:
        """step_count_gap: the largest |steps the optimizer counted for a
        leaf - steps of set-up and window|; unmoved_leaves: leaves the
        reference moves whose values are the same before and after the
        window; nonfinite_losses: epochs' train and validation losses that
        are not finite. Each is exact: its limit is 0."""
        w = self.window
        if "after" not in w or len(w["steps"]) != len(w["before"]):
            return {"step_count_gap": float("inf"), "unmoved_leaves": float("inf"),
                    "nonfinite_losses": float("inf")}
        want = self.steps_per_epoch() * (1 + self.calls)
        return {"step_count_gap": max(abs(s - want) for s in w["steps"]),
                "unmoved_leaves": float(sum(torch.equal(w["before"][k], w["after"][k])
                                            for k in moved)),
                "nonfinite_losses": float(sum(not np.isfinite(v) for v in w["losses"]))}

    def counts(self, records) -> dict:
        steps = sum(r.get("steps", 0) for r in records)
        return {"train_steps": steps,
                "model_flops": steps * counts.train_step_flops(self.net, self.traffic["batch"],
                                                               self.traffic["hw"])}


def _leaves(params: dict) -> dict:
    """{"head.w": host copy, ...} of fit's {top: {name: tensor}} params."""
    return {f"{top}.{name}": v.detach().cpu().clone()
            for top, sub in params.items() for name, v in sub.items()}


class observe_first_steps:
    """Inside the block, record fit's first STEPS training steps into
    `seen`: each batch's loss (staged.masked_mean's first results, the
    training steps coming before any validation batch), the optimizer's
    first moment after step 1 and the parameters after step STEPS, by leaf
    name (s2net.PARAM_NAMES order, the optimizer's order)."""

    def __init__(self, seen: dict):
        self.seen = seen

    def __enter__(self):
        from dsen2_tpu_torch.models import s2net
        from dsen2_tpu_torch.train import loop, staged

        seen = self.seen
        names = [f"{top}.{name}" for top, name in s2net.PARAM_NAMES]
        self._orig = (loop.make_optimizer, staged.masked_mean)
        make_opt, masked = self._orig

        def masked_mean(*a, **kw):
            out = masked(*a, **kw)
            if len(seen["loss"]) < STEPS:
                seen["loss"].append(float(out[0].detach()))
            return out

        def make_optimizer(params, train_cfg):
            opt = make_opt(params, train_cfg)
            count = {"n": 0}

            def after_step(o, args, kwargs):
                count["n"] += 1
                leaves = o.param_groups[0]["params"]
                if count["n"] == 1:
                    seen["m1"] = {k: o.state[p]["exp_avg"].detach().cpu().clone()
                                  for k, p in zip(names, leaves)}
                if count["n"] == STEPS:
                    seen["end"] = {k: p.detach().cpu().clone() for k, p in zip(names, leaves)}

            opt.register_step_post_hook(after_step)
            return opt

        loop.make_optimizer, staged.masked_mean = make_optimizer, masked_mean
        return self

    def __exit__(self, *exc):
        from dsen2_tpu_torch.train import loop, staged

        loop.make_optimizer, staged.masked_mean = self._orig
        return False
