"""The Keras-2 Nadam optimizer of the reference, as torch.optim.NAdam.

The reference trains with keras.optimizers.Nadam(lr=1e-4, beta_1=0.9,
beta_2=0.999, epsilon=1e-8, schedule_decay=0.004)
(training/supres_train.py:137-141), which dsen2_tpu/train/nadam.py writes
out as an optax transformation. torch.optim.NAdam with
momentum_decay=schedule_decay is the same update: the momentum schedule
mu_t = beta1 * (1 - 0.5 * 0.96^(t * schedule_decay)), its running product,
and the bias-corrected second moment (tests/test_train.py holds the two
within rtol 2e-5 over 50 steps). The learning rate lives in
`param_groups`, where the plateau scheduler changes it: the counterpart of
optax.inject_hyperparams.
"""

from __future__ import annotations

from typing import Dict

import torch

from dsen2_tpu_torch.core.config import TrainConfig
from dsen2_tpu_torch.models.s2net import param_leaves

__all__ = ["make_optimizer", "load_optimizer_state", "set_lr", "get_lr"]


def make_optimizer(params: Dict, train_cfg: TrainConfig) -> torch.optim.NAdam:
    """Keras-2 Nadam over the tensors of a params dict, in
    s2net.PARAM_NAMES order, with train_cfg's hyperparameters."""
    return torch.optim.NAdam(
        param_leaves(params), lr=train_cfg.lr, betas=(train_cfg.beta1, train_cfg.beta2),
        eps=train_cfg.eps, momentum_decay=train_cfg.schedule_decay,
    )


def load_optimizer_state(opt: torch.optim.NAdam, state_dict: Dict) -> None:
    """opt.load_state_dict(state_dict), with NAdam's mu_product kept on the
    host: load_state_dict moves every float state onto its parameter's
    device, but a non-capturable NAdam reads mu_product on the host at each
    step, which would make every step wait for the device."""
    opt.load_state_dict(state_dict)
    for st in opt.state.values():
        if "mu_product" in st:
            st["mu_product"] = st["mu_product"].cpu()


def get_lr(opt: torch.optim.Optimizer) -> float:
    return float(opt.param_groups[0]["lr"])


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = float(lr)
