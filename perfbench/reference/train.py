"""The first training steps of the DSen2 nets in plain PyTorch, float32, TF32 off.

Written from the reference's training/supres_train.py, not from
dsen2_tpu_torch: the loss is the mean absolute error over the batch
(loss='mean_absolute_error'), the optimizer Keras 2's Nadam(lr, beta_1,
beta_2, epsilon, schedule_decay) written out below, and the batches are
Keras fit's global shuffle: epoch 0 visits the training rows in the order
np.random.default_rng(seed).permutation(n_train), batch by batch.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from perfbench.reference import net as refnet


class KerasNadam:
    """Keras 2's Nadam update, one state per leaf."""

    def __init__(self, lr=1e-4, beta_1=0.9, beta_2=0.999, epsilon=1e-8, schedule_decay=0.004):
        self.lr, self.b1, self.b2 = lr, beta_1, beta_2
        self.eps, self.decay = epsilon, schedule_decay
        self.t = 0
        self.m_schedule = 1.0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        t = self.t
        mu_t = self.b1 * (1.0 - 0.5 * 0.96 ** (t * self.decay))
        mu_t1 = self.b1 * (1.0 - 0.5 * 0.96 ** ((t + 1) * self.decay))
        m_schedule_new = self.m_schedule * mu_t
        m_schedule_next = m_schedule_new * mu_t1
        self.m_schedule = m_schedule_new
        for k, g in grads.items():
            m = self.m.get(k, torch.zeros_like(g))
            v = self.v.get(k, torch.zeros_like(g))
            g_prime = g / (1.0 - m_schedule_new)
            m = self.b1 * m + (1.0 - self.b1) * g
            m_prime = m / (1.0 - m_schedule_next)
            v = self.b2 * v + (1.0 - self.b2) * g * g
            v_prime = v / (1.0 - self.b2 ** t)
            m_bar = (1.0 - mu_t) * g_prime + mu_t1 * m_prime
            params[k] = params[k] - self.lr * m_bar / (torch.sqrt(v_prime) + self.eps)
            self.m[k], self.v[k] = m, v


def batches(seed: int, n_train: int, batch: int, steps: int) -> List[np.ndarray]:
    """Row indices of the first `steps` batches of epoch 0."""
    perm = np.random.default_rng(seed).permutation(n_train)
    return [perm[s * batch:(s + 1) * batch] for s in range(steps)]


def first_steps(params: Dict, inputs: Sequence[np.ndarray], label: np.ndarray,
                rows: Sequence[np.ndarray], net: dict, opt: KerasNadam, device,
                keep: float = 1.0) -> dict:
    """Run one optimizer step per entry of `rows` (NHWC host inputs already
    divided by the reflectance scale). Returns {"loss": [each step's batch
    MAE before its update], "grad": {leaf: the first step's gradient},
    "start": {leaf: params before}, "end": {leaf: params after}}, all on the
    host. keep < 1 plants a fault: only that leading share of each batch
    enters the loss."""
    p = refnet.to_device(params, device)
    start = {k: v.detach().cpu() for k, v in p.items()}
    losses, first = [], None
    with refnet.no_tf32():
        for r in rows:
            r = np.asarray(r)[: max(1, int(round(len(r) * keep)))]
            xs = [torch.as_tensor(np.ascontiguousarray(a[r]), device=device).permute(0, 3, 1, 2)
                  for a in inputs]
            y = torch.as_tensor(np.ascontiguousarray(label[r]), device=device).permute(0, 3, 1, 2)
            leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            loss = torch.mean(torch.abs(refnet.forward(leaves, xs, net["residual_scale"]) - y))
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            losses.append(float(loss.detach()))
            if first is None:
                first = {k: g.detach().cpu() for k, g in grads.items()}
            p = {k: v.detach() for k, v in leaves.items()}
            opt.step(p, {k: g.detach() for k, g in grads.items()})
    return {"loss": losses, "grad": first, "start": start,
            "end": {k: v.detach().cpu() for k, v in p.items()}}
