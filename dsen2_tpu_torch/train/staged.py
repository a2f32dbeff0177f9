"""Device-resident training epochs: the fast input pipeline.

The counterpart of dsen2_tpu/train/staged.py. The whole dataset is put on the
device once; each epoch is a loop of optimizer steps over device-resident
index tensors, so per epoch only the shuffle permutation, its mask and the
augmentation codes cross to the device, and the stacked losses come back in
one copy. No step reads anything back.

Semantics are the per-step loop's (train/loop.py): global shuffle, no
samples dropped. The final short batch is padded to full size with index 0
and masked out of the loss and the gradient: a masked mean over a padded
batch equals the plain mean over the short batch (held in
tests/test_torch_train.py). `epoch_aug_codes` and `pad_perm` are numpy
copies of the JAX package's, held equal there too.

Under a mesh (parallel/mesh.py) each step's batch splits over the 'data'
axis. The dataset is replicated on each data device (one copy per distinct
device), so each shard gathers its slice of the batch where it runs; the JAX
package shards the dataset's rows over the mesh instead and lets XLA gather
across devices. The memory layout differs, the trajectory does not: the
per-sample errors of every shard meet on the mesh's first device and go
through the same masked mean.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from dsen2_tpu_torch.core.config import ModelConfig
from dsen2_tpu_torch.core.device import upload
from dsen2_tpu_torch.models import s2net
from dsen2_tpu_torch.ops.dihedral import dihedral_batch
from dsen2_tpu_torch.parallel.mesh import DATA_AXIS, replicated
from dsen2_tpu_torch.parallel.train_step import replicate_params
from dsen2_tpu_torch.utils import profiling

__all__ = [
    "StagedData", "stage_dataset", "make_staged_epoch_fns", "pad_perm", "epoch_aug_codes",
    "masked_metrics",
]


def epoch_aug_codes(seed: int, epoch: int, steps: int, batch: int) -> np.ndarray:
    """Deterministic per-epoch augmentation codes [steps, batch] in [0, 8).
    Keyed by (seed, epoch) so resumed runs draw identical codes without
    fast-forwarding a stream."""
    rng = np.random.default_rng([seed, epoch])
    return rng.integers(0, 8, size=(steps, batch), dtype=np.int32)


def pad_perm(perm: np.ndarray, batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Reshape a sample-index permutation into [steps, batch] index and
    f32 mask arrays, padding the final short batch with index 0 / mask 0."""
    n = len(perm)
    steps = -(-n // batch_size)
    pad = steps * batch_size - n
    idx = np.concatenate([perm, np.zeros(pad, perm.dtype)])
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    return (
        idx.astype(np.int32).reshape(steps, batch_size),
        mask.reshape(steps, batch_size),
    )


def per_sample_errors(pred: torch.Tensor, target: torch.Tensor):
    """Each sample's (MAE, MSE), [B] each; the MSE carries no gradient."""
    return (torch.mean(torch.abs(pred - target), dim=(1, 2, 3)),
            torch.mean(torch.square(pred.detach() - target), dim=(1, 2, 3)))


def masked_mean(per_mae: torch.Tensor, per_mse: torch.Tensor, mask: torch.Tensor):
    """The mask-weighted means of per-sample errors, which equal the plain
    batch means when the batch is full and the short-batch means when it is
    padded."""
    denom = torch.clamp(torch.sum(mask), min=1.0)
    return torch.sum(per_mae * mask) / denom, torch.sum(per_mse * mask) / denom


def masked_metrics(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor):
    """(MAE, MSE) over the samples where mask is 1: per-sample means, then
    the mask-weighted mean. The MSE carries no gradient."""
    return masked_mean(*per_sample_errors(pred, target), mask)


@dataclasses.dataclass
class StagedData:
    """The device-resident dataset and its epoch functions. Under a mesh,
    each train and val array is a list of its copies, one per data shard."""

    train_inputs: Tuple[torch.Tensor, ...]
    train_labels: torch.Tensor
    val_inputs: Tuple[torch.Tensor, ...]
    val_labels: torch.Tensor
    val_idx: torch.Tensor  # [S, B] int32, fixed order
    val_mask: torch.Tensor  # [S, B] f32
    train_epoch: Callable
    eval_epoch: Callable


def stage_dataset(
    cfg: ModelConfig,
    batch_size: int,
    train_inputs: Sequence[np.ndarray],
    train_labels: np.ndarray,
    val_inputs: Sequence[np.ndarray],
    val_labels: np.ndarray,
    device: torch.device,
    precision: str = "high",
    remat: bool = False,
    augment: bool = False,
    mesh=None,
) -> StagedData:
    """Put the dataset on `device` once and build the epoch functions. Under
    a mesh, `device` is the mesh's first, and each array becomes a list of
    its copies on the data devices (replicated(mesh).place)."""
    def stage(a):
        t = upload(np.asarray(a, np.float32), device)
        return t if mesh is None else replicated(mesh).place(t)

    vi, vm = pad_perm(np.arange(val_labels.shape[0]), batch_size)
    train_epoch, eval_epoch = make_staged_epoch_fns(
        cfg, precision=precision, remat=remat, augment=augment, mesh=mesh)
    return StagedData(
        train_inputs=tuple(stage(a) for a in train_inputs), train_labels=stage(train_labels),
        val_inputs=tuple(stage(a) for a in val_inputs), val_labels=stage(val_labels),
        val_idx=upload(vi, device), val_mask=upload(vm, device),
        train_epoch=train_epoch, eval_epoch=eval_epoch,
    )


def make_staged_epoch_fns(
    cfg: ModelConfig, precision: str = "high", remat: bool = False, augment: bool = False,
    mesh=None,
) -> Tuple[Callable, Callable]:
    """Build (train_epoch, eval_epoch):

    train_epoch(params, opt, inputs, labels, idx[S,B], mask[S,B], aug[S,B])
        -> (loss, mse) device scalars, weighted like Keras fit; updates
        params through the optimizer `opt` in place
    eval_epoch(params, inputs, labels, idx, mask) -> (loss, mse)

    With augment=True each training sample gets the dihedral symmetry
    aug[s, b] on every input and on the label; validation is never
    augmented. Under a mesh, inputs and labels are stage_dataset's per-device
    lists, and a batch that does not divide by the data axis runs on the
    first device.
    """

    def forward(params, binputs):
        return s2net.apply(params, binputs, cfg, precision=precision, remat=remat,
                           use_kernels=False)

    def shards(inputs, labels, n):
        """(inputs, labels, rows of the batch, data row) per shard."""
        if mesh is None:
            return [(inputs, labels, slice(None), 0)]
        ndev = mesh.shape[DATA_AXIS]
        if n % ndev:
            return [(tuple(a[0] for a in inputs), labels[0], slice(None), 0)]
        per = n // ndev
        return [(tuple(a[r] for a in inputs), labels[r], slice(r * per, (r + 1) * per), r)
                for r in range(ndev)]

    def batch_metrics(params, inputs, labels, bidx, bmask, baug=None):
        per_mae, per_mse = [], []
        for xs, lb, rows, r in shards(inputs, labels, bidx.shape[0]):
            dev = lb.device
            i = bidx[rows].to(dev)
            binputs = tuple(torch.index_select(a, 0, i) for a in xs)
            btarget = torch.index_select(lb, 0, i)
            if baug is not None:
                codes = baug[rows].to(dev)
                binputs = tuple(dihedral_batch(a, codes) for a in binputs)
                btarget = dihedral_batch(btarget, codes)
            p = params if mesh is None else replicate_params(params, dev, r)
            a, b = per_sample_errors(forward(p, binputs), btarget)
            per_mae.append(a.to(bmask.device))
            per_mse.append(b.to(bmask.device))
        return masked_mean(torch.cat(per_mae), torch.cat(per_mse), bmask)

    def train_epoch(params, opt, inputs, labels, idx, mask, aug):
        losses, mses = [], []
        for s in range(idx.shape[0]):
            with profiling.span("train.step"):
                loss, mse_ = batch_metrics(params, inputs, labels, idx[s], mask[s],
                                           aug[s] if augment else None)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                with profiling.span("train.optimizer"):
                    opt.step()
            profiling.count("train.steps")
            losses.append(loss.detach())
            mses.append(mse_)
        counts = torch.sum(mask, dim=1)
        w = counts / torch.sum(counts)
        return torch.sum(torch.stack(losses) * w), torch.sum(torch.stack(mses) * w)

    @torch.no_grad()
    def eval_epoch(params, inputs, labels, idx, mask):
        ls, ms, cs = [], [], []
        for s in range(idx.shape[0]):
            loss, mse_ = batch_metrics(params, inputs, labels, idx[s], mask[s])
            c = torch.sum(mask[s])
            ls.append(loss * c)
            ms.append(mse_ * c)
            cs.append(c)
        total = torch.sum(torch.stack(cs))
        return torch.sum(torch.stack(ls)) / total, torch.sum(torch.stack(ms)) / total

    return train_epoch, eval_epoch
