"""Data-parallel training and evaluation steps over a device mesh.

The counterpart of dsen2_tpu/parallel/train_step.py, in the port's stateful
idiom: the params are leaf tensors on the mesh's first device, updated in
place by a torch.optim optimizer. Semantics are the reference fit loop's
inner step (MAE loss over the batch, MSE as a metric).

Under a mesh the batch splits over the 'data' axis. Each shard runs the
forward on differentiable `.to(device)` replicas of the params (the copy is
the identity where the device is the first one, as on a mesh that repeats
one device) and adds sum|err| / N to one loss on the first device, N being
the element count of the whole batch. One backward then runs every shard's
backward (autograd's per-device threads on distinct GPUs) and sums the
gradients into the params; one optimizer step follows. The result is the
unsharded step up to the order of f32 sums.

One process drives every device, as the JAX package does: there is no
process group, and a mesh may repeat one GPU, which NCCL (one rank per GPU)
could not run.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from dsen2_tpu_torch.core.config import ModelConfig
from dsen2_tpu_torch.models import s2net
from dsen2_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, ShardedParam, batch_sharding
from dsen2_tpu_torch.train.losses import mae, mse
from dsen2_tpu_torch.utils import profiling

__all__ = ["make_train_step", "make_eval_step"]


def shard_batch(mesh: Optional[Mesh], inputs: Sequence, target) -> List[Tuple[tuple, object]]:
    """[(inputs, target) per data shard, on its device]. `inputs` and
    `target` are tensors or numpy arrays, or per-shard lists as a
    Placement's place() returns them. Without a mesh, or for a batch that
    does not divide by the data axis (the final short batch), one pair on
    the mesh's first device."""
    if isinstance(target, (list, tuple)):
        return list(zip(zip(*inputs), target))
    if mesh is None:
        return [(tuple(torch.as_tensor(x) for x in inputs), torch.as_tensor(target))]
    ndev = mesh.shape[DATA_AXIS]
    if target.shape[0] % ndev:
        dev = mesh.devices[0, 0]
        return [(tuple(torch.as_tensor(x).to(dev) for x in inputs),
                 torch.as_tensor(target).to(dev))]
    shards = [batch_sharding(mesh, x.ndim).place(x) for x in inputs]
    return list(zip(zip(*shards), batch_sharding(mesh, target.ndim).place(target)))


def replicate_params(params: Dict, device: torch.device, row: int = 0) -> Dict:
    """The params on `device` for data shard `row`'s forward: differentiable
    copies of tensors (the tensor itself on its own device), numpy arrays
    uploaded, and the whole parameter of each ShardedParam, gathered from
    the shard's mesh row."""
    def one(v):
        if isinstance(v, ShardedParam):
            return v.gather(row)
        return torch.as_tensor(v).to(device)

    return {top: {k: one(v) for k, v in sub.items()} for top, sub in params.items()}


def _sharded_metrics(forward: Callable, params: Dict, shards, primary: torch.device):
    """(MAE, MSE) of the whole batch on `primary`, from each shard's sums
    over its own elements divided by the whole batch's element count (one
    shard: the plain means). The MSE carries no gradient."""
    if len(shards) == 1:
        (xs, t), = shards
        pred = forward(replicate_params(params, t.device), xs)
        return mae(pred, t), mse(pred.detach(), t)
    n = sum(t.numel() for _, t in shards)
    loss = sq_sum = None
    for row, (xs, t) in enumerate(shards):
        err = forward(replicate_params(params, t.device, row), xs) - t
        part = (torch.sum(torch.abs(err)) / n).to(primary)
        sq = (torch.sum(torch.square(err.detach())) / n).to(primary)
        loss = part if loss is None else loss + part
        sq_sum = sq if sq_sum is None else sq_sum + sq
    return loss, sq_sum


def _primary(mesh: Optional[Mesh], shards) -> torch.device:
    return mesh.devices[0, 0] if mesh is not None else shards[0][1].device


def make_train_step(
    cfg: ModelConfig,
    optimizer: torch.optim.Optimizer,
    mesh: Optional[Mesh] = None,
    precision: str = "highest",
    remat: bool = False,
) -> Callable:
    """Returns step(params, inputs, target) -> {"loss", "mse"} (device
    scalars, before the update), which updates `params` (the optimizer's
    leaf tensors, on the mesh's first device) in place. inputs is a tuple of
    NHWC arrays and target the NHWC label; under a mesh the batch splits over
    the data axis (shard_batch). The plain convs run at `precision`, forward
    and backward; neither residual-block kernel has a backward."""

    def forward(p, xs):
        return s2net.apply(p, xs, cfg, precision=precision, remat=remat, use_kernels=False)

    def step(params, inputs, target):
        with profiling.span("train.step"):
            shards = shard_batch(mesh, inputs, target)
            loss, sq = _sharded_metrics(forward, params, shards, _primary(mesh, shards))
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            with profiling.span("train.optimizer"):
                optimizer.step()
        profiling.count("train.steps")
        return {"loss": loss.detach(), "mse": sq}

    return step


def make_eval_step(
    cfg: ModelConfig,
    mesh: Optional[Mesh] = None,
    precision: str = "highest",
) -> Callable:
    """Returns ev(params, inputs, target) -> {"loss", "mse"} over the batch.
    params may be a params dict (numpy or tensors) or shard_params' output;
    under model sharding each data shard gathers the whole kernels from its
    mesh row and runs the plain forward, so the math is unchanged."""

    def forward(p, xs):
        return s2net.apply(p, xs, cfg, precision=precision, use_kernels=False)

    @torch.no_grad()
    def ev(params, inputs, target):
        shards = shard_batch(mesh, inputs, target)
        loss, sq = _sharded_metrics(forward, params, shards, _primary(mesh, shards))
        return {"loss": loss, "mse": sq}

    return ev
