"""Device meshes, mesh-parallel inference and data-parallel training steps:
the counterpart of dsen2_tpu/parallel/, driven by one process."""

from dsen2_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    make_mesh,
    replicated,
    shard_params,
)
from dsen2_tpu_torch.parallel.train_step import make_eval_step, make_train_step

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "batch_sharding",
    "make_mesh",
    "replicated",
    "shard_params",
    "make_eval_step",
    "make_train_step",
]
