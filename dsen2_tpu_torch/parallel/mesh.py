"""Device meshes and placements.

The counterpart of dsen2_tpu/parallel/mesh.py. The workload is
patch-parallel: every patch carries its own halo, so the natural mapping is
data parallelism over the patch or batch axis with the params replicated. A
second 'model' axis splits the conv feature dims (the VDSen2-scale variant).

A `Mesh` is a (data, model) grid of `torch.device`s driven by one process:
shard s of the data axis runs on `mesh.devices[s, 0]`. Entries may repeat
one device: `make_mesh(devices=[torch.device("cpu")] * 8)` or `[cuda:0] * 4`
is the counterpart of JAX's virtual CPU devices
(`--xla_force_host_platform_device_count`), and runs the whole sharded code
path on one device, though it cannot show a multi-device speed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "Mesh", "Placement", "ShardedParam", "make_mesh",
    "batch_sharding", "replicated", "shard_params", "primary_device",
]

DATA_AXIS = "data"
MODEL_AXIS = "model"

DeviceLike = Union[str, torch.device]


class Mesh:
    """A (data, model) grid of torch devices. `devices` is a 2-D numpy
    object array; `shape` maps each axis name to its size."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS)):
        if devices.ndim != 2:
            raise ValueError(f"a mesh is a 2-D grid of devices, got shape {devices.shape}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def data_devices(self) -> List[torch.device]:
        """The device of each data shard: column 0 of each mesh row."""
        return [self.devices[r, 0] for r in range(self.devices.shape[0])]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def _device(d: DeviceLike) -> torch.device:
    """torch.device(d), with an explicit index on a bare "cuda": tensors
    report cuda:N, and torch.device("cuda") != torch.device("cuda:0")."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(
    devices: Optional[Sequence[DeviceLike]] = None,
    data: Optional[int] = None,
    model: int = 1,
) -> Mesh:
    """Build a (data, model) mesh, by default over every visible GPU on the
    data axis. `devices` may repeat a device (see the module docstring)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices= (for example "
                "[torch.device('cpu')] * 8) to build a mesh on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    if data is None:
        data = len(devices) // model
    need = data * model
    if need > len(devices):
        raise ValueError(f"mesh {data}x{model} needs {need} devices, have {len(devices)}")
    arr = np.empty(need, dtype=object)
    arr[:] = devices[:need]
    return Mesh(arr.reshape(data, model))


def primary_device(mesh: Mesh, device: Optional[DeviceLike] = None) -> torch.device:
    """The device that holds what a mesh run keeps in one place (params under
    training, the ensemble's sum): the mesh's first. `device`, when given,
    must be that device."""
    first = mesh.devices[0, 0]
    if device is not None and _device(device) != first:
        raise ValueError(f"device={device} is not the mesh's first device {first}")
    return first


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where an array goes on a mesh: `spec` is laid out like JAX's
    PartitionSpec (one entry per array axis: an axis name or None; empty
    for replicated)."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]

    def place(self, a) -> List[torch.Tensor]:
        """One tensor per data shard on that shard's device: the shard's
        slice along the DATA_AXIS dim (which must divide), or the whole
        array where no dim names DATA_AXIS. A tensor already on its device
        is not copied."""
        from dsen2_tpu_torch.core.device import upload

        devs = self.mesh.data_devices
        if DATA_AXIS in self.spec:
            axis = self.spec.index(DATA_AXIS)
            if a.shape[axis] % len(devs):
                raise ValueError(
                    f"axis {axis} of size {a.shape[axis]} must divide the data axis {len(devs)}")
            parts = (torch.chunk(a, len(devs), axis) if torch.is_tensor(a)
                     else np.split(np.asarray(a), len(devs), axis))
        else:
            parts = [a] * len(devs)
        return [p.to(d) if torch.is_tensor(p) else upload(p, d) for p, d in zip(parts, devs)]


def batch_sharding(mesh: Mesh, ndim: int, axis: int = 0) -> Placement:
    """Shard array axis `axis` over the data mesh axis, replicate the rest."""
    spec = [None] * ndim
    spec[axis] = DATA_AXIS
    return Placement(mesh, tuple(spec))


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


@dataclasses.dataclass
class ShardedParam:
    """One parameter on a mesh. shards[r][m] is the tensor on
    mesh.devices[r, m]: the whole parameter when replicated, else slice m of
    its last (output-feature) axis, so that each mesh column holds one
    slice, replicated over the data axis."""

    sharding: Placement
    shards: List[List[torch.Tensor]]

    def gather(self, row: int) -> torch.Tensor:
        """The whole parameter on data shard `row`'s device."""
        dev = self.sharding.mesh.devices[row, 0]
        parts = self.shards[row]
        if MODEL_AXIS not in self.sharding.spec:
            return parts[0]
        return torch.cat([p.to(dev) for p in parts], dim=-1)


def shard_params(params, mesh: Mesh, model_parallel: bool = False):
    """Place a {top: {name: array}} params dict on the mesh as the same dict
    of ShardedParam: replicated for data parallelism; with model_parallel
    and a model axis over 1, every kernel and bias split along its last
    (output-feature) axis over the model axis (a simple Megatron-style
    split; biases follow their kernel)."""
    from dsen2_tpu_torch.weights import params_to_torch

    split = model_parallel and mesh.shape[MODEL_AXIS] > 1
    nmodel = mesh.shape[MODEL_AXIS]
    host = params_to_torch(params, "cpu")
    out = {}
    for top, sub in host.items():
        out[top] = {}
        for name, v in sub.items():
            if split:
                spec = (None,) * (v.dim() - 1) + (MODEL_AXIS,)
                parts = torch.chunk(v, nmodel, dim=-1)
                if len(parts) != nmodel or any(p.shape != parts[0].shape for p in parts):
                    raise ValueError(
                        f"{top}.{name}: {v.shape[-1]} features do not split over {nmodel}")
            else:
                spec, parts = (), [v] * nmodel
            shards = [[parts[m].contiguous().to(mesh.devices[r, m]) for m in range(nmodel)]
                      for r in range(mesh.shape[DATA_AXIS])]
            out[top][name] = ShardedParam(Placement(mesh, spec), shards)
    return out
