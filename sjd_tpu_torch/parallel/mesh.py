"""Device mesh construction (sjd_tpu/parallel/mesh.py).

One 2-D ``torch.distributed.device_mesh.DeviceMesh`` over every rank, with
the JAX package's named axes:

  'data'  - batch and FSDP parameter sharding;
  'model' - tensor parallelism over attention heads, the MLP's hidden width
            and the vocabulary.

A rank is one process with one device (``torchrun`` starts one per card);
``devices`` lists global ranks, in the JAX package's device order. A 1 x 1
mesh on one process needs no process group: it is built without one, and
the trainer then runs on plain tensors.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import resolve_device

AXES = ("data", "model")


def make_mesh(data: Optional[int] = None, model: int = 1, *,
              devices: Optional[Sequence[int]] = None, device=None) -> DeviceMesh:
    """A ``data x model`` mesh over ``devices`` (global ranks; default every
    rank of the process group, or rank 0 alone without one). ``device``
    names the device type (default CUDA, through ``resolve_device``)."""
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(devices) if devices is not None else list(range(world))
    n = len(ranks)
    if data is None:
        if n % model:
            raise ValueError(f"{n} ranks do not split into model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    layout = torch.tensor(ranks, dtype=torch.int64).reshape(data, model)
    if n == 1 and not dist.is_initialized():
        # no process group: a mesh of this one process
        return DeviceMesh(dev.type, layout, mesh_dim_names=AXES, _init_backend=False, _rank=0)
    return DeviceMesh(dev.type, layout, mesh_dim_names=AXES)


def host_local_mesh(model: int = 1, *, device=None) -> DeviceMesh:
    """Mesh over this host's ranks only (``LOCAL_WORLD_SIZE`` of them, as
    ``torchrun`` numbers them): the counterpart of the JAX package's mesh
    over ``jax.local_devices()``. Every rank builds the (host, data, model)
    mesh together and keeps its own host's 2-D slice, so the groups of all
    hosts are made collectively."""
    if not dist.is_initialized():
        return make_mesh(model=model, device=device)
    dev = resolve_device(device)
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % local or local % model:
        raise ValueError(f"{world} ranks, {local} per host, do not split into model={model}")
    layout = torch.arange(world).reshape(world // local, local // model, model)
    return DeviceMesh(dev.type, layout, mesh_dim_names=("host",) + AXES)[AXES]


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    """{"data": n, "model": m}: JAX's ``Mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def shard(mesh: DeviceMesh, spec: tuple) -> list:
    """The DTensor placements of a spec (a tuple of None / "data" /
    "model", one entry per tensor dimension): ``Shard(d)`` on each named
    axis, ``Replicate()`` on an axis the spec does not name."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, a in enumerate(spec) if a == axis]
        if len(dims) > 1:
            raise ValueError(f"spec {spec} names axis {axis!r} twice")
        out.append(Shard(dims[0]) if dims else Replicate())
    return out
