"""Device meshes for instance-, consensus- and time-sharded solves
(counterpart of `ilqr_admm_tpu/parallel/mesh.py`).

The JAX package runs one program over the devices of a `Mesh` in one
process (`shard_map`). Here the program runs SPMD over processes: every
rank of an initialized `torch.distributed` world calls the same function
with the same global arguments, and a mesh is a
`torch.distributed.device_mesh.DeviceMesh` whose named axes carry the
process groups of the collectives. Axes, as in the JAX package:

- 'data': problem instances, sharded over ranks
  (`batch.py::sharded_instance_solve`, `mc_success_rate`);
- 'consensus': constraint blocks of the consensus-ADMM projection
  (`consensus.py`);
- 'time': the horizon of the Riccati recursion (`time_sharded.py`).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from ilqr_admm_tpu_torch.utils.device import resolve_device


def make_mesh(axis_sizes: Sequence[int] = None, axis_names: Sequence[str] = ("data",), *,
              device=None) -> DeviceMesh:
    """A mesh over the first prod(axis_sizes) ranks of the initialized world.

    Default: a 1-D ('data',) mesh over every rank. Pass axis_sizes to
    factor the ranks, e.g. make_mesh((2, 2), ('data', 'consensus')).
    Every rank of the world makes the call. The mesh's device type is
    the ranks' device: CUDA unless `device` names another.

    Raises RuntimeError when no process group is initialized: start the
    world with `distributed.initialize(...)` or under `torchrun` first.
    """
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized process group: call "
            "ilqr_admm_tpu_torch.parallel.distributed.initialize(...) on every rank first "
            "(or launch under torchrun and call it with no arguments)")
    world = dist.get_world_size()
    axis_sizes = (world,) if axis_sizes is None else tuple(int(s) for s in axis_sizes)
    axis_names = tuple(axis_names)
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"axis_sizes {axis_sizes} and axis_names {axis_names} differ in length")
    n = math.prod(axis_sizes)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {axis_sizes} needs {n} ranks; the world has {world}")
    device_type = resolve_device(device).type
    if n == world:
        return init_device_mesh(device_type, axis_sizes, mesh_dim_names=axis_names)
    return DeviceMesh(device_type, torch.arange(n).reshape(axis_sizes), mesh_dim_names=axis_names)


def axis_group(mesh: DeviceMesh, axis: str):
    """(process group, size, this rank's index) of the mesh axis `axis`."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh (make_mesh), got "
                        f"{type(mesh).__name__}")
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no axis {axis!r}; its axes are {mesh.mesh_dim_names}")
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), mesh.get_local_rank(axis)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on the mesh (its current card for a CUDA mesh)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def instance_sharding(mesh: DeviceMesh, axis: str = "data") -> list:
    """The placements that split a tensor's leading (instance) axis over
    `axis` and replicate it over the mesh's other axes (the counterpart of
    `NamedSharding(mesh, P(axis))`), for `torch.distributed.tensor`."""
    axis_group(mesh, axis)
    return [Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names]


def replicated(mesh: DeviceMesh) -> list:
    """The placements of a tensor replicated on every rank of the mesh."""
    return [Replicate()] * mesh.ndim
