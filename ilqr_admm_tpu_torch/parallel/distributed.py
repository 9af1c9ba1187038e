"""The multi-process runtime (counterpart of
`ilqr_admm_tpu/parallel/distributed.py`).

Every rank runs the same program. `initialize` wires the ranks into one
`torch.distributed` world, a mesh over them (`mesh.py::make_mesh`)
names its axes, and the instance batch shards over the 'data' axis.

Usage (the same script on every rank):

    from ilqr_admm_tpu_torch.parallel import distributed, make_mesh
    distributed.initialize()          # under torchrun; False for one process
    mesh = make_mesh()                # every rank of the world
    x0s_local = distributed.host_shard(x0s_global)
    x0s = distributed.make_global_batch(x0s_local, mesh)

Started by `torchrun --nproc_per_node=P script.py`, `initialize()` reads
the world from torchrun's environment; without it, pass the coordinator
"host:port", the number of processes and each one's index. The backend
is NCCL for ranks on CUDA cards (one card a rank) and gloo on the CPU;
ranks that share a card must use gloo (`backend="gloo"`): NCCL refuses
two ranks on one device.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ilqr_admm_tpu_torch.parallel.collectives import all_gather_uneven
from ilqr_admm_tpu_torch.parallel.mesh import axis_group, mesh_device
from ilqr_admm_tpu_torch.utils.device import resolve_device


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device=None,
               backend: Optional[str] = None) -> bool:
    """Join this process to a multi-process world; no-op for one process.

    coordinator_address: "host:port" of rank 0's rendezvous; by default
    torchrun's MASTER_ADDR and MASTER_PORT. num_processes and process_id
    default to torchrun's WORLD_SIZE and RANK. device: the ranks'
    device, CUDA unless it names another (a CUDA rank takes card
    LOCAL_RANK, else process_id, modulo the cards present). backend:
    NCCL for CUDA and gloo for the CPU unless given.

    Returns True when a world of more than one process was initialized;
    False for a single process, and when this process already belongs
    to a world. A failed handshake raises: a multi-process run never
    goes on as single processes, each of which would compute its own
    "global" result.
    """
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if coordinator_address is None and (num_processes or 1) <= 1:
        return False
    if dist.is_initialized():
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process world needs coordinator_address, num_processes and process_id "
            f"(got {coordinator_address!r}, {num_processes!r}, {process_id!r})")
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
        rank=int(process_id))
    return dist.get_world_size() > 1


def _rank_and_size() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_shard(global_array):
    """This rank's contiguous shard of an instance batch every rank holds.

    The remainder (batch % world size) goes one instance a rank to the
    first ranks, so every instance is assigned exactly once; shards may
    differ in length by 1 (`make_global_batch` assembles them). Without
    a world the whole batch is this process's shard.
    """
    i, n = _rank_and_size()
    per, rem = divmod(global_array.shape[0], n)
    start = i * per + min(i, rem)
    stop = start + per + (1 if i < rem else 0)
    return global_array[start:stop]


def make_global_batch(local_batch, mesh, axis: str = "data") -> torch.Tensor:
    """The global batch from every rank's local shard along the mesh's
    `axis`, in rank order: the whole (global_batch, ...) tensor on every
    rank, on the ranks' device. Shards may differ in length (the ragged
    split of `host_shard`)."""
    group, _, _ = axis_group(mesh, axis)
    return all_gather_uneven(torch.as_tensor(local_batch, device=mesh_device(mesh)), group)
