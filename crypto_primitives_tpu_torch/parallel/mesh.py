"""Device meshes over ``torch.distributed``, and the collectives of the
sharded paths.

Twin of ``crypto_primitives_tpu/parallel/mesh.py``.  A JAX mesh is
single-controller: one Python process holds every device and the global
arrays.  The port is multi-controller (SPMD): one process per device, each
running the same program on its own shard, joined by a process group that
the caller makes (``torch.distributed.init_process_group``: NCCL for CUDA
tensors, gloo for CPU ones).  :func:`make_mesh` starts no group itself.

The sharded paths gather with the list form of ``all_gather`` and assemble
per-row results with one ``all_reduce``.  ``tests/test_torch_parallel.py``
runs them over gloo at 1, 2 and 4 ranks, and ``tests/test_torch_cuda.py``
over NCCL at world size 1 on a card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(n_devices: int | None = None, axis_name: str = "data", device_type: str | None = None) -> DeviceMesh:
    """1-D mesh named ``axis_name`` over every rank of the initialised
    default process group; ``device_type`` ``None`` means ``"cuda"``.
    Raises ``ValueError`` when no group is initialised or ``n_devices``
    is not its world size."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError("make_mesh needs a process group: call torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"asked for a mesh of {n_devices} devices, the process group has {world} ranks")
    return init_device_mesh("cuda" if device_type is None else device_type, (world,), mesh_dim_names=(axis_name,))


def shard_of(mesh: DeviceMesh, axis_name: str = "data") -> tuple:
    """(rank along ``axis_name``, its size, its process group): the twin of
    ``jax.lax.axis_index`` and the mesh's axis size."""
    group = mesh.get_group(axis_name)
    return mesh.get_local_rank(axis_name), dist.get_world_size(group), group


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis_name: str = "data") -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order: ``(D,) + x.shape``, on
    ``x``'s device."""
    _, size, group = shard_of(mesh, axis_name)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.stack(parts)


def all_reduce_sum(x: torch.Tensor, mesh: DeviceMesh, axis_name: str = "data") -> torch.Tensor:
    """``x`` summed over the ranks, in place (``x`` must be contiguous).
    The sharded paths use it to assemble rows that one rank fills and the
    others leave zero, which a sum of integers returns exactly."""
    _, _, group = shard_of(mesh, axis_name)
    if not x.is_contiguous():
        raise ValueError("all_reduce_sum needs a contiguous tensor")
    dist.all_reduce(x, group=group)
    return x
