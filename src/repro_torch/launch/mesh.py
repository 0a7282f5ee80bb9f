"""Device meshes for the domain decompositions.

Port of the reference's ``launch/mesh.py`` (``make_test_mesh``) on
``torch.distributed``: :func:`make_mesh` lays the ranks of the process
group the caller has already initialised over a named mesh,
``torch.distributed.device_mesh.init_device_mesh``, ranks in row-major
order (as ``jax.make_mesh`` orders devices).  Mesh axis *k* shards grid dim
*k* in :meth:`repro_torch.core.Program.compile` and
:class:`repro_torch.lb.sim.BinaryFluidSim`: one axis is a slab
decomposition, two a pencil, three a block.

It never creates a process group: on the card each rank is a process
(``torchrun``, or ``torch.distributed.init_process_group`` with its
address, world size and rank), with NCCL; on the CPU, gloo.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch.distributed as dist


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` with one name per axis, over every
    rank of the initialised default process group.

    ``device_type`` defaults to ``"cuda"``, as every entry point of the
    port does; pass ``"cpu"`` for a gloo group.  Raises ``RuntimeError``
    if no process group is initialised and ``ValueError`` if the world
    size is not the product of ``shape`` or the names do not match it.
    """
    from torch.distributed.device_mesh import init_device_mesh

    shape = tuple(int(s) for s in shape)
    axes = tuple(str(a) for a in axes)
    if len(axes) != len(shape):
        raise ValueError(f"mesh shape {shape} needs one name per axis, got "
                         f"{axes}")
    if len(set(axes)) != len(axes):
        raise ValueError(f"duplicate mesh axis names {axes}")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group: call "
            "torch.distributed.init_process_group (or run under torchrun) "
            "first")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} holds {math.prod(shape)} "
                         f"rank(s) but the process group has {world}")
    return init_device_mesh(device_type or "cuda", shape,
                            mesh_dim_names=axes)
