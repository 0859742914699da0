"""The meshes of the port, as ``torch.distributed`` ``DeviceMesh``es.

* ``make_repair_mesh``, the counterpart of ``repro.launch.mesh.make_repair_mesh``:
  r pods (racks) by w nodes per pod, with dims ``("pod", "node")``.  Global
  rank ``p*w + j`` is device ``(p, j)`` and holds node ``p*w + j``, as
  ``Placement.rack_of`` has it.
* ``make_model_mesh``: the model's ``(data, model)`` mesh (or any named
  axes) over the whole world, for the sharded forward.

Built by functions, never at import, so importing this module touches no
process group.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_repair_mesh(r: int, w: int, *, device_type: str = "cuda") -> DeviceMesh:
    """Mesh for the layered-repair SPMD program: r pods x w nodes over the
    whole default process group, which must have r*w ranks.  Every rank
    calls this (its subgroups are made by collective calls).

    ``device_type`` is where the mesh's collectives run: ``"cuda"`` for
    NCCL, ``"cpu"`` for ``gloo`` (payloads on a card are then staged
    through the host by the executor).
    """
    if not dist.is_initialized():
        raise RuntimeError("make_repair_mesh needs an initialised process group")
    world = dist.get_world_size()
    if world != r * w:
        raise ValueError(f"a ({r}, {w}) repair mesh needs {r * w} ranks, the world has {world}")
    return init_device_mesh(device_type, (r, w), mesh_dim_names=("pod", "node"))


def make_model_mesh(shape: tuple[int, ...], axes: tuple[str, ...] = ("data", "model"), *,
                    device_type: str = "cuda") -> DeviceMesh:
    """Mesh of the given sizes and axis names over the whole default process
    group, whose size must be their product; rank i is the mesh's i-th
    device in row-major order, as ``jax.make_mesh`` lays its devices out.
    Every rank calls this.  A mesh of card tensors over ``gloo`` runs its
    forward inside ``mesh_collectives.host_staging()``, which stages the one
    functional collective that ``gloo`` cannot run on device tensors."""
    if not dist.is_initialized():
        raise RuntimeError("make_model_mesh needs an initialised process group")
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    world, size = dist.get_world_size(), 1
    for n in shape:
        size *= n
    if world != size:
        raise ValueError(f"a {shape} mesh needs {size} ranks, the world has {world}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))
