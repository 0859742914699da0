"""The layered-repair mesh, as a ``torch.distributed`` ``DeviceMesh``.

The counterpart of ``repro.launch.mesh.make_repair_mesh``: r pods (racks)
by w nodes per pod, with dims ``("pod", "node")``.  Global rank ``p*w + j``
is device ``(p, j)`` and holds node ``p*w + j``, as ``Placement.rack_of``
has it.  Built by a function, never at import, so importing this module
touches no process group.
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
