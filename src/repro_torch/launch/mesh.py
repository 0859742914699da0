"""The meshes of the port, as ``torch.distributed`` ``DeviceMesh``es.

* ``make_repair_mesh``, the counterpart of ``repro.launch.mesh.make_repair_mesh``:
  r pods (racks) by w nodes per pod, with dims ``("pod", "node")``.  Global
  rank ``p*w + j`` is device ``(p, j)`` and holds node ``p*w + j``, as
  ``Placement.rack_of`` has it.
* ``make_model_mesh``: the model's ``(data, model)`` mesh (or any named
  axes) over the whole world, for the sharded forward.
* ``make_production_mesh``, the counterpart of
  ``repro.launch.mesh.make_production_mesh``: the reference's production
  shapes, ``(16, 16)`` ``("data", "model")`` or, with ``multi_pod``, ``(2,
  16, 16)`` ``("pod", "data", "model")`` (the pod axis is the paper's rack),
  over a process group of that size (the dry run's ``fake`` one).
* ``fake_world``: a ``fake`` default process group of n ranks for as long
  as a ``with`` block runs, for the dry run and the traced captures, which
  lay meshes of hundreds of ranks out in one process.  It refuses to start
  beside any default group and on exit destroys only what it made.

The roofline constants below are an H100 SXM 80 GB's data sheet values, not
measurements: the dry run's compute, memory and collective terms divide its
counts by them.

Built by functions, never at import, so importing this module touches no
process group.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


@contextlib.contextmanager
def fake_world(n: int, rank: int) -> Iterator[None]:
    """A ``fake`` default process group of ``n`` ranks with this process as
    ``rank`` (collectives return at once and move nothing).  Refuses to start
    while any default group exists, and on exit destroys only what it made
    (the group and the subgroups made under it, a mesh's among them: a mesh
    made inside the block is not used after it)."""
    if dist.is_initialized():
        raise RuntimeError(
            f"a fake process group of {n} ranks needs its own default group, but a "
            f"{dist.get_backend()!r} group of {dist.get_world_size()} ranks exists: "
            f"make it before that group or after it is destroyed")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


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


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """The production mesh: 256 devices as ``(16, 16)`` ``("data",
    "model")``, or 512 as ``(2, 16, 16)`` ``("pod", "data", "model")``, over
    the default process group, which must have that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_model_mesh(shape, axes, device_type=device_type)


# H100 SXM 80 GB, data sheet values (not measured), for the roofline terms:
PEAK_FLOPS_BF16 = 989e12  # dense bf16 tensor-core FLOP/s per GPU
HBM_BW = 3.35e12  # HBM3 bytes/s per GPU
HBM_BYTES = 80e9  # device memory per GPU: the budget a cell must fit
# The collective rate: one 400 Gb/s NDR InfiniBand port per GPU (50e9 B/s),
# since a 16-wide axis spans two 8-GPU NVLink nodes and so crosses the
# network; NVLink (900 GB/s) serves only groups within a node.
COLLECTIVE_BW = 50e9
