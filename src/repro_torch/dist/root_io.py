"""A DTensor's global value to one rank, and back into its layout.

A checkpoint of a sharded state is written by one rank, rank 0 (the
*root*): the counterpart of the reference's ``np.asarray`` on a sharded
``jax.Array``, which assembles the global value on the host, and of its
``device_put`` with the state's shardings on restore.  Here each leaf travels alone:

* :func:`gather_to_root` sends each distinct block of a DTensor to the root,
  which alone assembles the global tensor (a replicated block is sent once,
  by the rank at coordinate 0 of the replicating axes);
* :func:`scatter_from_root` sends each rank its block of a global tensor the
  root holds, and makes a DTensor of ``like``'s layout from it (the
  counterpart of ``distribute_tensor(..., src_data_rank=0)``, which would
  need the global shape allocated on every rank).

Blocks travel as bytes by point-to-point ``send``/``recv`` over the default
group, staged through the host on a ``gloo`` group.  Every rank of the mesh
calls each function, for the same leaves in the same order.  Layouts of
``Shard`` and ``Replicate`` placements are supported (the modes whose
layouts a checkpoint meets, ``tp2d``'s strided shards aside).
"""
from __future__ import annotations

import itertools
import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import is_dtensor

ROOT = 0


def _stage(device: torch.device) -> torch.device:
    """Where a block waits for the wire: the host for ``gloo``."""
    return torch.device("cpu") if dist.get_backend() == "gloo" else device


def layout(shape: tuple[int, ...], mesh: Any, placements) -> list[tuple]:
    """For every rank of ``mesh``: (rank, local shape, global offset, owner),
    a ``Shard`` splitting its dimension as ``torch.chunk`` does, mesh dims in
    order (major first).  ``owner`` is True for the one rank of each block
    that sends it: coordinate 0 on every axis that replicates it."""
    from torch.distributed.tensor import Shard

    grid = mesh.mesh
    out = []
    for coord in itertools.product(*(range(n) for n in grid.shape)):
        size, off, owner = list(shape), [0] * len(shape), True
        for axis, pl in enumerate(placements):
            if pl.is_replicate():
                owner = owner and coord[axis] == 0
                continue
            if type(pl) is not Shard:
                raise NotImplementedError(f"no block layout for placement {pl}")
            d, n = pl.dim, grid.shape[axis]
            chunk = -(-size[d] // n)
            start = min(coord[axis] * chunk, size[d])
            off[d] += start
            size[d] = max(0, min(size[d], start + chunk) - start)
        out.append((int(grid[coord]), tuple(size), tuple(off), owner))
    return out


def _block(t: torch.Tensor, size: tuple, off: tuple) -> torch.Tensor:
    return t[tuple(slice(o, o + s) for o, s in zip(off, size))]


def _send(t: torch.Tensor, dst: int, stage: torch.device) -> None:
    dist.send(t.detach().contiguous().reshape(-1).view(torch.uint8).to(stage), dst=dst)


def _recv(size: tuple, dtype: torch.dtype, src: int, stage: torch.device) -> torch.Tensor:
    nbytes = math.prod(size) * torch.empty((), dtype=dtype).element_size()
    buf = torch.empty(nbytes, dtype=torch.uint8, device=stage)
    dist.recv(buf, src=src)
    return buf.view(dtype).reshape(size)


def gather_to_root(t: torch.Tensor) -> torch.Tensor | None:
    """The global value of ``t`` on the root (on the staging device: the
    host for ``gloo``), ``None`` on every other rank.  A plain tensor is
    taken as the same on every rank: the root's own is returned."""
    me = dist.get_rank()
    if not is_dtensor(t):
        return t.detach() if me == ROOT else None
    stage = _stage(t.device)
    local = t.to_local()
    blocks = layout(tuple(t.shape), t.device_mesh, t.placements)
    if me != ROOT:
        for rank, size, _, owner in blocks:
            if rank == me and owner and 0 not in size:
                _send(local, ROOT, stage)
        return None
    full = torch.empty(tuple(t.shape), dtype=t.dtype, device=stage)
    for rank, size, off, owner in blocks:
        if not owner or 0 in size:
            continue
        got = local.detach().to(stage) if rank == me else _recv(size, t.dtype, rank, stage)
        _block(full, size, off).copy_(got)
    return full


def scatter_from_root(full: torch.Tensor | None, like: torch.Tensor) -> torch.Tensor:
    """``full`` (the global value, on the root; ignored elsewhere) laid
    out as ``like``: a DTensor with ``like``'s mesh, placements, shape and
    stride whose local block each rank received from the root, on
    ``like``'s device.  A plain ``like`` gets the root's whole value."""
    me = dist.get_rank()
    if not is_dtensor(like):
        stage = _stage(like.device)
        if me == ROOT:
            for rank in range(dist.get_world_size()):
                if rank != ROOT:
                    _send(full, rank, stage)
            return full.detach().to(like.device).clone()
        return _recv(tuple(like.shape), like.dtype, ROOT, stage).to(like.device)
    from torch.distributed.tensor import DTensor

    stage = _stage(like.device)
    blocks = layout(tuple(like.shape), like.device_mesh, like.placements)
    mine = None
    for rank, size, off, _ in blocks:
        if me == ROOT:
            block = _block(full, size, off)
            if rank == me:
                mine = block.detach().to(like.device).clone()
            elif 0 not in size:
                _send(block, rank, stage)
        elif rank == me:
            mine = (torch.empty(size, dtype=like.dtype, device=like.device) if 0 in size
                    else _recv(size, like.dtype, ROOT, stage).to(like.device))
    return DTensor.from_local(mine, like.device_mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())
