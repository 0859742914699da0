"""Collectives over named axes of a ``DeviceMesh``, on each rank's local
tensors: the counterparts of ``jax.lax.{all_gather, all_to_all, psum,
psum_scatter, pmean}`` inside the reference's ``shard_map``.  Each is a
functional collective (``torch.ops._c10d_functional``, the ops DTensor's own
redistributions call) on the axis's process group, counted under
``obs.tracing`` as ``mesh.collectives`` with its ``kind``.

``gloo`` and device tensors: this PyTorch's ``gloo`` runs ``all_reduce``,
``all_to_all_single`` and ``reduce_scatter_tensor`` on CUDA tensors in f32
and bf16, but the functional ``all_gather_into_tensor`` (which DTensor's
``Shard -> Replicate`` and ``full_tensor`` use) crashes the process in
``wait_tensor``.  Inside :func:`host_staging` that one op has a CUDA kernel
that copies its input to the host, gathers there, and copies the result
back, explicitly, counting the bytes (``mesh.bytes.host_staged``, as
``repair.bytes.host_staged`` counts the repair executor's).  The kernel
refuses a group of any other backend, and leaving the context removes it.
"""
from __future__ import annotations

import contextlib
from typing import Any, Iterator, Sequence

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives  # noqa: F401  (registers _c10d_functional's ops)
from torch.distributed.distributed_c10d import _resolve_process_group

from repro_torch import obs


def _staged_all_gather(inp: torch.Tensor, group_size: int, group_name) -> torch.Tensor:
    backend = dist.get_backend(_resolve_process_group(group_name))
    if backend != "gloo":
        raise RuntimeError(f"host staging is for gloo groups; group {group_name!r} is "
                           f"{backend!r}: run its all-gather outside host_staging()")
    host = torch.ops._c10d_functional.all_gather_into_tensor(inp.cpu(), group_size, group_name)
    host = torch.ops._c10d_functional.wait_tensor(host)
    obs.counter_add("mesh.bytes.host_staged",
                    inp.numel() * inp.element_size() + host.numel() * host.element_size())
    return host.to(inp.device)


@contextlib.contextmanager
def host_staging() -> Iterator[None]:
    """Within the context, the functional ``all_gather_into_tensor`` of CUDA
    tensors over a ``gloo`` group goes through the host; on a group of any
    other backend it raises.  Contexts do not nest."""
    lib = torch.library.Library("_c10d_functional", "IMPL")
    try:
        lib.impl("all_gather_into_tensor", _staged_all_gather, "CUDA")
        yield
    finally:
        lib._destroy()


_C = torch.ops._c10d_functional


def in_backward() -> bool:
    """Whether the autograd engine is running a backward node here (a
    rematerialised forward included)."""
    return torch._C._current_autograd_node() is not None


def _count(kind: str) -> None:
    obs.counter_add("mesh.collectives", 1, kind=kind,
                    phase="backward" if in_backward() else "forward")


def axis_size(mesh: Any, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _name(mesh: Any, axis: str):
    return mesh.get_group(axis).group_name


def _all_gather(t: torch.Tensor, mesh: Any, axis: str) -> torch.Tensor:
    _count("all_gather")
    return _C.wait_tensor(_C.all_gather_into_tensor(t.contiguous(), axis_size(mesh, axis),
                                                    _name(mesh, axis)))


def _reduce_scatter(t: torch.Tensor, mesh: Any, axis: str) -> torch.Tensor:
    _count("reduce_scatter")
    return _C.wait_tensor(_C.reduce_scatter_tensor(t.contiguous(), "sum", axis_size(mesh, axis),
                                                   _name(mesh, axis)))


def _all_to_all(t: torch.Tensor, mesh: Any, axis: str, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    _count("all_to_all")
    m = axis_size(mesh, axis)
    blocks = torch.stack(t.chunk(m, dim=split_dim))  # (m, ...): block j for rank j
    got = _C.wait_tensor(_C.all_to_all_single(blocks, [1] * m, [1] * m, _name(mesh, axis)))
    return torch.cat(got.unbind(0), dim=concat_dim)


def _all_reduce(t: torch.Tensor, mesh: Any, axes: Sequence[str], op: str) -> torch.Tensor:
    for axis in axes:
        _count("all_reduce")
        t = _C.wait_tensor(_C.all_reduce(t.contiguous(), op, _name(mesh, axis)))
    return t


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_gather(t, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.mesh, ctx.axis), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _reduce_scatter(t, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.mesh, ctx.axis), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, concat_dim, split_dim)  # the reverse exchange
        return _all_to_all(t, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        return _all_reduce(t, mesh, axes, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def all_gather(t: torch.Tensor, mesh: Any, axis: str) -> torch.Tensor:
    """Every rank's ``t`` along ``axis``, concatenated along dim 0 in rank
    order (``jax.lax.all_gather(..., axis=0, tiled=True)``).  Its gradient is
    the cotangent reduce-scattered over ``axis``."""
    return _AllGather.apply(t, mesh, axis)


def all_to_all(t: torch.Tensor, mesh: Any, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: ``t`` cut into as many equal
    blocks along ``split_dim`` as ``axis`` has ranks, block j sent to rank j,
    the blocks received concatenated along ``concat_dim`` in rank order.  Its
    gradient is the reverse exchange of the cotangent (``concat_dim`` and
    ``split_dim`` swapped)."""
    return _AllToAll.apply(t, mesh, axis, split_dim, concat_dim)


def all_reduce(t: torch.Tensor, mesh: Any, axes: Sequence[str]) -> torch.Tensor:
    """The sum of ``t`` over every rank of ``axes`` (``jax.lax.psum``).  The
    sum is a value every rank then holds alike, so its gradient is each
    rank's own cotangent, as the reference's transpose under ``shard_map``
    takes it."""
    return _AllReduce.apply(t, mesh, tuple(axes))


def reduce_scatter(t: torch.Tensor, mesh: Any, axis: str) -> torch.Tensor:
    """The sum of ``t`` over ``axis``, rank j keeping block j along dim 0
    (``jax.lax.psum_scatter(..., scatter_dimension=0, tiled=True)``).  Its
    gradient is the cotangent all-gathered over ``axis``."""
    return _ReduceScatter.apply(t, mesh, axis)


def mean(t: torch.Tensor, mesh: Any, axes: Sequence[str]) -> torch.Tensor:
    """The mean of ``t`` over every rank of ``axes`` (``jax.lax.pmean``): its
    gradient is each rank's cotangent divided by the number of ranks."""
    n = 1
    for axis in axes:
        n *= axis_size(mesh, axis)
    return all_reduce(t, mesh, axes) / n


def max_const(t: torch.Tensor, mesh: Any, axis: str) -> torch.Tensor:
    """The elementwise maximum of ``t`` over ``axis`` (``jax.lax.pmax``), for
    a log-sum-exp's stabiliser, whose total derivative is zero: it carries
    no gradient (the reference's ``_pmax_const``)."""
    with torch.no_grad():
        return _all_reduce(t, mesh, (axis,), "max")
