"""Logical-axis sharding rules, resolved to specs and DTensor placements.

The PyTorch counterpart of ``repro.dist.sharding``.  Model code names array
dimensions with *logical* axes (``repro_torch.models.common.LOGICAL``:
batch/seq/embed/ffn/heads/kv/vocab/expert) and never mentions mesh axes.  A
rule table, one per parallelism mode, maps each logical name to an ordered
tuple of mesh axes it *may* shard over; :func:`resolve_spec` turns (logical
names, concrete shape, mesh) into a spec, a tuple with one entry per
dimension (``None``, a mesh axis name, or a tuple of names, major first),
equal entry for entry to the reference's ``PartitionSpec``, with its two
guarantees:

* **divisibility fallback**: a dimension that does not divide evenly by a
  candidate mesh axis is replicated instead (DTensor would shard it
  unevenly; the reference never does);
* **no double use**: a mesh axis consumed by an earlier dimension of the
  same spec is skipped for later ones (first come, first served).

Modes: ``tp`` (tensor parallel), ``tp_sp`` (+ sequence parallel), ``fsdp``
(embed sharded over data), ``fsdp_sp``, ``tp2d`` (ffn/vocab over
model x data).  ``multi_pod=True`` prepends the ``pod`` axis to the batch
rule.

:func:`placements` turns a spec into DTensor placements over a
``DeviceMesh``, and :func:`local_slices` gives the block of a full tensor
that one device of the mesh holds (the reference's
``NamedSharding.devices_indices_map``).  ``use_mesh(mesh)`` sets the ambient
mesh (the reference's ``jax.set_mesh``), ``axis_rules(rules)`` the ambient
rule table; ``logical_constraint`` then redistributes a DTensor to the spec
its logical axes resolve to (the reference's ``with_sharding_constraint``).
"""
from __future__ import annotations

import contextlib
import sys
import warnings
from typing import Any, Iterator, Mapping, Sequence

import torch

Names = Sequence[str | None]
Entry = str | tuple[str, ...] | None

# Mode -> logical axis -> ordered mesh-axis candidates.  Axes listed
# earlier win; a multi-axis entry (tp2d ffn/vocab) shards one dimension
# over the product of every candidate that fits.
_BASE_TABLES: dict[str, dict[str, tuple[str, ...]]] = {
    "tp": {
        "batch": ("data",),
        "seq": (),
        "embed": (),
        "ffn": ("model",),
        "heads": ("model",),
        "kv": ("model",),
        "vocab": ("model",),
        "expert": ("model",),
    },
}
_BASE_TABLES["tp_sp"] = {**_BASE_TABLES["tp"], "seq": ("model",)}
_BASE_TABLES["fsdp"] = {**_BASE_TABLES["tp"], "embed": ("data",)}
_BASE_TABLES["fsdp_sp"] = {**_BASE_TABLES["fsdp"], "seq": ("model",)}
_BASE_TABLES["tp2d"] = {
    **_BASE_TABLES["tp"],
    "ffn": ("model", "data"),
    "vocab": ("model", "data"),
}

MODES = tuple(sorted(_BASE_TABLES))


class Rules:
    """Immutable logical-axis -> mesh-axes rule table."""

    def __init__(self, mode: str, multi_pod: bool,
                 table: Mapping[str, tuple[str, ...]]) -> None:
        self.mode = mode
        self.multi_pod = multi_pod
        self._table = dict(table)

    def mesh_axes(self, name: str) -> tuple[str, ...]:
        """Mesh-axis candidates for one logical axis (empty = replicate)."""
        return self._table.get(name, ())

    def __repr__(self) -> str:
        pod = ", multi_pod" if self.multi_pod else ""
        return f"Rules({self.mode!r}{pod})"


def make_rules(mode: str = "tp", *, multi_pod: bool = False) -> Rules:
    """Build the rule table for one parallelism mode."""
    try:
        table = dict(_BASE_TABLES[mode])
    except KeyError:
        raise ValueError(
            f"unknown sharding rules mode {mode!r}; available: {MODES}"
        ) from None
    if multi_pod:
        table["batch"] = ("pod", *table["batch"])
    return Rules(mode, multi_pod, table)


# ------------------------------------------------------------- resolution
def mesh_sizes(mesh: Any) -> dict[str, int]:
    """Axis name -> size: a ``DeviceMesh``'s ``mesh_dim_names`` and ``shape``,
    or any object whose ``.shape`` is such a mapping (a test double)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def resolve_spec(
    names: Names,
    shape: Sequence[int],
    mesh: Any,
    rules: Rules | None = None,
) -> tuple[Entry, ...]:
    """Map logical axis names + a concrete shape to a spec.

    Every dimension is sharded over the longest prefix-product of its
    candidate axes that (a) exist in the mesh, (b) are unused so far in
    this spec, and (c) keep the dimension evenly divisible; otherwise it
    falls back to replication.
    """
    if len(names) != len(shape):
        raise ValueError(
            f"logical names {tuple(names)} do not match shape {tuple(shape)}"
        )
    rules = current_rules() if rules is None else rules
    sizes = mesh_sizes(mesh)
    used: set[str] = set()
    entries: list[Entry] = []
    for name, dim in zip(names, shape):
        if name is None:
            entries.append(None)
            continue
        chosen: list[str] = []
        divisor = 1
        for axis in rules.mesh_axes(name):
            size = sizes.get(axis)
            if size is None or size <= 1 or axis in used:
                continue
            if dim % (divisor * size) != 0:
                continue
            chosen.append(axis)
            divisor *= size
        used.update(chosen)
        if not chosen:
            entries.append(None)
        elif len(chosen) == 1:
            entries.append(chosen[0])
        else:
            entries.append(tuple(chosen))
    return tuple(entries)


def resolve_specs(spec_tree: Any, shape_tree: Any, mesh: Any,
                  rules: Rules | None = None) -> Any:
    """Resolve a tree (dicts and lists) of logical-axis tuples against a
    congruent tree of tensors or shapes."""
    rules = current_rules() if rules is None else rules
    if isinstance(spec_tree, dict):
        return {key: resolve_specs(sub, shape_tree[key], mesh, rules)
                for key, sub in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [resolve_specs(sub, shp, mesh, rules) for sub, shp in zip(spec_tree, shape_tree)]
    shape = getattr(shape_tree, "shape", shape_tree)
    return resolve_spec(spec_tree, tuple(shape), mesh, rules)


def axes_of(entry: Entry) -> tuple[str, ...]:
    """The mesh axes one spec entry names, major first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def local_slices(spec: Sequence[Entry], shape: Sequence[int], sizes: Mapping[str, int],
                 coord: Mapping[str, int]) -> tuple[slice, ...]:
    """The block of a ``shape`` tensor that the device at mesh coordinate
    ``coord`` (axis name -> index) holds under ``spec``: a dimension whose
    entry names axes (a1, ..., ak) is cut into the product of their sizes
    equal blocks, indexed with a1 the major digit, as the reference's
    ``NamedSharding`` lays it out."""
    out = []
    for entry, dim in zip(spec, shape):
        parts, index = 1, 0
        for axis in axes_of(entry):
            parts *= sizes[axis]
            index = index * sizes[axis] + coord[axis]
        if dim % parts:
            raise ValueError(f"dimension {dim} does not split into {parts} equal blocks")
        step = dim // parts
        out.append(slice(index * step, (index + 1) * step))
    return tuple(out)


def placements(spec: Sequence[Entry], mesh: Any) -> tuple:
    """DTensor placements over ``mesh`` (one per mesh dimension) that lay a
    tensor out as ``spec`` does.

    A mesh axis that no entry names replicates.  A dimension sharded over
    several axes is cut by DTensor in mesh-dimension order (the outer
    dimension major); where the spec names them the other way round (tp2d's
    ``("model", "data")`` on a ``("data", "model")`` mesh: model major), the
    outer axis takes a ``_StridedShard``, the layout FSDP over TP gives."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    names = tuple(mesh.mesh_dim_names)
    sizes = mesh_sizes(mesh)
    out: list[Any] = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = axes_of(entry)
        for axis in axes:
            out[names.index(axis)] = Shard(dim)
        order = sorted(axes, key=names.index)
        if len(axes) > 1 and list(axes) != order:
            if len(axes) != 2:
                raise NotImplementedError(f"spec entry {entry} over mesh {names}")
            outer, inner = order
            out[names.index(outer)] = _StridedShard(dim, split_factor=sizes[inner])
    return tuple(out)


def redistribute(x, pl: Sequence[Any]):
    """``x.redistribute(x.device_mesh, pl)``, where a ``_StridedShard`` in
    ``pl`` (tp2d's layout of a dimension split model-major over data and
    model) is reached without asking DTensor to move into it, which torch
    2.11's DTensor cannot: x goes to ``pl`` with that mesh dimension
    replicated, then each rank keeps its own block along it by a local slice
    (``DTensor.from_local``: nothing more is communicated), the block
    ``local_slices`` gives it."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.placement_types import _StridedShard

    mesh = x.device_mesh
    strided = [i for i, p in enumerate(pl) if isinstance(p, _StridedShard)]
    if not strided:
        return x.redistribute(mesh, tuple(pl))
    movable = [Replicate() if i in strided else p for i, p in enumerate(pl)]
    local = x.redistribute(mesh, movable).to_local()
    for i in strided:  # the outer axis: a minor block within the inner axis's
        local = local.chunk(mesh.size(i), dim=pl[i].dim)[mesh.get_local_rank(i)]
    return DTensor.from_local(local.contiguous(), mesh, tuple(pl), run_check=False,
                              shape=x.shape, stride=x.stride())


class _Unstrided(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import DTensor, Replicate
        from torch.distributed.tensor.placement_types import _StridedShard

        ctx.placements = x.placements
        mesh, local = x.device_mesh, x.to_local()
        movable = list(x.placements)
        for i, p in enumerate(x.placements):
            if isinstance(p, _StridedShard):  # the rank's blocks along mesh dim i, in order
                ops = torch.ops._c10d_functional
                t = ops.all_gather_into_tensor(local.movedim(p.dim, 0).contiguous(),
                                               mesh.size(i), mesh.get_group(i).group_name)
                local = ops.wait_tensor(t).movedim(0, p.dim)
                movable[i] = Replicate()
        return DTensor.from_local(local.contiguous(), mesh, movable, run_check=False,
                                  shape=x.shape, stride=x.stride())

    @staticmethod
    def backward(ctx, g):
        return redistribute(g, ctx.placements)


def unstrided(x):
    """x, where it is a DTensor laid out with a ``_StridedShard`` (tp2d's
    ``ffn``/``vocab`` parameters), gathered whole along that mesh dimension
    by hand, the rest of its layout kept; its gradient goes back into x's
    own layout through :func:`redistribute`.  torch 2.11's DTensor can take
    such a tensor into an op, but cannot move the op's gradient back into
    the ``_StridedShard`` (the backward of its own redistribution), so
    every reader of a parameter that may be laid out so takes it through
    here."""
    from torch.distributed.tensor.placement_types import _StridedShard

    if not is_dtensor(x) or not any(isinstance(p, _StridedShard) for p in x.placements):
        return x
    return _Unstrided.apply(x)


def grad_placements(pl: Sequence[Any], mesh: Any, varying: Sequence[str]) -> tuple:
    """The placements of the gradient of a ``local_map`` input laid out as
    ``pl``: a mesh dimension that shards it keeps its shard, one that
    replicates it holds partial sums (``Partial``) where the axis is in
    ``varying`` (the ranks along it computed with different tokens or weight
    shards, so their cotangents add up to the gradient), and stays replicated
    elsewhere (every rank along it computed alike and holds the whole
    gradient).  This is the sum over the axis that JAX's transpose of the
    implicit ``pvary`` of a replicated ``shard_map`` input takes."""
    from torch.distributed.tensor import Partial

    names = tuple(mesh.mesh_dim_names)
    return tuple(Partial() if p.is_replicate() and names[i] in varying else p
                 for i, p in enumerate(pl))


def shard_tensor(full: torch.Tensor, mesh: Any, spec: Sequence[Entry]):
    """A DTensor over ``mesh`` laid out as ``spec`` from a tensor every rank
    holds whole: each rank keeps its own block (a copy, so the full tensor
    can be freed) and nothing is communicated."""
    from torch.distributed.tensor import DTensor

    sizes = mesh_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    local = full[local_slices(spec, full.shape, sizes, coord)].contiguous().clone()
    return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False,
                              shape=full.shape, stride=full.stride())


# ----------------------------------------------------------- rule context
_RULES_STACK: list[Rules] = []
_DEFAULT_RULES = make_rules("tp")
_MESH_STACK: list[Any] = []


@contextlib.contextmanager
def axis_rules(rules: Rules) -> Iterator[Rules]:
    """Install ``rules`` as the ambient table for the ``with`` scope."""
    _RULES_STACK.append(rules)
    try:
        yield rules
    finally:
        _RULES_STACK.pop()


def current_rules() -> Rules:
    """The innermost ``axis_rules`` table, or the ``tp`` default."""
    return _RULES_STACK[-1] if _RULES_STACK else _DEFAULT_RULES


@contextlib.contextmanager
def use_mesh(mesh: Any) -> Iterator[Any]:
    """Install ``mesh`` (a ``DeviceMesh``) as the ambient mesh for the
    ``with`` scope."""
    _MESH_STACK.append(mesh)
    try:
        yield mesh
    finally:
        _MESH_STACK.pop()


def ambient_mesh() -> Any:
    """The innermost ``use_mesh`` mesh, or None when there isn't one."""
    return _MESH_STACK[-1] if _MESH_STACK else None


def is_dtensor(x: Any) -> bool:
    """Whether x is a DTensor (without importing DTensor where no one has)."""
    module = sys.modules.get("torch.distributed.tensor")
    return module is not None and isinstance(x, module.DTensor)


def gather_inner(x):
    """A DTensor x with every mesh dimension that shards one of its inner
    dimensions (neither the first nor the last) made whole: the input of a
    product ``x @ w``.  torch 2.11's DTensor has no rule for such a product
    (its matmul flattens the leading dimensions, which a sharded inner one
    forbids); 2.13's gathers the input the same way."""
    from torch.distributed.tensor import Replicate

    whole = [Replicate() if p.is_shard() and 0 < p.dim < x.dim() - 1 else p
             for p in x.placements]
    return x if whole == list(x.placements) else x.redistribute(x.device_mesh, whole)


class _GradAsLaidOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate

        ctx.mesh = x.device_mesh
        ctx.placements = [Replicate() if p.is_partial() else p for p in x.placements]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.placements)


def grad_as_laid_out(x):
    """x itself, whose gradient is redistributed to x's own layout (whole
    where x holds partial sums) before it flows back into the op that made
    x.  DTensor hands an op's backward the gradient laid out as the later
    ops left it; torch 2.11 cannot then flatten a (batch, seq, ...)
    gradient whose seq is sharded (the backward of a product's reshape),
    nor turn a partial gradient into a vocab-parallel lookup's masked
    partial."""
    return _GradAsLaidOut.apply(x)


# ------------------------------------------------------------ constraints
_WARNED_NO_MESH = [False]


def _warn_rules_without_mesh() -> None:
    if _WARNED_NO_MESH[0]:
        return
    _WARNED_NO_MESH[0] = True
    warnings.warn(
        "axis_rules(...) is active but no ambient mesh is set "
        "(use_mesh): logical_constraint degrades to a no-op, so "
        "activations will not be sharded as the rules request",
        RuntimeWarning,
        stacklevel=4,
    )


def logical_constraint(x: torch.Tensor, names: Names) -> torch.Tensor:
    """Redistribute ``x`` to the spec its logical axes resolve to.

    Only a DTensor under an ambient mesh moves (``redistribute``: a partial
    sum is reduced, a shard gathered or cut); a spec that shards nothing
    leaves ``x`` as it is, as the reference's constraint does.  Without a
    mesh ``x`` is returned as it is, with a one-time warning if rules were
    set explicitly; a plain tensor under a mesh is returned as it is (the
    reference's eager arrays)."""
    mesh = ambient_mesh()
    if mesh is None:
        if _RULES_STACK:
            _warn_rules_without_mesh()
        return x
    if not is_dtensor(x):
        return x
    spec = resolve_spec(names, x.shape, mesh)
    if all(entry is None for entry in spec):
        return x
    return x.redistribute(mesh, placements(spec, mesh))
