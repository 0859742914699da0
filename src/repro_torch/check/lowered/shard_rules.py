"""Static consistency of the sharding-rule tables (dist.sharding).

``resolve_spec`` promises two things at runtime — divisibility fallback
and no double mesh-axis use.  These rules prove the *tables* (and the
resolver as deployed) keep those promises for every model config before
anything is compiled:

* ``lowered.shard.axis-reuse`` — no rule entry lists the same mesh axis
  twice for one logical dimension, and every listed axis is a known
  mesh axis (``data``/``model``/``pod``).  A duplicated candidate would
  make the resolver's first-come-first-served scan order-dependent.
* ``lowered.shard.divisibility`` — resolving every representative
  weight/activation shape of a config against concrete meshes never
  raises, never shards a dimension unevenly, never invents an axis the
  table does not allow, never uses one mesh axis for two dimensions of
  a spec, and the replication fallback is reachable (a prime-sized
  dimension must resolve to replicated, not an uneven DTensor shard).
* ``lowered.shard.multi-pod`` — the ``pod`` mesh axis appears only as
  the *leading* batch candidate of a ``multi_pod`` table (data
  parallelism across pods, the paper's rack analogue); a weight axis
  sharded over ``pod`` would silently turn the repair mesh's pod
  dimension into tensor parallelism.  The table must also compose with
  the (pod, node) repair mesh: resolution succeeds and no non-batch
  dimension touches ``pod``.

The port's copy of ``repro.check.lowered.shard_rules``, over
``repro_torch.dist.sharding`` (whose ``resolve_spec`` returns a tuple
equal entry for entry to the reference's ``PartitionSpec``) and
``repro_torch.models.common.LOGICAL``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

from repro_torch.models.common import LOGICAL

from ..report import FAIL, Finding, LoweredRecord
from .base import SHARD_FAMILY, rule

R_SH_REUSE = "lowered.shard.axis-reuse"
R_SH_DIV = "lowered.shard.divisibility"
R_SH_POD = "lowered.shard.multi-pod"

KNOWN_MESH_AXES = ("data", "model", "pod")

# A dimension size no mesh axis divides: the replication fallback must
# absorb it.  7919 is prime and larger than any realistic axis size.
_PRIME_DIM = 7919

# canonical meshes the sweep resolves against (axis name -> size)
CANONICAL_MESHES: tuple[dict[str, int], ...] = (
    {"data": 2, "model": 4},
    {"data": 4, "model": 2},
)
MULTI_POD_MESHES: tuple[dict[str, int], ...] = (
    {"pod": 3, "data": 2, "model": 2},
    {"pod": 3, "node": 2},  # the repair mesh of repro_torch.dist.collectives
)


class TableMesh:
    """Minimal mesh stand-in: resolve_spec only reads ``.shape``."""

    def __init__(self, shape: Mapping[str, int]) -> None:
        self.shape = dict(shape)

    def __repr__(self) -> str:
        return f"TableMesh({self.shape})"


@dataclasses.dataclass(frozen=True)
class ShardArtifact:
    """One (rule table, model config) pair plus the resolver to vet.

    ``resolver`` is part of the artifact on purpose: the guarantee under
    test lives in ``resolve_spec`` as deployed, so a resolver swap (see
    the ``shard_greedy_resolver`` mutation) is a lowering defect too.
    """

    rules: Any  # repro_torch.dist.sharding.Rules
    config: Any  # repro_torch.models.config.ArchConfig
    meshes: tuple[Mapping[str, int], ...]
    resolver: Callable[..., Any]

    def label(self) -> str:
        return f"{self.rules!r} x {self.config.name}"


def _representative_shapes(
    config: Any, *, batch: int = 8, seq: int = 128
) -> list[tuple[tuple[str, ...], tuple[int, ...]]]:
    """Logical-axis tuples + concrete shapes covering every weight and
    activation family the models actually resolve."""
    return [
        (("batch", "seq", "embed"), (batch, seq, config.d_model)),
        (("embed", "ffn"), (config.d_model, config.d_ff)),
        (("embed", "heads"), (config.d_model, max(config.n_heads, 1))),
        (("embed", "kv"), (config.d_model, max(config.n_kv_heads, 1))),
        (("embed", "vocab"), (config.d_model, config.padded_vocab)),
    ]


@rule(R_SH_REUSE, SHARD_FAMILY)
def check_axis_reuse(art: ShardArtifact) -> list[Finding]:
    """Rule-table hygiene: unique, known mesh axes per logical axis."""
    out: list[Finding] = []
    for name in LOGICAL:
        candidates = art.rules.mesh_axes(name)
        seen: set[str] = set()
        for axis in candidates:
            if axis in seen:
                out.append(Finding(
                    R_SH_REUSE, FAIL,
                    f"{art.rules!r}: logical axis {name!r} lists mesh axis "
                    f"{axis!r} twice ({candidates}) — the resolver's "
                    f"first-come-first-served scan becomes order-dependent",
                    {"logical": name, "axis": axis,
                     "candidates": list(candidates)},
                ))
            seen.add(axis)
            if axis not in KNOWN_MESH_AXES:
                out.append(Finding(
                    R_SH_REUSE, FAIL,
                    f"{art.rules!r}: logical axis {name!r} maps to unknown "
                    f"mesh axis {axis!r} (known: {KNOWN_MESH_AXES})",
                    {"logical": name, "axis": axis},
                ))
    return out


def _spec_entries(spec: Any) -> list[tuple[str, ...]]:
    """PartitionSpec entries normalized to tuples of mesh-axis names."""
    out: list[tuple[str, ...]] = []
    for entry in spec:
        if entry is None:
            out.append(())
        elif isinstance(entry, str):
            out.append((entry,))
        else:
            out.append(tuple(entry))
    return out


@rule(R_SH_DIV, SHARD_FAMILY)
def check_divisibility(art: ShardArtifact) -> list[Finding]:
    """The resolver keeps its divisibility/no-double-use guarantees for
    every representative shape of the config on every mesh."""
    out: list[Finding] = []
    shapes = _representative_shapes(art.config)
    for mesh_shape in art.meshes:
        mesh = TableMesh(mesh_shape)
        for names, shape in shapes:
            try:
                spec = art.resolver(names, shape, mesh, art.rules)
            except Exception as e:
                out.append(Finding(
                    R_SH_DIV, FAIL,
                    f"{art.label()}: resolver raised {type(e).__name__} for "
                    f"{names} x {shape} on {mesh_shape}: {e}",
                    {"names": list(names), "shape": list(shape),
                     "mesh": dict(mesh_shape)},
                ))
                continue
            entries = _spec_entries(spec)
            if len(entries) != len(shape):
                out.append(Finding(
                    R_SH_DIV, FAIL,
                    f"{art.label()}: spec rank {len(entries)} != shape rank "
                    f"{len(shape)} for {names}",
                    {"names": list(names), "entries": entries},
                ))
                continue
            used: list[str] = []
            for name, dim, axes in zip(names, shape, entries):
                allowed = art.rules.mesh_axes(name)
                product = 1
                for axis in axes:
                    product *= mesh_shape.get(axis, 1)
                    if axis not in allowed:
                        out.append(Finding(
                            R_SH_DIV, FAIL,
                            f"{art.label()}: resolver shards {name!r} over "
                            f"{axis!r}, which the rule table does not allow "
                            f"({allowed})",
                            {"logical": name, "axis": axis,
                             "allowed": list(allowed)},
                        ))
                    if axis in used:
                        out.append(Finding(
                            R_SH_DIV, FAIL,
                            f"{art.label()}: mesh axis {axis!r} used by two "
                            f"dimensions of one spec ({names} x {shape})",
                            {"axis": axis, "names": list(names)},
                        ))
                    used.append(axis)
                if product > 1 and dim % product != 0:
                    out.append(Finding(
                        R_SH_DIV, FAIL,
                        f"{art.label()}: dimension {name!r}={dim} sharded "
                        f"over {axes} (product {product}) does not divide "
                        f"evenly on {mesh_shape} — DTensor would shard it "
                        f"unevenly",
                        {"logical": name, "dim": dim, "axes": list(axes),
                         "product": product, "mesh": dict(mesh_shape)},
                    ))
        # fallback reachability: a prime dimension must replicate
        for name in ("ffn", "embed", "vocab"):
            try:
                spec = art.resolver((name,), (_PRIME_DIM,), mesh, art.rules)
            except Exception as e:
                out.append(Finding(
                    R_SH_DIV, FAIL,
                    f"{art.label()}: prime-dimension probe raised "
                    f"{type(e).__name__}: {e}",
                    {"logical": name, "mesh": dict(mesh_shape)},
                ))
                continue
            entries = _spec_entries(spec)
            if entries and entries[0]:
                out.append(Finding(
                    R_SH_DIV, FAIL,
                    f"{art.label()}: replication fallback unreachable — "
                    f"prime dimension {name!r}={_PRIME_DIM} resolved to "
                    f"{entries[0]} instead of replicated on {mesh_shape}",
                    {"logical": name, "entries": entries[0],
                     "mesh": dict(mesh_shape)},
                ))
    return out


@rule(R_SH_POD, SHARD_FAMILY)
def check_multi_pod(art: ShardArtifact) -> list[Finding]:
    """``pod`` only ever data-shards batch, and the table composes with
    the (pod, node) repair mesh."""
    out: list[Finding] = []
    rules = art.rules
    batch = rules.mesh_axes("batch")
    if rules.multi_pod and (not batch or batch[0] != "pod"):
        out.append(Finding(
            R_SH_POD, FAIL,
            f"{rules!r}: multi_pod table's batch rule {batch} does not "
            f"lead with 'pod' — cross-pod data parallelism is lost",
            {"batch": list(batch)},
        ))
    for name in LOGICAL:
        if name == "batch":
            continue
        candidates = rules.mesh_axes(name)
        if "pod" in candidates:
            out.append(Finding(
                R_SH_POD, FAIL,
                f"{rules!r}: logical axis {name!r} lists the 'pod' mesh "
                f"axis ({candidates}) — a weight sharded across pods "
                f"turns the repair mesh's pod dimension into tensor "
                f"parallelism and every repair into a cross-pod gather",
                {"logical": name, "candidates": list(candidates)},
            ))
    if not rules.multi_pod and "pod" in batch:
        out.append(Finding(
            R_SH_POD, FAIL,
            f"{rules!r}: single-pod table shards batch over 'pod' "
            f"({batch})",
            {"batch": list(batch)},
        ))
    if rules.multi_pod:
        repair_mesh = TableMesh({"pod": 3, "node": 2})
        names = ("batch", "seq", "embed")
        shape = (12, 128, art.config.d_model)
        try:
            spec = art.resolver(names, shape, repair_mesh, rules)
        except Exception as e:
            out.append(Finding(
                R_SH_POD, FAIL,
                f"{art.label()}: resolution on the (pod, node) repair "
                f"mesh raised {type(e).__name__}: {e}",
                {"names": list(names), "shape": list(shape)},
            ))
            return out
        entries = _spec_entries(spec)
        for name, axes in zip(names[1:], entries[1:]):
            if "pod" in axes:
                out.append(Finding(
                    R_SH_POD, FAIL,
                    f"{art.label()}: non-batch dimension {name!r} resolved "
                    f"over 'pod' on the repair mesh ({axes})",
                    {"logical": name, "axes": list(axes)},
                ))
    return out


SHARD_RULES_ = (check_axis_reuse, check_divisibility, check_multi_pod)


def analyze_shard_artifact(art: ShardArtifact) -> list[Finding]:
    findings: list[Finding] = []
    for fn in SHARD_RULES_:
        findings.extend(fn(art))
    return findings


# --------------------------------------------------------------------------
# Sweep entry point
# --------------------------------------------------------------------------


def verify_shard_rules(
    config: Any, mode: str, *, family: str = SHARD_FAMILY
) -> LoweredRecord:
    """Analyze one (config, mode) pair — both single- and multi-pod
    tables — against the canonical meshes."""
    from repro_torch.dist.sharding import make_rules, resolve_spec

    findings: list[Finding] = []
    for multi_pod, meshes in (
        (False, CANONICAL_MESHES),
        (True, (*MULTI_POD_MESHES, *CANONICAL_MESHES)),
    ):
        art = ShardArtifact(
            rules=make_rules(mode, multi_pod=multi_pod),
            config=config,
            meshes=tuple(meshes),
            resolver=resolve_spec,
        )
        findings.extend(analyze_shard_artifact(art))
    return LoweredRecord(
        label=f"{config.name}/{mode}",
        family=family,
        artifact=f"Rules({mode!r}) x {config.name}",
        findings=findings,
        info={
            "meshes": [dict(m) for m in CANONICAL_MESHES + MULTI_POD_MESHES],
            "shapes": len(_representative_shapes(config)),
            "rules_checked": len(SHARD_RULES_),
        },
    )


# --------------------------------------------------------------------------
# Mutations
# --------------------------------------------------------------------------

SHARD_MUTATIONS: dict[str, str] = {
    "shard_double_map": R_SH_REUSE,
    "shard_greedy_resolver": R_SH_DIV,
    "shard_pod_leak": R_SH_POD,
}


class _MutantRules:
    """Rules stand-in with one table entry overridden."""

    def __init__(self, base: Any, override: dict[str, tuple[str, ...]]):
        self.mode = base.mode
        self.multi_pod = base.multi_pod
        self._base = base
        self._override = override

    def mesh_axes(self, name: str) -> tuple[str, ...]:
        if name in self._override:
            return self._override[name]
        axes = self._base.mesh_axes(name)
        return tuple(axes)

    def __repr__(self) -> str:
        return f"Mutant({self._base!r}, {self._override})"


def _greedy_resolver(
    names: Any, shape: Any, mesh: Any, rules: Any = None
) -> Any:
    """A deliberately broken resolver: respects the rule table and the
    no-double-use scan but skips the divisibility test."""
    from repro_torch.dist.sharding import current_rules

    rules = current_rules() if rules is None else rules
    mesh_shape = dict(mesh.shape)
    used: set[str] = set()
    entries: list[Any] = []
    for name, _dim in zip(names, shape):
        if name is None:
            entries.append(None)
            continue
        chosen = [
            axis for axis in rules.mesh_axes(name)
            if mesh_shape.get(axis, 0) > 1 and axis not in used
        ]
        used.update(chosen)
        if not chosen:
            entries.append(None)
        elif len(chosen) == 1:
            entries.append(chosen[0])
        else:
            entries.append(tuple(chosen))
    return tuple(entries)


def mutate_shard(art: ShardArtifact, mutation: str) -> ShardArtifact:
    """Return a corrupted copy of the artifact."""
    if mutation == "shard_double_map":
        # On 'expert' no representative shape resolves, so only the
        # static table rule can catch this — which is the point: the
        # resolver would happily shard one dim over model twice
        # (product model^2) the day an expert-parallel config lands.
        bad = _MutantRules(art.rules, {"expert": ("model", "model")})
        return dataclasses.replace(art, rules=bad)
    if mutation == "shard_greedy_resolver":
        return dataclasses.replace(art, resolver=_greedy_resolver)
    if mutation == "shard_pod_leak":
        from repro_torch.dist.sharding import make_rules

        base = make_rules(art.rules.mode, multi_pod=True)
        bad = _MutantRules(base, {"embed": ("pod",)})
        return dataclasses.replace(art, rules=bad)
    raise ValueError(f"unknown shard mutation {mutation!r}")


__all__ = [
    "R_SH_REUSE", "R_SH_DIV", "R_SH_POD", "SHARD_MUTATIONS",
    "CANONICAL_MESHES", "MULTI_POD_MESHES", "ShardArtifact", "TableMesh",
    "analyze_shard_artifact", "verify_shard_rules", "mutate_shard",
]
