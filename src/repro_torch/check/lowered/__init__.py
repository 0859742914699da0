"""Static analysis over *lowered* artifacts (``repro_torch.check.lowered``).

``repro_torch.check.plan`` proves repair plans optimal at the DAG level;
this package proves the lowering layers preserved that optimality:

* :mod:`.spmd` — the static SPMD collective schedule
  (``SpmdRepairSpec``): partial-permutation validity, row liveness,
  dead-device silence, decode-gather consistency, exact per-pod byte
  accounting against Eq. (3), rotation balance.
* :mod:`.shard_rules` — sharding-rule tables resolved against every
  model config: axis hygiene, divisibility/fallback guarantees, pod-
  axis containment.
* :mod:`.cuda` — the two CUDA kernels' launch geometry and persistent
  work walk swept in interval arithmetic (in bounds, every output element
  written exactly once) plus a GF(2^8) dtype-safety AST pass over the
  Python GF paths.

Every rule has a paired mutation in ``LOWERED_MUTATIONS``;
:func:`self_test_lowered` corrupts a known-good artifact per mutation
and demands the corruption is caught by *exactly* its owning rule —
stronger than the plan-layer self-test, which only demands the owner
fires.  ``python -m repro_torch.check --self-test`` runs both.
"""
from __future__ import annotations

from typing import Any, Callable

from ..report import FAIL, CheckReport, Finding, LoweredRecord
from . import cuda, shard_rules, spmd
from .base import (
    CUDA_FAMILY,
    LOWERED_FAMILIES,
    LOWERED_RULES,
    SHARD_FAMILY,
    SPMD_FAMILY,
    fail_rules,
    rules_for,
)

# ------------------------------------------------------------------- sweep
# family -> artifact parameters; mirrors plan.REGISTRY_SWEEP in spirit.
LOWERED_SWEEP: dict[str, Any] = {
    SPMD_FAMILY: [
        ("DRC", 6, 4, 3),
        ("DRC", 9, 6, 3),
        ("DRC", 9, 5, 3),
        ("DRC", 8, 6, 4),
        ("RS", 9, 6, 3),
    ],
    SHARD_FAMILY: "ARCHS x MODES",  # resolved at sweep time
    CUDA_FAMILY: "GF and flash launches at the main path's shapes, and the GF sources",
}


def run_lowered_sweep() -> list[LoweredRecord]:
    """Analyze every registered lowered artifact; one record each."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.core.codes.registry import make_code
    from repro_torch.dist.sharding import MODES

    records: list[LoweredRecord] = []
    for fam, n, k, r in LOWERED_SWEEP[SPMD_FAMILY]:
        code = make_code(fam, n, k, r=r)
        records.extend(spmd.verify_spmd_lowering(code))
    for arch in ARCHS:
        config = get_config(arch)
        for mode in MODES:
            records.append(shard_rules.verify_shard_rules(config, mode))
    for label, geom in cuda.sweep_geometries():
        records.append(cuda.verify_kernel_geometry(label, geom))
    for path in cuda.gf_source_paths():
        records.append(cuda.verify_gf_source(path))
    return records


def lowered_report() -> CheckReport:
    """A CheckReport holding only the lowered sweep."""
    return CheckReport(lowered_records=run_lowered_sweep())


# --------------------------------------------------------------- self-test
# mutation name -> (family, owning rule id)
LOWERED_MUTATIONS: dict[str, tuple[str, str]] = {
    **{m: (SPMD_FAMILY, r) for m, r in spmd.SPMD_MUTATIONS.items()},
    **{m: (SHARD_FAMILY, r) for m, r in shard_rules.SHARD_MUTATIONS.items()},
    **{m: (CUDA_FAMILY, r) for m, r in cuda.CUDA_MUTATIONS.items()},
}


def _spmd_mutation_fails(mutation: str) -> set[str]:
    from repro_torch.core.codes.registry import make_code
    from repro_torch.dist.collectives import plan_to_spmd

    code = make_code("DRC", 6, 4, r=3)
    plan = code.repair_plan(0)
    spec = plan_to_spmd(code, plan)
    mutated = spmd.mutate_spmd(code, plan, spec, mutation)
    return fail_rules(spmd.spmd_mutation_findings(code, plan, mutated))


def _shard_mutation_fails(mutation: str) -> set[str]:
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import make_rules, resolve_spec

    art = shard_rules.ShardArtifact(
        rules=make_rules("tp", multi_pod=True),
        config=get_config("command_r_35b"),
        meshes=(
            *shard_rules.MULTI_POD_MESHES,
            *shard_rules.CANONICAL_MESHES,
        ),
        resolver=resolve_spec,
    )
    mutated = shard_rules.mutate_shard(art, mutation)
    return fail_rules(shard_rules.analyze_shard_artifact(mutated))


def _cuda_mutation_fails(mutation: str) -> set[str]:
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_work_geometry
    from repro_torch.kernels.gf_matmul import gf_matmul_geometry

    gf_geom = gf_matmul_geometry(1, 9, 18, 65_536, sms=cuda.SMS)
    flash_geom = flash_attention_work_geometry(2, 333, 517, 8, 2, 64, torch.bfloat16,
                                               cuda.SMS)
    sources = cuda.read_sources(cuda.gf_source_paths())
    return fail_rules(cuda.cuda_findings(*cuda.mutate_cuda(gf_geom, flash_geom, sources,
                                                           mutation)))


_MUTATION_RUNNERS: dict[str, Callable[[str], set[str]]] = {
    SPMD_FAMILY: _spmd_mutation_fails,
    SHARD_FAMILY: _shard_mutation_fails,
    CUDA_FAMILY: _cuda_mutation_fails,
}


def self_test_lowered() -> list[tuple[str, str, bool, bool]]:
    """Corrupt one known-good artifact per mutation.

    Returns (mutation, owning rule, caught, exclusive) rows; the gate
    demands caught AND exclusive — the corruption must FAIL exactly the
    rule that owns it, proving both coverage and rule independence.
    """
    rows: list[tuple[str, str, bool, bool]] = []
    for mutation, (family, owner) in LOWERED_MUTATIONS.items():
        fails = _MUTATION_RUNNERS[family](mutation)
        rows.append((mutation, owner, owner in fails, fails == {owner}))
    return rows


__all__ = [
    "CUDA_FAMILY", "LOWERED_FAMILIES", "LOWERED_MUTATIONS", "LOWERED_RULES",
    "LOWERED_SWEEP", "SHARD_FAMILY", "SPMD_FAMILY",
    "FAIL", "Finding", "LoweredRecord", "cuda", "fail_rules", "lowered_report",
    "rules_for", "run_lowered_sweep", "self_test_lowered", "shard_rules", "spmd",
]
