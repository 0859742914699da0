"""Rule registry shared by the lowered-layer analyzers.

The port's copy of ``repro.check.lowered.base``.  Mirrors the plan
verifier's registry (``repro_torch.check.plan``), but lowered rules are grouped
by *family* because each family analyzes a different artifact type:

* ``spmd-schedule`` — a ``SpmdRepairSpec`` (plus the code/plan it was
  lowered from),
* ``shard-rules`` — a sharding ``Rules`` table resolved against a
  model config on concrete meshes,
* ``cuda-kernel`` — a CUDA kernel's launch geometry and work walk
  (``GfGeometry``, ``FlashWorkGeometry``) or a GF source file; it takes
  the place of the reference's ``pallas-kernel``.

``rule(rule_id, family)`` registers a rule under a stable id; the
sweep, the mutation self-test and the docs catalog all read
``LOWERED_RULES``.  Ids are namespaced ``lowered.<family>.<name>``.
"""
from __future__ import annotations

from typing import Callable, TypeVar

from ..report import Finding

LoweredRuleFn = Callable[..., list[Finding]]
_F = TypeVar("_F", bound=LoweredRuleFn)

SPMD_FAMILY = "spmd-schedule"
SHARD_FAMILY = "shard-rules"
CUDA_FAMILY = "cuda-kernel"

LOWERED_FAMILIES = (SPMD_FAMILY, SHARD_FAMILY, CUDA_FAMILY)

# rule id -> (family, rule fn); populated by the family modules at import
LOWERED_RULES: dict[str, tuple[str, LoweredRuleFn]] = {}


def rule(rule_id: str, family: str) -> Callable[[_F], _F]:
    """Register a lowered-layer rule under a stable id."""
    if family not in LOWERED_FAMILIES:
        raise ValueError(f"unknown lowered family {family!r}")

    def deco(fn: _F) -> _F:
        if rule_id in LOWERED_RULES:
            raise ValueError(f"duplicate lowered rule id {rule_id!r}")
        LOWERED_RULES[rule_id] = (family, fn)
        return fn

    return deco


def rules_for(family: str) -> dict[str, LoweredRuleFn]:
    """The registered rules of one family, id -> fn."""
    return {
        rid: fn for rid, (fam, fn) in LOWERED_RULES.items() if fam == family
    }


def fail_rules(findings: list[Finding]) -> set[str]:
    """Distinct rule ids that FAILed — the mutation self-test's currency."""
    from ..report import FAIL

    return {f.rule for f in findings if f.severity == FAIL}

