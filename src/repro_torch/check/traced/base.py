"""Rule registry for the traced-layer analyzers.

The port's copy of ``repro.check.traced.base``.  Third verification layer:
``repro_torch.check.plan`` proves the repair DAG,
``repro_torch.check.lowered`` proves the declared lowering artifacts, and
this package proves the *programs the port actually dispatches* — the op
traces captured below PyTorch's dispatcher from the real entry points.

Traced rules are grouped by *analysis*, because every rule can run over any
captured program:

* ``dtype-flow`` — the uint8 taint lattice over the op trace
  (:mod:`.dtype_flow`),
* ``collective`` — the sends, receives, gathers and reductions against the
  ``SpmdRepairSpec`` schedule plus the bytes received across pods
  (:mod:`.collectives`),
* ``hygiene`` — host-transfer freedom and in-place outputs
  (:mod:`.hygiene`).

``rule(rule_id, family)`` registers under a stable id; the sweep, the
mutation self-test and the docs catalog all read ``TRACED_RULES``.  Ids are
namespaced ``traced.<group>.<name>``, the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, TypeVar

from ..report import FAIL, Finding

TracedRuleFn = Callable[..., list[Finding]]
_F = TypeVar("_F", bound=TracedRuleFn)

DTYPE_FAMILY = "dtype-flow"
COLL_FAMILY = "collective"
HYG_FAMILY = "hygiene"

TRACED_FAMILIES = (DTYPE_FAMILY, COLL_FAMILY, HYG_FAMILY)

# rule id -> (family, rule fn); populated by the analysis modules at import
TRACED_RULES: dict[str, tuple[str, TracedRuleFn]] = {}


def rule(rule_id: str, family: str) -> Callable[[_F], _F]:
    """Register a traced-layer rule under a stable id."""
    if family not in TRACED_FAMILIES:
        raise ValueError(f"unknown traced family {family!r}")

    def deco(fn: _F) -> _F:
        if rule_id in TRACED_RULES:
            raise ValueError(f"duplicate traced rule id {rule_id!r}")
        TRACED_RULES[rule_id] = (family, fn)
        return fn

    return deco


def rules_for(family: str) -> dict[str, TracedRuleFn]:
    """The registered rules of one analysis group, id -> fn."""
    return {
        rid: fn for rid, (fam, fn) in TRACED_RULES.items() if fam == family
    }


def fail_rules(findings: list[Finding]) -> set[str]:
    """Distinct rule ids that FAILed — the mutation self-test's currency."""
    return {f.rule for f in findings if f.severity == FAIL}


def as_witness(**kw: Any) -> dict[str, Any]:
    """Tiny helper keeping witness construction one line at call sites."""
    return kw
