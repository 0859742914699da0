"""Machine-readable report model of ``repro_torch.check``.

One `Finding` per rule violation (or informational note), one record per
verified artifact — a (code, failed-node) repair plan, a code-level
structural check, a lowered artifact (SPMD schedule, sharding-rule table,
CUDA kernel launch geometry or GF source), a traced program, or a linted
source file — and one `CheckReport` aggregating a whole run.  The JSON
schema is the reference's (``repro.check.report``, version 3): the same
keys, so one reader serves both packages' reports.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any

PASS = "PASS"
WARN = "WARN"
FAIL = "FAIL"

_SEVERITY_ORDER = {PASS: 0, WARN: 1, FAIL: 2}

SCHEMA_VERSION = 3


@dataclass(frozen=True)
class Finding:
    """One rule violation (or note) with a witness for the exact defect."""

    rule: str
    severity: str
    message: str
    witness: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.severity not in _SEVERITY_ORDER:
            raise ValueError(f"bad severity {self.severity!r}")

    def as_dict(self) -> dict[str, Any]:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "message": self.message,
            "witness": _jsonable(self.witness),
        }


def _worst(findings: list[Finding]) -> str:
    worst = PASS
    for f in findings:
        if _SEVERITY_ORDER[f.severity] > _SEVERITY_ORDER[worst]:
            worst = f.severity
    return worst


@dataclass
class PlanRecord:
    """Verification outcome for one plan (or one code-level check).

    ``failed`` is the repaired node id, or ``None`` for code-level
    records (e.g. the stripwise generator-structure checks).
    """

    label: str  # e.g. "DRC(6,4,3)"
    family: str  # sweep family key, e.g. "DRC-f1", "stripwise"
    n: int
    k: int
    r: int
    failed: int | None
    findings: list[Finding] = field(default_factory=list)
    info: dict[str, Any] = field(default_factory=dict)

    @property
    def status(self) -> str:
        return _worst(self.findings)

    def as_dict(self) -> dict[str, Any]:
        return {
            "label": self.label,
            "family": self.family,
            "n": self.n,
            "k": self.k,
            "r": self.r,
            "failed": self.failed,
            "status": self.status,
            "findings": [f.as_dict() for f in self.findings],
            "info": _jsonable(self.info),
        }


@dataclass
class LoweredRecord:
    """Verification outcome for one *lowered* artifact.

    The plan verifier sees GF matrices on a DAG; this record covers what
    comes out of the lowering layers instead — a static SPMD collective
    schedule (``SpmdRepairSpec``), a sharding-rule table resolved against
    a model config, or a CUDA kernel's launch geometry and work walk (or a
    GF source file).  ``family`` is the lowered sweep key
    (``spmd-schedule``, ``shard-rules``, ``cuda-kernel``); ``artifact``
    names the thing analyzed, e.g. ``SpmdRepairSpec(failed=0)``.
    """

    label: str
    family: str
    artifact: str
    findings: list[Finding] = field(default_factory=list)
    info: dict[str, Any] = field(default_factory=dict)

    @property
    def status(self) -> str:
        return _worst(self.findings)

    def as_dict(self) -> dict[str, Any]:
        return {
            "label": self.label,
            "family": self.family,
            "artifact": self.artifact,
            "status": self.status,
            "findings": [f.as_dict() for f in self.findings],
            "info": _jsonable(self.info),
        }


@dataclass
class TracedRecord:
    """Verification outcome for one *traced* program.

    The lowered layer analyzes declared artifacts; a traced record covers
    the program the port actually dispatches — the op trace of one real
    entry point (over every rank of its mesh), analyzed by the
    ``repro_torch.check.traced`` dataflow rules.  ``kind`` is the program
    class (``repair``, ``kernel``, ``hot-path``, ``checkpoint``); ``label``
    names the capture, e.g. ``spmd_repair[DRC(6,4,3) failed=0]``.
    """

    label: str
    kind: str
    findings: list[Finding] = field(default_factory=list)
    info: dict[str, Any] = field(default_factory=dict)

    @property
    def status(self) -> str:
        return _worst(self.findings)

    def as_dict(self) -> dict[str, Any]:
        return {
            "label": self.label,
            "kind": self.kind,
            "status": self.status,
            "findings": [f.as_dict() for f in self.findings],
            "info": _jsonable(self.info),
        }


@dataclass
class LintRecord:
    """AST-lint outcome for one source file."""

    path: str
    findings: list[Finding] = field(default_factory=list)

    @property
    def status(self) -> str:
        return _worst(self.findings)

    def as_dict(self) -> dict[str, Any]:
        return {
            "path": self.path,
            "status": self.status,
            "findings": [f.as_dict() for f in self.findings],
        }


@dataclass
class CheckReport:
    """Aggregate of one ``repro_torch.check`` run (plan, lowered and traced
    sweeps + lint)."""

    plan_records: list[PlanRecord] = field(default_factory=list)
    lowered_records: list[LoweredRecord] = field(default_factory=list)
    traced_records: list[TracedRecord] = field(default_factory=list)
    lint_records: list[LintRecord] = field(default_factory=list)

    def _all_records(
        self,
    ) -> tuple[PlanRecord | LoweredRecord | TracedRecord | LintRecord, ...]:
        return (
            *self.plan_records,
            *self.lowered_records,
            *self.traced_records,
            *self.lint_records,
        )

    # ------------------------------------------------------------ queries
    def counts(self) -> dict[str, int]:
        out = {PASS: 0, WARN: 0, FAIL: 0}
        for rec in self._all_records():
            out[rec.status] += 1
        return out

    @property
    def ok(self) -> bool:
        """True iff no record FAILed (WARNs do not gate)."""
        return self.counts()[FAIL] == 0

    def failures(self) -> list[Finding]:
        return [
            f
            for rec in self._all_records()
            for f in rec.findings
            if f.severity == FAIL
        ]

    # ------------------------------------------------------------- export
    def as_dict(self) -> dict[str, Any]:
        return {
            "version": SCHEMA_VERSION,
            "generated_by": "repro_torch.check",
            "summary": self.counts(),
            "plan_records": [r.as_dict() for r in self.plan_records],
            "lowered_records": [r.as_dict() for r in self.lowered_records],
            "traced_records": [r.as_dict() for r in self.traced_records],
            "lint_records": [r.as_dict() for r in self.lint_records],
        }

    def write_json(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=1, sort_keys=True)
        return path


def _jsonable(obj: Any) -> Any:
    """Best-effort conversion of witnesses to JSON-serializable values."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, bool, int, float)) or obj is None:
        return obj
    if hasattr(obj, "tolist"):  # numpy scalars/arrays, tensors
        return _jsonable(obj.tolist())
    if hasattr(obj, "item"):
        return _jsonable(obj.item())
    return repr(obj)
