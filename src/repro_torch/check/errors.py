"""Typed errors raised by the plan layer (copy of ``repro.check.errors``).

This module is a dependency-free leaf: ``repro_torch.core.repair`` raises
`PlanError` from deep inside plan construction/verification.  The
reference package's verifier rules catch the same class to classify the
failure under the rule that owns it.
"""
from __future__ import annotations

from typing import Any


class CheckError(Exception):
    """Base class for every error raised by the verification layer."""


class PlanError(CheckError):
    """A structural defect in a `RepairPlan`, with machine-usable context.

    ``rule`` names the verifier rule that owns this class of defect (see
    the rule catalog in docs/architecture.md); ``context`` carries the
    witness (offending node ids, shapes, orders) so reports can point at
    the exact edge of the DAG that is wrong.
    """

    def __init__(self, message: str, *, rule: str = "", **context: Any):
        super().__init__(message)
        self.rule = rule
        self.context: dict[str, Any] = dict(context)

    def __str__(self) -> str:
        base = super().__str__()
        if self.context:
            ctx = ", ".join(f"{k}={v!r}" for k, v in sorted(self.context.items()))
            return f"{base} [{ctx}]"
        return base
