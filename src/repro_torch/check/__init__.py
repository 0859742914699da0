"""``repro_torch.check`` — static verification of the port's artifacts.

The counterpart of ``repro.check``, over the port's own artifacts.  Four
layers, all payload-free:

* **Plan verifier** (`repro_torch.check.plan`) — proves every registered
  code's repair plans well-formed, symbolically decodable, bandwidth-
  optimal and placement-safe, straight from their GF(256) matrices, and
  the ``SpmdRepairSpec`` both executors run byte-exact against them.
* **Lowered-layer analyzer** (`repro_torch.check.lowered`) — proves the
  lowering preserved the plan's guarantees: SPMD collective schedules,
  sharding-rule tables resolved against every model config, and the two
  CUDA kernels' launch geometry and persistent work walk swept in interval
  arithmetic (in bounds, every output element written exactly once), plus
  a GF(2^8) dtype-safety AST pass over the Python GF paths.
* **Traced-layer analyzer** (`repro_torch.check.traced`) — proves the
  programs the port dispatches keep those guarantees: op traces of the
  process-group repair over every rank, both GF paths, the serve and train
  steps and the checkpoint encode, captured on fake card tensors, under a
  uint8 taint lattice, collective conformance held to Eq. (3) and hot-path
  hygiene (no host reads, outputs computed in place).
* **AST linter** (`repro_torch.check.ast_rules`) — a dependency-free pass
  over the source tree catching the PyTorch pitfalls of this port (host
  syncs and host reads on the hot path, uint8 index tensors, kernels built
  at import time, leaked spans, mutable defaults, stale pragmas).

``python -m repro_torch.check`` runs all four; ``--self-test`` runs the
mutation tests.  ``repro_torch.core.repair`` imports `PlanError` from
``repro_torch.check.errors`` at module load, so this ``__init__`` keeps
everything except the error types lazy (PEP 562) to stay cycle-free.
"""
from __future__ import annotations

from typing import Any

from .errors import CheckError, PlanError

__all__ = [
    "CheckError",
    "PlanError",
    # report model
    "FAIL", "PASS", "WARN", "CheckReport", "Finding", "LintRecord",
    "LoweredRecord", "PlanRecord", "TracedRecord",
    # plan verifier
    "MUTATIONS", "PLAN_RULES", "REGISTRY_SWEEP", "mutate_plan",
    "run_registry_sweep", "self_test", "sweep_report", "verify_code",
    "verify_plan", "verify_stripwise",
    # lowered-layer analyzer
    "LOWERED_MUTATIONS", "LOWERED_RULES", "LOWERED_SWEEP",
    "lowered_report", "run_lowered_sweep", "self_test_lowered",
    # traced-layer analyzer
    "TRACED_MUTATIONS", "TRACED_RULES", "run_traced_sweep", "self_test_traced",
    "traced_report",
    # AST linter
    "ALL_LINT_RULES", "lint_file", "lint_paths", "lint_source", "lint_tree",
]

_LAZY = {
    "FAIL": "report", "PASS": "report", "WARN": "report",
    "CheckReport": "report", "Finding": "report", "LintRecord": "report",
    "LoweredRecord": "report", "PlanRecord": "report", "TracedRecord": "report",
    "MUTATIONS": "plan", "PLAN_RULES": "plan", "REGISTRY_SWEEP": "plan",
    "mutate_plan": "plan", "run_registry_sweep": "plan", "self_test": "plan",
    "sweep_report": "plan", "verify_code": "plan", "verify_plan": "plan",
    "verify_stripwise": "plan",
    "LOWERED_MUTATIONS": "lowered", "LOWERED_RULES": "lowered",
    "LOWERED_SWEEP": "lowered", "lowered_report": "lowered",
    "run_lowered_sweep": "lowered", "self_test_lowered": "lowered",
    "TRACED_MUTATIONS": "traced", "TRACED_RULES": "traced",
    "run_traced_sweep": "traced", "self_test_traced": "traced",
    "traced_report": "traced",
    "ALL_LINT_RULES": "ast_rules", "lint_file": "ast_rules",
    "lint_paths": "ast_rules", "lint_source": "ast_rules",
    "lint_tree": "ast_rules",
}


def __getattr__(name: str) -> Any:
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module 'repro_torch.check' has no attribute {name!r}")
    import importlib

    mod = importlib.import_module(f".{module}", __name__)
    value = getattr(mod, name)
    globals()[name] = value  # cache for subsequent lookups
    return value


def __dir__() -> list[str]:
    return sorted(__all__)
