"""Static analysis over *traced* programs (``repro_torch.check.traced``).

The port's counterpart of ``repro.check.traced``, the third verification
layer.  ``repro_torch.check.plan`` proves the repair DAG optimal,
``repro_torch.check.lowered`` proves the declared lowering artifacts preserve
that optimality; this package proves the **programs the port actually
dispatches** do too.  It captures the real entry points as op traces below
the dispatcher (:mod:`.capture`: the process-group repair body of every
REGISTRY_SWEEP DRC shape + an RS contrast, rank by rank over a fake
``(pod, node)`` world; the plain GF product and the GF kernel's custom op;
the serve prefill and decode steps; the train step; the in-place checkpoint
encode) and runs dataflow rules over them:

* :mod:`.dtype_flow` — uint8 taint lattice: GF(2^8) payload bytes are never
  wrapped by ring arithmetic, never promoted to float, and leave the program
  as uint8.
* :mod:`.collectives` — the traced sends match the declared
  ``SpmdRepairSpec`` schedule 1:1 (pairing-valid, every send received,
  gathers inside a pod, cross-pod bytes only into the collector), and the
  bytes the collector receives across pods equal ``plan.traffic_blocks()``
  and the Eq. (3) closed form.
* :mod:`.hygiene` — no host read of a device value or device-to-host copy in
  any program; a handed output buffer is computed into, not staged.

Every rule has a paired mutation in ``TRACED_MUTATIONS``;
:func:`self_test_traced` corrupts one captured artifact per mutation and
demands the corruption FAIL *exactly* its owning rule (the contract of
``self_test_lowered``).  Nothing here imports ``jax`` or ``repro``.
"""
from __future__ import annotations

from typing import Any

from ..report import FAIL, CheckReport, Finding, TracedRecord
from . import collectives, dtype_flow, hygiene
from .base import (
    COLL_FAMILY,
    DTYPE_FAMILY,
    HYG_FAMILY,
    TRACED_FAMILIES,
    TRACED_RULES,
    fail_rules,
    rules_for,
)
from .capture import (
    CollectiveFootprint,
    TracedProgram,
    capture_checkpoint_encode,
    capture_gf_cuda,
    capture_gf_table,
    capture_serve_decode,
    capture_serve_prefill,
    capture_spmd_repair,
    capture_train_step,
    fake_world,
)


def spmd_shapes() -> list[tuple[str, int, int, int]]:
    """Every REGISTRY_SWEEP DRC shape, plus RS(9,6,3) as the non-layered
    contrast: the shapes whose traced byte accounting the gate demands."""
    from ..plan import REGISTRY_SWEEP

    shapes: list[tuple[str, int, int, int]] = []
    for family in ("DRC-f1", "DRC-f2"):
        for cfg in REGISTRY_SWEEP[family]:
            if cfg not in shapes:
                shapes.append(cfg)
    shapes.append(("RS", 9, 6, 3))
    return shapes


def run_rules(program: TracedProgram) -> list[Finding]:
    """Run every registered traced rule over one captured program."""
    findings: list[Finding] = []
    for rid in sorted(TRACED_RULES):
        _, fn = TRACED_RULES[rid]
        findings.extend(fn(program))
    return findings


def record(program: TracedProgram) -> TracedRecord:
    """The program's record: every rule's findings and what was traced."""
    fp = program.footprint
    moved = hygiene.host_transfers(program)
    info: dict[str, Any] = {
        "ops": len(program.ops),
        "ranks": len({op.rank for op in program.ops}),
        "sends": len(fp.sends),
        "recvs": len(fp.recvs),
        "gathers": len(fp.gathers),
        "reduces": len(fp.reduces),
        "kernel_ops": sum(op.namespace == "repro_torch" for op in program.ops),
        "host_to_device": moved["host_to_device"],
        "host_to_device_bytes": moved["host_to_device_bytes"],
        "rules_checked": len(TRACED_RULES),
    }
    if "device" in program.meta:
        info["device"] = program.meta["device"]
    spec = program.meta.get("spec")
    if spec is not None:
        info["cross_units"] = spec.cross_units
        info["traced_cross_bytes"] = collectives.cross_pod_recv_bytes(
            fp.recvs, spec.target_pod * spec.w, spec.w)
    return TracedRecord(label=program.name, kind=program.kind,
                        findings=run_rules(program), info=info)


def sweep_programs() -> list[TracedProgram]:
    """Capture every traced entry point (15 programs)."""
    programs = [capture_spmd_repair(fam, n, k, r) for fam, n, k, r in spmd_shapes()]
    programs += [capture_gf_table(), capture_gf_cuda(), capture_serve_prefill(),
                 capture_serve_decode(), capture_train_step(), capture_checkpoint_encode()]
    return programs


def run_traced_sweep() -> list[TracedRecord]:
    """Capture + analyze every traced entry point; one record each."""
    return [record(p) for p in sweep_programs()]


def traced_report() -> CheckReport:
    """A CheckReport holding only the traced sweep."""
    return CheckReport(traced_records=run_traced_sweep())


# --------------------------------------------------------------- self-test
# mutation name -> (family, owning rule id)
TRACED_MUTATIONS: dict[str, tuple[str, str]] = {
    **{m: (DTYPE_FAMILY, r) for m, r in dtype_flow.DTYPE_MUTATIONS.items()},
    **{m: (COLL_FAMILY, r) for m, r in collectives.COLL_MUTATIONS.items()},
    **{m: (HYG_FAMILY, r) for m, r in hygiene.HYG_MUTATIONS.items()},
}

BASE_SHAPE = ("DRC", 6, 4, 3)


def mutant_program(mutation: str, base: TracedProgram | None = None) -> TracedProgram:
    """The corrupted program for one named mutation; the collective ones
    corrupt ``base``, a captured repair program (``BASE_SHAPE``'s by
    default)."""
    if mutation in dtype_flow.DTYPE_MUTATIONS:
        return dtype_flow.dtype_mutation_program(mutation)
    if mutation in collectives.COLL_MUTATIONS:
        return collectives.coll_mutation_program(
            mutation, base or capture_spmd_repair(*BASE_SHAPE))
    if mutation == "hyg_callback":
        return hygiene.callback_mutation_program()
    if mutation == "hyg_no_donation":
        return hygiene.donation_mutation_program(*BASE_SHAPE)
    raise ValueError(f"unknown traced mutation {mutation!r}")


def self_test_traced(base: TracedProgram | None = None) -> list[tuple[str, str, bool, bool]]:
    """Corrupt one captured artifact per mutation.

    Returns (mutation, owning rule, caught, exclusive) rows; the gate
    demands caught AND exclusive — every registered traced rule runs over
    the corrupted program and the corruption must FAIL exactly the rule
    that owns it.  ``base`` is the repair program the collective mutations
    corrupt (captured once here when not given).
    """
    base = base or capture_spmd_repair(*BASE_SHAPE)
    rows: list[tuple[str, str, bool, bool]] = []
    for mutation, (_family, owner) in TRACED_MUTATIONS.items():
        fails = fail_rules(run_rules(mutant_program(mutation, base)))
        rows.append((mutation, owner, owner in fails, fails == {owner}))
    return rows


__all__ = [
    "BASE_SHAPE", "COLL_FAMILY", "DTYPE_FAMILY", "FAIL", "HYG_FAMILY", "TRACED_FAMILIES",
    "TRACED_MUTATIONS", "TRACED_RULES", "CollectiveFootprint", "Finding", "TracedProgram",
    "TracedRecord", "capture_checkpoint_encode", "capture_gf_cuda", "capture_gf_table",
    "capture_serve_decode", "capture_serve_prefill", "capture_spmd_repair",
    "capture_train_step", "collectives", "dtype_flow", "fail_rules", "fake_world",
    "hygiene", "mutant_program", "record", "rules_for", "run_rules", "run_traced_sweep",
    "self_test_traced", "spmd_shapes", "sweep_programs", "traced_report",
]
