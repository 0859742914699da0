"""Static analysis of the SPMD collective-permute schedule.

``plan_to_spmd`` freezes a ``RepairPlan`` into a ``SpmdRepairSpec`` —
stacked encode matrices, per-pod cross-ship row lists, a decode gather
order.  The plan verifier proves the *plan* optimal; these rules prove
the *lowering* did not lose that optimality on the way to hardware:

* ``lowered.spmd.permute-partial`` — the declared collective-permute
  steps form a valid partial permutation: no pod ships to itself, no
  duplicate source or destination within the schedule, every step lands
  on the collector pod.  A self-send or duplicate source would make the
  compiled ``ppermute`` drop or double-deliver units silently.
* ``lowered.spmd.rows-live`` — every scheduled pool row exists (in
  bounds), is shipped at most once per pod, and points at a unit the
  shipping pod actually *produces* (never into the zero padding the
  stacked matrices carry).  Shipping a padding row is the lowered
  analogue of a dangling DAG edge.
* ``lowered.spmd.dead-device`` — the failed device contributes nothing:
  its NodeEncode/RelayerEncode rows are all-zero, no device encodes
  units the plan never routes (ghost encodes), and the relayer set of
  the lowering equals the plan's relayers exactly.
* ``lowered.spmd.decode-gather`` — the collector's gather order is
  consistent: one decode column per gathered unit, all indices in
  bounds of the post-permute pool, every received unit consumed at most
  once, and local references resolve to live target-pod rows.
* ``lowered.spmd.byte-accounting`` — per-pod scheduled cross units
  equal the plan's per-rack cross accounting and the totals equal
  ``traffic_blocks()`` (blocks x alpha) for both scopes; the Eq. (3)
  bound survives lowering pod by pod, not just in aggregate.
* ``lowered.spmd.rotation-balance`` — across a full rotation cycle of
  ``spmd_node_recovery`` stripes, relayer duty within each remote pod
  is balanced within one stripe (paper §5.2 load balancing).

Ownership note: rows scheduled *by the target pod itself* are reported
only by ``permute-partial`` (self-send); the other rules skip that slot
so each defect has exactly one owning rule — the property the mutation
self-test asserts.

The port's copy of ``repro.check.lowered.spmd``, over the
``repro_torch.dist.collectives.SpmdRepairSpec`` that both of the port's
executors (the emulated mesh and the process-group mesh) run.
"""
from __future__ import annotations

from typing import Any, Iterable

import numpy as np

from repro_torch.core.code_base import ErasureCode
from repro_torch.core.repair import TARGET, RepairPlan

from ..report import FAIL, Finding, LoweredRecord
from .base import SPMD_FAMILY, fail_rules, rule

R_LS_PERMUTE = "lowered.spmd.permute-partial"
R_LS_ROWS = "lowered.spmd.rows-live"
R_LS_DEAD = "lowered.spmd.dead-device"
R_LS_GATHER = "lowered.spmd.decode-gather"
R_LS_BYTES = "lowered.spmd.byte-accounting"
R_LS_ROTATION = "lowered.spmd.rotation-balance"


# --------------------------------------------------------------------------
# Shared derivations from the plan (the ground truth the spec must match)
# --------------------------------------------------------------------------


def _node_units(plan: RepairPlan) -> dict[int, int]:
    """Units each node's stacked NodeEncode block really produces."""
    out: dict[int, int] = {}
    for s in plan.node_sends:
        out[s.src] = out.get(s.src, 0) + s.units
    return out


def _relayer_units(plan: RepairPlan) -> dict[int, int]:
    out: dict[int, int] = {}
    for s in plan.relayer_sends:
        out[s.src] = out.get(s.src, 0) + s.units
    return out


def _live_row(
    plan: RepairPlan, spec: Any, pod: int, row: int
) -> tuple[bool, str]:
    """Is pool row `row` of pod `pod` a unit that pod really produces?

    Returns (live, reason-if-not).  Row layout mirrors plan_to_spmd:
    rows [0, w*nu) are node units (slot-major, nu-strided), rows
    [w*nu, w*nu + w*ru) are relayer units.
    """
    w, nu, ru = spec.w, spec.nu, spec.ru
    if not 0 <= row < spec.pool_rows:
        return False, f"row {row} out of bounds [0, {spec.pool_rows})"
    if row < w * nu:
        slot, off = divmod(row, nu)
        node = pod * w + slot
        have = _node_units(plan).get(node, 0)
        if off >= have:
            return False, (
                f"row {row} is zero padding: node {node} produces {have} "
                f"unit(s), offset {off} requested"
            )
    else:
        slot, off = divmod(row - w * nu, ru)
        node = pod * w + slot
        have = _relayer_units(plan).get(node, 0)
        if off >= have:
            return False, (
                f"row {row} is zero padding: relayer {node} produces "
                f"{have} unit(s), offset {off} requested"
            )
    return True, ""


def _cross_units_by_pod(plan: RepairPlan) -> dict[int, int]:
    """Cross-rack units each non-target rack ships, from the plan's own
    sends with the same classification rule as ``traffic_blocks``."""
    rack = plan.placement.rack_of
    target_rack = rack(plan.failed)
    want: dict[int, int] = {}
    for s in plan.node_sends:
        if s.dst == TARGET and rack(s.src) != target_rack:
            want[rack(s.src)] = want.get(rack(s.src), 0) + s.units
    for s in plan.relayer_sends:
        if rack(s.src) != target_rack:
            want[rack(s.src)] = want.get(rack(s.src), 0) + s.units
    return want


def _nontarget_steps(spec: Any) -> list[tuple[int, tuple[int, ...]]]:
    return [
        (q, rows) for q, dst, rows in spec.permute_steps()
        if q != spec.target_pod
    ]


# --------------------------------------------------------------------------
# Per-spec rules
# --------------------------------------------------------------------------


@rule(R_LS_PERMUTE, SPMD_FAMILY)
def check_permute_partial(
    code: ErasureCode, plan: RepairPlan, spec: Any
) -> list[Finding]:
    """Declared permute steps form a valid partial permutation."""
    out: list[Finding] = []
    seen_src: set[int] = set()
    for src, dst, rows in spec.permute_steps():
        if src == dst:
            out.append(Finding(
                R_LS_PERMUTE, FAIL,
                f"pod {src} ships {len(rows)} unit(s) to itself — a "
                f"self-send collective-permute delivers nothing",
                {"pod": src, "rows": list(rows)},
            ))
            continue
        if not 0 <= src < spec.r:
            out.append(Finding(
                R_LS_PERMUTE, FAIL,
                f"permute step from pod {src} outside mesh [0, {spec.r})",
                {"pod": src, "r": spec.r},
            ))
        if dst != spec.target_pod:
            out.append(Finding(
                R_LS_PERMUTE, FAIL,
                f"permute step {src}->{dst} does not land on the "
                f"collector pod {spec.target_pod}",
                {"src": src, "dst": dst, "target_pod": spec.target_pod},
            ))
        if src in seen_src:
            out.append(Finding(
                R_LS_PERMUTE, FAIL,
                f"pod {src} appears twice as a permute source — the "
                f"second step would overwrite the first's delivery",
                {"pod": src},
            ))
        seen_src.add(src)
    return out


@rule(R_LS_ROWS, SPMD_FAMILY)
def check_rows_live(
    code: ErasureCode, plan: RepairPlan, spec: Any
) -> list[Finding]:
    """Every scheduled row is in bounds, unique per pod, and live."""
    out: list[Finding] = []
    for q, rows in _nontarget_steps(spec):
        seen: set[int] = set()
        for row in rows:
            if row in seen:
                out.append(Finding(
                    R_LS_ROWS, FAIL,
                    f"pod {q} ships pool row {row} twice",
                    {"pod": q, "row": row},
                ))
                continue
            seen.add(row)
            live, why = _live_row(plan, spec, q, row)
            if not live:
                out.append(Finding(
                    R_LS_ROWS, FAIL, f"pod {q}: {why}",
                    {"pod": q, "row": row},
                ))
    return out


@rule(R_LS_DEAD, SPMD_FAMILY)
def check_dead_device(
    code: ErasureCode, plan: RepairPlan, spec: Any
) -> list[Finding]:
    """The failed device is dead and no device ghost-encodes."""
    out: list[Finding] = []
    node_senders = {s.src for s in plan.node_sends}
    for v in range(spec.n):
        if np.any(spec.node_mats[v]) and v not in node_senders:
            what = "the failed device" if v == plan.failed else f"device {v}"
            out.append(Finding(
                R_LS_DEAD, FAIL,
                f"{what} has a nonzero NodeEncode block but the plan "
                f"routes no send from it — a ghost encode would read "
                f"{'a dead' if v == plan.failed else 'an unscheduled'} "
                f"payload",
                {"device": v, "failed": plan.failed},
            ))
        if spec.ru and np.any(spec.relayer_mats[v]) and v not in set(
            plan.relayers
        ):
            out.append(Finding(
                R_LS_DEAD, FAIL,
                f"device {v} has a nonzero RelayerEncode block but is "
                f"not a plan relayer",
                {"device": v, "relayers": plan.relayers},
            ))
    if sorted(spec.rel_idx.tolist()) != plan.relayers:
        out.append(Finding(
            R_LS_DEAD, FAIL,
            f"spec relayer set {sorted(spec.rel_idx.tolist())} != plan "
            f"relayers {plan.relayers}",
            {"spec": sorted(spec.rel_idx.tolist()), "plan": plan.relayers},
        ))
    return out


@rule(R_LS_GATHER, SPMD_FAMILY)
def check_decode_gather(
    code: ErasureCode, plan: RepairPlan, spec: Any
) -> list[Finding]:
    """The collector's gather indices are consistent with the pool."""
    out: list[Finding] = []
    pool_rows = spec.pool_rows
    received = sum(len(rows) for _, rows in _nontarget_steps(spec))
    hi = pool_rows + received
    if len(spec.target_idx) != spec.decode.shape[1]:
        out.append(Finding(
            R_LS_GATHER, FAIL,
            f"gather order has {len(spec.target_idx)} entries but the "
            f"decode matrix consumes {spec.decode.shape[1]} units",
            {"gather": len(spec.target_idx), "decode": spec.decode.shape[1]},
        ))
    seen_recv: set[int] = set()
    for idx in spec.target_idx:
        if not 0 <= idx < hi:
            out.append(Finding(
                R_LS_GATHER, FAIL,
                f"gather index {idx} out of bounds [0, {hi}) "
                f"(pool {pool_rows} + received {received})",
                {"index": idx, "hi": hi},
            ))
            continue
        if idx >= pool_rows:
            if idx in seen_recv:
                out.append(Finding(
                    R_LS_GATHER, FAIL,
                    f"received unit at row {idx} consumed twice by the "
                    f"decode gather — one shipped unit is lost",
                    {"index": idx},
                ))
            seen_recv.add(idx)
        else:
            live, why = _live_row(plan, spec, spec.target_pod, idx)
            if not live:
                out.append(Finding(
                    R_LS_GATHER, FAIL,
                    f"local gather reference in target pod "
                    f"{spec.target_pod}: {why}",
                    {"index": idx, "target_pod": spec.target_pod},
                ))
    return out


@rule(R_LS_BYTES, SPMD_FAMILY)
def check_byte_accounting(
    code: ErasureCode, plan: RepairPlan, spec: Any
) -> list[Finding]:
    """Per-pod and total scheduled bytes match the plan exactly."""
    out: list[Finding] = []
    t = plan.traffic_blocks()
    want_by_pod = _cross_units_by_pod(plan)
    got_by_pod = {q: len(rows) for q, rows in _nontarget_steps(spec)}
    for q in range(spec.r):
        if q == spec.target_pod:
            continue
        want, got = want_by_pod.get(q, 0), got_by_pod.get(q, 0)
        if want != got:
            out.append(Finding(
                R_LS_BYTES, FAIL,
                f"pod {q} schedules {got} cross unit(s) but the plan "
                f"accounts {want}",
                {"pod": q, "scheduled": got, "planned": want},
            ))
    total_want = round(float(t["cross_rack_blocks"]) * plan.alpha)
    total_got = sum(got_by_pod.values())
    if total_got != total_want:
        out.append(Finding(
            R_LS_BYTES, FAIL,
            f"schedule ships {total_got} cross unit(s) total, plan "
            f"accounts {total_want} (blocks x alpha)",
            {"scheduled": total_got, "planned": total_want},
        ))
    inner_want = round(float(t["inner_rack_blocks"]) * plan.alpha)
    if spec.inner_units != inner_want:
        out.append(Finding(
            R_LS_BYTES, FAIL,
            f"schedule books {spec.inner_units} inner-rack unit(s), plan "
            f"accounts {inner_want}",
            {"scheduled": spec.inner_units, "planned": inner_want},
        ))
    return out


SPEC_RULES = (
    check_permute_partial,
    check_rows_live,
    check_dead_device,
    check_decode_gather,
    check_byte_accounting,
)


def analyze_spmd_spec(
    code: ErasureCode, plan: RepairPlan, spec: Any
) -> list[Finding]:
    """Run every per-spec schedule rule over one lowered plan."""
    findings: list[Finding] = []
    for fn in SPEC_RULES:
        findings.extend(fn(code, plan, spec))
    return findings


# --------------------------------------------------------------------------
# Rotation balance (a property of a *set* of stripe specs)
# --------------------------------------------------------------------------


@rule(R_LS_ROTATION, SPMD_FAMILY)
def check_rotation_balance(
    code: ErasureCode, failed: int, specs: list[Any]
) -> list[Finding]:
    """Relayer duty balanced within one stripe inside each remote pod."""
    out: list[Finding] = []
    if not specs:
        return out
    w = specs[0].w
    loads: dict[int, dict[int, int]] = {}
    for spec in specs:
        for v in spec.rel_idx.tolist():
            pod = int(v) // w
            loads.setdefault(pod, {})
            loads[pod][int(v)] = loads[pod].get(int(v), 0) + 1
    for pod, per in sorted(loads.items()):
        counts = {u: per.get(u, 0) for u in range(pod * w, (pod + 1) * w)}
        lo, hi = min(counts.values()), max(counts.values())
        if hi - lo > 1:
            out.append(Finding(
                R_LS_ROTATION, FAIL,
                f"relayer duty in pod {pod} unbalanced over "
                f"{len(specs)} stripe(s): {counts} (max-min = {hi - lo})",
                {"pod": pod, "loads": {str(u): c for u, c in counts.items()},
                 "stripes": len(specs), "failed": failed},
            ))
    return out


def rotation_specs(code: ErasureCode, failed: int) -> list[Any]:
    """One spec per stripe of a full rotation cycle (S = nodes/rack)."""
    from repro_torch.dist.collectives import plan_to_spmd

    w = code.placement.nodes_per_rack
    return [
        plan_to_spmd(code, code.repair_plan(failed, rotation=s))
        for s in range(w)
    ]


def analyze_rotation(
    code: ErasureCode, failed: int, specs: list[Any]
) -> list[Finding]:
    return check_rotation_balance(code, failed, specs)


# --------------------------------------------------------------------------
# Sweep entry point
# --------------------------------------------------------------------------


def verify_spmd_lowering(
    code: ErasureCode,
    *,
    family: str = SPMD_FAMILY,
    failed_nodes: Iterable[int] | None = None,
) -> list[LoweredRecord]:
    """Lower and analyze every failed node's schedule, plus one
    rotation-balance record covering a full stripe cycle per node."""
    from repro_torch.dist.collectives import plan_to_spmd

    records: list[LoweredRecord] = []
    nodes = list(range(code.n) if failed_nodes is None else failed_nodes)
    for f in nodes:
        try:
            plan = code.repair_plan(f)
            spec = plan_to_spmd(code, plan)
        except Exception as e:  # lowering itself must not blow up
            records.append(LoweredRecord(
                label=repr(code), family=family,
                artifact=f"SpmdRepairSpec(failed={f})",
                findings=[Finding(
                    "lowered.spmd.construction", FAIL,
                    f"plan_to_spmd({f}) raised {type(e).__name__}: {e}", {},
                )],
            ))
            continue
        records.append(LoweredRecord(
            label=repr(code), family=family,
            artifact=f"SpmdRepairSpec(failed={f})",
            findings=analyze_spmd_spec(code, plan, spec),
            info={
                "failed": f,
                "cross_units": spec.cross_units,
                "inner_units": spec.inner_units,
                "permute_steps": len(spec.permute_steps()),
                "rules_checked": len(SPEC_RULES),
            },
        ))
    rot_findings: list[Finding] = []
    rot_info: dict[str, Any] = {"stripes_per_node": {}}
    for f in nodes:
        specs = rotation_specs(code, f)
        rot_findings.extend(analyze_rotation(code, f, specs))
        rot_info["stripes_per_node"][str(f)] = len(specs)
    records.append(LoweredRecord(
        label=repr(code), family=family,
        artifact="rotation-cycle",
        findings=rot_findings, info=rot_info,
    ))
    return records


# --------------------------------------------------------------------------
# Mutations (each caught by exactly its owning rule — see self_test)
# --------------------------------------------------------------------------

SPMD_MUTATIONS: dict[str, str] = {
    "spmd_self_send": R_LS_PERMUTE,
    "spmd_oob_row": R_LS_ROWS,
    "spmd_ghost_failed": R_LS_DEAD,
    "spmd_gather_alias": R_LS_GATHER,
    "spmd_smuggle_unit": R_LS_BYTES,
    "spmd_stuck_rotation": R_LS_ROTATION,
}


def mutate_spmd(
    code: ErasureCode, plan: RepairPlan, spec: Any, mutation: str
) -> Any:
    """Return a deliberately corrupted copy of `spec` (or, for the
    rotation mutation, a corrupted stripe-spec list)."""
    import dataclasses

    if mutation == "spmd_self_send":
        # the target pod schedules a cross ship to itself
        cross = list(spec.cross_idx)
        cross[spec.target_pod] = (0,)
        return dataclasses.replace(spec, cross_idx=tuple(cross))
    if mutation == "spmd_oob_row":
        # one shipped row points past the pod's unit pool
        cross = list(spec.cross_idx)
        for q, rows in _nontarget_steps(spec):
            cross[q] = (spec.pool_rows + 7, *rows[1:])
            return dataclasses.replace(spec, cross_idx=tuple(cross))
        raise ValueError("no non-target pod ships units in this spec")
    if mutation == "spmd_ghost_failed":
        # the failed (dead) device suddenly encodes a unit
        mats = spec.node_mats.copy()
        mats[plan.failed, 0, 0] = 1
        return dataclasses.replace(spec, node_mats=mats)
    if mutation == "spmd_gather_alias":
        # the decode gather consumes one received unit twice
        idx = list(spec.target_idx)
        recv = [i for i, v in enumerate(idx) if v >= spec.pool_rows]
        if len(recv) < 2:
            raise ValueError("fewer than two received units to alias")
        idx[recv[1]] = idx[recv[0]]
        return dataclasses.replace(spec, target_idx=tuple(idx))
    if mutation == "spmd_smuggle_unit":
        # a pod ships one extra *live* unit the plan never routed cross
        units = _node_units(plan)
        cross = list(spec.cross_idx)
        for q, rows in _nontarget_steps(spec):
            scheduled = set(rows)
            for node, have in sorted(units.items()):
                if plan.placement.rack_of(node) != q:
                    continue
                for off in range(have):
                    row = (node % spec.w) * spec.nu + off
                    if row not in scheduled:
                        cross[q] = (*rows, row)
                        return dataclasses.replace(
                            spec, cross_idx=tuple(cross)
                        )
        raise ValueError("every live unit is already scheduled")
    if mutation == "spmd_stuck_rotation":
        # every stripe reuses rotation 0's relayers (no rotation at all)
        from repro_torch.dist.collectives import plan_to_spmd

        w = code.placement.nodes_per_rack
        stuck = plan_to_spmd(code, code.repair_plan(plan.failed, rotation=0))
        return [stuck] * w
    raise ValueError(f"unknown spmd mutation {mutation!r}")


def spmd_mutation_findings(
    code: ErasureCode, plan: RepairPlan, mutated: Any
) -> list[Finding]:
    """Findings of the whole spmd family over a mutated artifact."""
    if isinstance(mutated, list):  # a stripe-spec set (rotation mutation)
        findings = analyze_rotation(code, plan.failed, mutated)
        for spec in mutated:
            findings.extend(analyze_spmd_spec(code, plan, spec))
        return findings
    return analyze_spmd_spec(code, plan, mutated) + analyze_rotation(
        code, plan.failed, [mutated]
    )


__all__ = [
    "R_LS_PERMUTE", "R_LS_ROWS", "R_LS_DEAD", "R_LS_GATHER", "R_LS_BYTES",
    "R_LS_ROTATION", "SPMD_MUTATIONS", "analyze_spmd_spec",
    "analyze_rotation", "rotation_specs", "verify_spmd_lowering",
    "mutate_spmd", "spmd_mutation_findings", "fail_rules",
]
