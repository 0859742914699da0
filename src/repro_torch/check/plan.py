"""Static verification of repair plans against the DoubleR theory.

Every `RepairPlan` is data — explicit GF(256) matrices on an explicit
DAG — so the paper's structural claims (arXiv 1704.03696 §3–§4) can be
checked *without executing a single payload byte*:

* **DAG well-formedness** — every `Send` originates at a surviving node,
  relayer input widths match what rack-mates actually ship, the decode
  matrix has one column per unit reaching the target, and the recorded
  ``target_order`` provenance matches the canonical unit order.
* **Symbolic decodability** — propagating coefficient vectors through
  the DAG, ``decode @ unit_coeffs`` must reproduce the failed node's
  generator rows; additionally the decode matrix must have full rank α
  and no relayer matrix may drop rank the decode needs downstream.
* **Traffic optimality** — the plan's cross-rack blocks must equal the
  family's closed form (Eq. (1)/(2)/(3)); for DRC that closed form *is*
  the lower bound, so any regression in a construction trips this rule.
  Per-relayer cross traffic must be balanced within one unit (Goal 8).
* **Placement invariants** — helpers ship to relayers only within their
  own rack, relayers live outside the target rack, and the plan carries
  the code's own placement (so rack failure tolerance is unchanged).

Each rule is a registered function emitting `Finding`s with a witness;
``verify_plan`` runs the catalog over one plan, ``verify_code`` sweeps
every failed node, and ``run_registry_sweep`` covers every registered
family across ≥ 3 (n, k, r) shapes.  ``self_test`` deliberately corrupts
a known-good plan three ways and asserts each corruption is caught by
the rule that owns it — the CI mutation test.

The port's copy of ``repro.check.plan``: the same rule ids, sweep and
mutations, over ``repro_torch.core`` plans and the
``repro_torch.dist.collectives`` lowering (``spmd.cross_bytes``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable

import numpy as np

from repro_torch.core import gf
from repro_torch.core.code_base import ErasureCode, drc_min_cross_rack_blocks
from repro_torch.core.codes import make_code
from repro_torch.core.codes.stripwise import StripwiseRS
from repro_torch.core.repair import TARGET, RepairPlan, Send, build_target_order

from .errors import PlanError
from .report import FAIL, PASS, WARN, CheckReport, Finding, PlanRecord

# --------------------------------------------------------------------------
# Rule registry
# --------------------------------------------------------------------------

RuleFn = Callable[[ErasureCode, RepairPlan], list[Finding]]

PLAN_RULES: dict[str, RuleFn] = {}

# Rule ids referenced from more than one place.
R_SEND_MATRIX = "plan.dag.send-matrix"
R_SRC_SURVIVING = "plan.dag.src-surviving"
R_DUPLICATE_SEND = "plan.dag.duplicate-send"
R_RELAYER_INPUT = "plan.dag.relayer-input"
R_TARGET_ORDER = "plan.dag.target-order"
R_DECODE_SHAPE = "plan.dag.decode-shape"
R_COEFFICIENTS = "plan.decode.coefficients"
R_DECODE_RANK = "plan.decode.rank"
R_UNIT_RANK = "plan.decode.unit-rank"
R_SEND_RANK = "plan.decode.send-rank"
R_CROSS_BOUND = "plan.traffic.cross-lower-bound"
R_RELAYER_BALANCE = "plan.traffic.relayer-balance"
R_HELPER_RACKS = "plan.placement.helper-racks"
R_TOLERANCE = "plan.placement.tolerance"
R_STRIP_SYSTEMATIC = "code.stripwise.systematic"
R_STRIP_SET_MDS = "code.stripwise.set-mds"
R_STRIP_DISTINCT = "code.stripwise.sets-distinct"
R_SPMD_CROSS = "spmd.cross_bytes"


def rule(rule_id: str) -> Callable[[RuleFn], RuleFn]:
    """Register a plan-verification rule under a stable id."""

    def deco(fn: RuleFn) -> RuleFn:
        if rule_id in PLAN_RULES:
            raise ValueError(f"duplicate rule id {rule_id!r}")
        PLAN_RULES[rule_id] = fn
        return fn

    return deco


def _all_sends(plan: RepairPlan) -> list[tuple[str, Send]]:
    return [("node", s) for s in plan.node_sends] + [
        ("relayer", s) for s in plan.relayer_sends
    ]


# --------------------------------------------------------------------------
# Part 1 — DAG well-formedness
# --------------------------------------------------------------------------


@rule(R_SEND_MATRIX)
def _check_send_matrices(code: ErasureCode, plan: RepairPlan) -> list[Finding]:
    """Every Send matrix is 2-D uint8 with at least one input column."""
    out: list[Finding] = []
    for kind, s in _all_sends(plan):
        m = s.matrix
        if not isinstance(m, np.ndarray) or m.ndim != 2 or m.dtype != np.uint8:
            out.append(Finding(
                R_SEND_MATRIX, FAIL,
                f"{kind} send {s.src}->{s.dst}: matrix must be 2-D uint8",
                {"src": s.src, "dst": s.dst,
                 "shape": getattr(m, "shape", None),
                 "dtype": str(getattr(m, "dtype", type(m).__name__))},
            ))
        elif m.shape[0] == 0 or m.shape[1] == 0:
            out.append(Finding(
                R_SEND_MATRIX, FAIL,
                f"{kind} send {s.src}->{s.dst}: empty matrix {m.shape}",
                {"src": s.src, "dst": s.dst, "shape": m.shape},
            ))
    return out


@rule(R_SRC_SURVIVING)
def _check_src_surviving(code: ErasureCode, plan: RepairPlan) -> list[Finding]:
    """Every edge originates at a surviving node and ends at a legal dst."""
    out: list[Finding] = []
    n = code.n
    relayers = {s.src for s in plan.relayer_sends}
    for kind, s in _all_sends(plan):
        if not (0 <= s.src < n) or s.src == plan.failed:
            out.append(Finding(
                R_SRC_SURVIVING, FAIL,
                f"{kind} send from non-surviving node {s.src} "
                f"(failed={plan.failed}, n={n})",
                {"src": s.src, "dst": s.dst, "failed": plan.failed},
            ))
        if kind == "relayer":
            if s.dst != TARGET:
                out.append(Finding(
                    R_SRC_SURVIVING, FAIL,
                    f"relayer send {s.src}->{s.dst} must go to the target",
                    {"src": s.src, "dst": s.dst},
                ))
        elif s.dst != TARGET:
            if not (0 <= s.dst < n) or s.dst == plan.failed or s.dst == s.src:
                out.append(Finding(
                    R_SRC_SURVIVING, FAIL,
                    f"node send {s.src}->{s.dst}: dst is not a surviving "
                    f"helper or the target",
                    {"src": s.src, "dst": s.dst, "failed": plan.failed},
                ))
            elif s.dst not in relayers:
                out.append(Finding(
                    R_SRC_SURVIVING, FAIL,
                    f"node send {s.src}->{s.dst}: dst never relays "
                    f"(its units are dropped)",
                    {"src": s.src, "dst": s.dst, "relayers": sorted(relayers)},
                ))
    return out


@rule(R_DUPLICATE_SEND)
def _check_duplicate_sends(code: ErasureCode, plan: RepairPlan) -> list[Finding]:
    """At most one Send per (src, dst) edge — duplicates silently alias in
    the coefficient propagation (dict keyed by edge)."""
    out: list[Finding] = []
    seen: set[tuple[int, int]] = set()
    for s in plan.node_sends:
        edge = (s.src, s.dst)
        if edge in seen:
            out.append(Finding(
                R_DUPLICATE_SEND, FAIL,
                f"duplicate node send on edge {s.src}->{s.dst}",
                {"src": s.src, "dst": s.dst},
            ))
        seen.add(edge)
    rseen: set[int] = set()
    for s in plan.relayer_sends:
        if s.src in rseen:
            out.append(Finding(
                R_DUPLICATE_SEND, FAIL,
                f"duplicate relayer send from node {s.src}",
                {"src": s.src},
            ))
        rseen.add(s.src)
    return out


@rule(R_RELAYER_INPUT)
def _check_relayer_inputs(code: ErasureCode, plan: RepairPlan) -> list[Finding]:
    """Matrix input widths match what each sender actually holds/receives:
    node sends consume the sender's α subblocks; a relayer consumes its
    own α subblocks ++ the units its rack-mates shipped to it."""
    out: list[Finding] = []
    alpha = plan.alpha
    for s in plan.node_sends:
        if s.matrix.ndim == 2 and s.matrix.shape[1] != alpha:
            out.append(Finding(
                R_RELAYER_INPUT, FAIL,
                f"node send {s.src}->{s.dst}: input dim {s.matrix.shape[1]} "
                f"!= alpha={alpha}",
                {"src": s.src, "dst": s.dst, "got": s.matrix.shape[1],
                 "want": alpha},
            ))
    for s in plan.relayer_sends:
        received = sum(x.units for x in plan.node_sends if x.dst == s.src)
        want = alpha + received
        if s.matrix.ndim == 2 and s.matrix.shape[1] != want:
            out.append(Finding(
                R_RELAYER_INPUT, FAIL,
                f"relayer {s.src}: input dim {s.matrix.shape[1]} != "
                f"alpha + received = {alpha} + {received}",
                {"relayer": s.src, "got": s.matrix.shape[1], "want": want},
            ))
    return out


@rule(R_TARGET_ORDER)
def _check_target_order(code: ErasureCode, plan: RepairPlan) -> list[Finding]:
    """Recorded unit provenance must match the canonical target order."""
    want = build_target_order(plan.node_sends, plan.relayer_sends)
    if plan.target_order != want:
        return [Finding(
            R_TARGET_ORDER, FAIL,
            "target_order does not match canonical unit order "
            "(sends to target sorted by src, then relayers by src)",
            {"recorded": list(plan.target_order), "canonical": want},
        )]
    return []


@rule(R_DECODE_SHAPE)
def _check_decode_shape(code: ErasureCode, plan: RepairPlan) -> list[Finding]:
    """decode is (α, total units reaching the target), 2-D uint8."""
    d = plan.decode
    if not isinstance(d, np.ndarray) or d.ndim != 2 or d.dtype != np.uint8:
        return [Finding(
            R_DECODE_SHAPE, FAIL,
            "decode matrix must be a 2-D uint8 ndarray",
            {"shape": getattr(d, "shape", None),
             "dtype": str(getattr(d, "dtype", type(d).__name__))},
        )]
    total_units = sum(
        s.units for s in plan.node_sends if s.dst == TARGET
    ) + sum(s.units for s in plan.relayer_sends)
    want = (plan.alpha, total_units)
    if d.shape != want:
        return [Finding(
            R_DECODE_SHAPE, FAIL,
            f"decode shape {d.shape} != (alpha, total units at target) "
            f"= {want}",
            {"got": d.shape, "want": want},
        )]
    return []


# --------------------------------------------------------------------------
# Part 2 — symbolic decodability
# --------------------------------------------------------------------------


def _unit_coeffs(code: ErasureCode, plan: RepairPlan) -> np.ndarray | Finding:
    """Coefficient rows of every unit reaching the target, or a Finding
    classifying why they cannot be derived (PlanError from the plan)."""
    try:
        return plan._target_unit_coeffs(code.all_node_coeffs())
    except PlanError as e:
        return Finding(e.rule or R_TARGET_ORDER, FAIL, str(e), dict(e.context))
    except (ValueError, IndexError, KeyError) as e:
        return Finding(
            R_COEFFICIENTS, FAIL,
            f"coefficient propagation failed: {type(e).__name__}: {e}", {},
        )


@rule(R_COEFFICIENTS)
def _check_coefficients(code: ErasureCode, plan: RepairPlan) -> list[Finding]:
    """decode @ unit_coeffs must equal the failed node's generator rows."""
    uc = _unit_coeffs(code, plan)
    if isinstance(uc, Finding):
        return [uc]
    if plan.decode.ndim != 2 or plan.decode.shape[1] != uc.shape[0]:
        return []  # shape defect already owned by plan.dag.decode-shape
    got = gf.gf_matmul(plan.decode, uc)
    want = code.node_coeffs(plan.failed)
    if not np.array_equal(got, want):
        bad = sorted(np.nonzero(np.any(got != want, axis=1))[0].tolist())
        return [Finding(
            R_COEFFICIENTS, FAIL,
            f"decode does not reproduce node {plan.failed}'s generator rows "
            f"(subblocks {bad} differ)",
            {"failed": plan.failed, "bad_subblocks": bad},
        )]
    return []


@rule(R_DECODE_RANK)
def _check_decode_rank(code: ErasureCode, plan: RepairPlan) -> list[Finding]:
    """The decode matrix must have full rank α (no dead output row)."""
    if plan.decode.ndim != 2:
        return []
    rank = gf.gf_rank(plan.decode)
    if rank < plan.alpha:
        return [Finding(
            R_DECODE_RANK, FAIL,
            f"decode matrix rank {rank} < alpha = {plan.alpha}",
            {"rank": rank, "alpha": plan.alpha},
        )]
    return []


@rule(R_UNIT_RANK)
def _check_unit_rank(code: ErasureCode, plan: RepairPlan) -> list[Finding]:
    """The units reaching the target must span the failed node's rows —
    i.e. no relayer matrix dropped rank the decode needs downstream."""
    uc = _unit_coeffs(code, plan)
    if isinstance(uc, Finding):
        return []  # already reported by plan.decode.coefficients
    g_f = code.node_coeffs(plan.failed)
    base = gf.gf_rank(uc)
    joint = gf.gf_rank(np.concatenate([uc, g_f], axis=0))
    if joint > base:
        return [Finding(
            R_UNIT_RANK, FAIL,
            f"target units span rank {base} but need {joint} to cover "
            f"node {plan.failed}'s rows — a relayer/node matrix dropped "
            f"needed rank",
            {"unit_rank": base, "needed_rank": joint, "failed": plan.failed},
        )]
    return []


@rule(R_SEND_RANK)
def _check_send_rank(code: ErasureCode, plan: RepairPlan) -> list[Finding]:
    """Row-deficient send matrices ship redundant units (wasted traffic)."""
    out: list[Finding] = []
    for kind, s in _all_sends(plan):
        if s.matrix.ndim != 2 or 0 in s.matrix.shape:
            continue
        rank = gf.gf_rank(s.matrix)
        if rank < s.units:
            out.append(Finding(
                R_SEND_RANK, WARN,
                f"{kind} send {s.src}->{s.dst} ships {s.units} units but "
                f"only rank {rank} — redundant traffic",
                {"src": s.src, "dst": s.dst, "units": s.units, "rank": rank},
            ))
    return out


# --------------------------------------------------------------------------
# Part 3 — traffic optimality
# --------------------------------------------------------------------------


@rule(R_CROSS_BOUND)
def _check_cross_bound(code: ErasureCode, plan: RepairPlan) -> list[Finding]:
    """Cross-rack blocks equal the family closed form; for DRC that is
    the Eq. (3) lower bound, so exceeding it breaks the paper's claim."""
    try:
        expected = code.theoretical_cross_rack_blocks()
    except NotImplementedError:
        return []
    t = plan.traffic_blocks()
    cross = float(t["cross_rack_blocks"])
    is_drc = isinstance(code, StripwiseRS)
    if is_drc:
        bound = drc_min_cross_rack_blocks(code.n, code.k, code.r)
        if abs(expected - bound) > 1e-9:
            return [Finding(
                R_CROSS_BOUND, FAIL,
                f"DRC closed form {expected} != Eq.(3) lower bound {bound}",
                {"closed_form": expected, "lower_bound": bound},
            )]
    if abs(cross - expected) > 1e-9:
        sev = FAIL if is_drc or cross > expected + 1e-9 else WARN
        return [Finding(
            R_CROSS_BOUND, sev,
            f"cross-rack traffic {cross} blocks != closed form "
            f"{expected} blocks for {code!r} (failed={plan.failed})",
            {"measured": cross, "expected": expected, "failed": plan.failed},
        )]
    return []


@rule(R_RELAYER_BALANCE)
def _check_relayer_balance(code: ErasureCode, plan: RepairPlan) -> list[Finding]:
    """Per-relayer cross-rack traffic balanced within one unit (Goal 8)."""
    t = plan.traffic_blocks()
    per = t["per_relayer_cross"]
    if not isinstance(per, dict) or len(per) < 2:
        return []
    units = {v: blocks * plan.alpha for v, blocks in per.items()}
    lo_v = min(units, key=lambda v: units[v])
    hi_v = max(units, key=lambda v: units[v])
    if units[hi_v] - units[lo_v] > 1.0 + 1e-9:
        return [Finding(
            R_RELAYER_BALANCE, FAIL,
            f"relayer cross traffic unbalanced: node {hi_v} ships "
            f"{units[hi_v]:g} units vs node {lo_v} {units[lo_v]:g}",
            {"per_relayer_units": {str(v): u for v, u in units.items()}},
        )]
    return []


@rule(R_SPMD_CROSS)
def _check_spmd_cross_bytes(code: ErasureCode, plan: RepairPlan) -> list[Finding]:
    """The static SPMD collective schedule (repro_torch.dist.collectives) must
    ship exactly the plan's cross-rack units — and, where the family has
    a closed form, exactly that many: a lowering that silently adds or
    drops cross-pod collective-permute traffic breaks the executed
    version of the Eq. (3) claim even if the plan itself is optimal."""
    from repro_torch.dist.collectives import expected_cross_units, plan_to_spmd

    try:
        spec = plan_to_spmd(code, plan)
    except Exception as e:  # a malformed plan must fail loudly, not lower
        return [Finding(
            R_SPMD_CROSS, FAIL,
            f"plan_to_spmd raised {type(e).__name__}: {e}",
            {"failed": plan.failed},
        )]
    out: list[Finding] = []
    scheduled = spec.cross_units
    planned = expected_cross_units(plan)
    if scheduled != planned:
        out.append(Finding(
            R_SPMD_CROSS, FAIL,
            f"SPMD schedule ships {scheduled} cross-pod units but the "
            f"plan accounts {planned} (blocks * alpha)",
            {"scheduled": scheduled, "planned": planned,
             "failed": plan.failed},
        ))
    try:
        closed = code.theoretical_cross_rack_blocks()
    except NotImplementedError:
        closed = None
    if closed is not None:
        want = round(closed * plan.alpha)
        if scheduled != want:
            out.append(Finding(
                R_SPMD_CROSS, FAIL,
                f"SPMD schedule ships {scheduled} cross-pod units != "
                f"family closed form {want} ({closed} blocks * alpha)",
                {"scheduled": scheduled, "closed_form_units": want,
                 "failed": plan.failed},
            ))
    return out


# --------------------------------------------------------------------------
# Part 4 — placement invariants
# --------------------------------------------------------------------------


@rule(R_HELPER_RACKS)
def _check_helper_racks(code: ErasureCode, plan: RepairPlan) -> list[Finding]:
    """Helpers aggregate within their own rack: a send to a relayer must
    stay inner-rack, and relayers live outside the target's rack."""
    out: list[Finding] = []
    pl = plan.placement
    try:
        target_rack = pl.rack_of(plan.failed)
    except ValueError:
        return []  # failed id out of range: owned by placement.tolerance
    for s in plan.node_sends:
        if s.dst == TARGET:
            continue
        if not (0 <= s.src < pl.n and 0 <= s.dst < pl.n):
            continue  # owned by plan.dag.src-surviving
        if pl.rack_of(s.src) != pl.rack_of(s.dst):
            out.append(Finding(
                R_HELPER_RACKS, FAIL,
                f"node {s.src} (rack {pl.rack_of(s.src)}) ships to relayer "
                f"{s.dst} (rack {pl.rack_of(s.dst)}) across racks — "
                f"aggregation must be inner-rack",
                {"src": s.src, "dst": s.dst,
                 "src_rack": pl.rack_of(s.src), "dst_rack": pl.rack_of(s.dst)},
            ))
    for s in plan.relayer_sends:
        if 0 <= s.src < pl.n and pl.rack_of(s.src) == target_rack:
            out.append(Finding(
                R_HELPER_RACKS, FAIL,
                f"relayer {s.src} sits in the target rack {target_rack} — "
                f"relayers exist to cross the gateway once",
                {"relayer": s.src, "target_rack": target_rack},
            ))
    return out


@rule(R_TOLERANCE)
def _check_tolerance(code: ErasureCode, plan: RepairPlan) -> list[Finding]:
    """The plan must carry the code's own placement: same (n, r), same α,
    hence the same rack failure tolerance — a repair never degrades it."""
    out: list[Finding] = []
    if plan.placement != code.placement:
        out.append(Finding(
            R_TOLERANCE, FAIL,
            f"plan placement (n={plan.placement.n}, r={plan.placement.r}) "
            f"!= code placement (n={code.placement.n}, r={code.placement.r})",
            {"plan": (plan.placement.n, plan.placement.r),
             "code": (code.placement.n, code.placement.r)},
        ))
    else:
        m = code.n - code.k
        before = code.placement.rack_failure_tolerance(m)
        after = plan.placement.rack_failure_tolerance(m)
        if after != before:
            out.append(Finding(
                R_TOLERANCE, FAIL,
                f"rack failure tolerance changed by plan: {before} -> {after}",
                {"before": before, "after": after},
            ))
    if plan.alpha != code.alpha:
        out.append(Finding(
            R_TOLERANCE, FAIL,
            f"plan alpha {plan.alpha} != code alpha {code.alpha}",
            {"plan_alpha": plan.alpha, "code_alpha": code.alpha},
        ))
    if not (0 <= plan.failed < code.n):
        out.append(Finding(
            R_TOLERANCE, FAIL,
            f"failed node {plan.failed} out of range for n={code.n}",
            {"failed": plan.failed, "n": code.n},
        ))
    return out


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------


def verify_plan(code: ErasureCode, plan: RepairPlan) -> list[Finding]:
    """Run the full rule catalog over one plan.  Pure/static: no payloads."""
    findings: list[Finding] = []
    for fn in PLAN_RULES.values():
        findings.extend(fn(code, plan))
    return findings


def verify_code(
    code: ErasureCode,
    *,
    family: str = "",
    failed_nodes: Iterable[int] | None = None,
) -> list[PlanRecord]:
    """Verify the repair plan of every failed node of one code."""
    records: list[PlanRecord] = []
    nodes = range(code.n) if failed_nodes is None else failed_nodes
    for f in nodes:
        try:
            plan = code.repair_plan(f)
        except Exception as e:  # constructions may reject a node outright
            records.append(PlanRecord(
                label=repr(code), family=family or code.name,
                n=code.n, k=code.k, r=code.r, failed=f,
                findings=[Finding(
                    "plan.construction", FAIL,
                    f"repair_plan({f}) raised {type(e).__name__}: {e}", {},
                )],
            ))
            continue
        findings = verify_plan(code, plan)
        t = plan.traffic_blocks()
        records.append(PlanRecord(
            label=repr(code), family=family or code.name,
            n=code.n, k=code.k, r=code.r, failed=f,
            findings=findings,
            info={
                "cross_rack_blocks": t["cross_rack_blocks"],
                "inner_rack_blocks": t["inner_rack_blocks"],
                "relayers": plan.relayers,
                "rules_checked": len(PLAN_RULES),
            },
        ))
    return records


# ---------------------------------------------------------- stripwise layer


def verify_stripwise(code: StripwiseRS, *, family: str = "stripwise") -> PlanRecord:
    """Structural checks on the shared strip-wise generator layer: each
    per-set generator is systematic and MDS, and the sets are pairwise
    distinct (geometric independence the Family-1 alignment relies on)."""
    import itertools

    findings: list[Finding] = []
    n, k = code.n, code.k
    sets = getattr(code, "set_gens", None)
    if not sets:
        findings.append(Finding(
            R_STRIP_SYSTEMATIC, FAIL,
            "stripwise code has no per-set generators", {},
        ))
        sets = []
    for t, gt in enumerate(sets):
        if not np.array_equal(gt[:k], np.eye(k, dtype=np.uint8)):
            findings.append(Finding(
                R_STRIP_SYSTEMATIC, FAIL,
                f"set {t} generator is not systematic", {"set": t},
            ))
        for combo in itertools.combinations(range(n), k):
            if gf.gf_rank(gt[list(combo)]) != k:
                findings.append(Finding(
                    R_STRIP_SET_MDS, FAIL,
                    f"set {t} generator not MDS: rows {combo} rank-deficient",
                    {"set": t, "rows": list(combo)},
                ))
                break
    for a, b in itertools.combinations(range(len(sets)), 2):
        if np.array_equal(sets[a][k:], sets[b][k:]):
            findings.append(Finding(
                R_STRIP_DISTINCT, FAIL,
                f"sets {a} and {b} share identical parity geometry — "
                f"interference alignment degenerates",
                {"sets": [a, b]},
            ))
    return PlanRecord(
        label=repr(code), family=family, n=n, k=k, r=code.r, failed=None,
        findings=findings, info={"alpha": code.alpha, "sets": len(sets)},
    )


# ---------------------------------------------------------- SPMD lowering


def verify_spmd(code: ErasureCode, *, family: str = "spmd") -> PlanRecord:
    """Lower every failed node's plan through ``plan_to_spmd`` and check
    the static collective schedule (rule ``spmd.cross_bytes``): one
    record per code summarizing scheduled cross-pod units per node."""
    from repro_torch.dist.collectives import plan_to_spmd

    findings: list[Finding] = []
    cross_by_node: dict[str, int] = {}
    for f in range(code.n):
        plan = code.repair_plan(f)
        findings.extend(_check_spmd_cross_bytes(code, plan))
        try:
            cross_by_node[str(f)] = plan_to_spmd(code, plan).cross_units
        except Exception:
            cross_by_node[str(f)] = -1  # the rule above reported it
    return PlanRecord(
        label=repr(code), family=family, n=code.n, k=code.k, r=code.r,
        failed=None, findings=findings,
        info={"alpha": code.alpha, "cross_units_by_node": cross_by_node},
    )


# --------------------------------------------------------------- the sweep

# Every registered family × ≥ 3 (n, k, r) shapes.  "stripwise" rows check
# the shared generator layer both DRC families build on; "spmd" rows
# check the repro_torch.dist.collectives lowering of DRC-f1 / DRC-f2 / RS.
# Every family carries a fourth shape exercising r > 3 placements
# (more racks than the minimal layering), so rack-count generalization
# is swept, not just the paper's 3-rack walkthroughs.  DRC-f2 is the
# structural exception — its construction (k = 2n/3 - 1) fixes r = 3,
# so its fourth shape scales n instead.
REGISTRY_SWEEP: dict[str, list[tuple[str, int, int, int]]] = {
    "DRC-f1": [
        ("DRC", 6, 4, 3), ("DRC", 8, 6, 4), ("DRC", 9, 6, 3),
        ("DRC", 12, 9, 4),
    ],
    "DRC-f2": [
        ("DRC", 6, 3, 3), ("DRC", 9, 5, 3), ("DRC", 12, 7, 3),
        ("DRC", 15, 9, 3),
    ],
    "RS": [
        ("RS", 6, 4, 6), ("RS", 8, 6, 4), ("RS", 9, 6, 3),
        ("RS", 8, 4, 4),
    ],
    "MSR-Clay": [
        ("MSR", 6, 4, 6), ("MSR", 6, 3, 3), ("MSR", 8, 6, 4),
        ("MSR", 8, 4, 4),
    ],
    "stripwise": [
        ("DRC", 6, 4, 3), ("DRC", 9, 6, 3), ("DRC", 9, 5, 3),
        ("DRC", 12, 9, 4),
    ],
    "spmd": [
        ("DRC", 9, 6, 3), ("DRC", 9, 5, 3), ("RS", 9, 6, 3),
        ("DRC", 8, 6, 4),
    ],
}


def run_registry_sweep(
    sweep: dict[str, list[tuple[str, int, int, int]]] | None = None,
) -> list[PlanRecord]:
    """Statically verify every registered code family across the sweep."""
    sweep = REGISTRY_SWEEP if sweep is None else sweep
    cache: dict[tuple[str, int, int, int], ErasureCode] = {}
    records: list[PlanRecord] = []
    for family, shapes in sweep.items():
        for cfg in shapes:
            fam, n, k, r = cfg
            code = cache.get(cfg)
            if code is None:
                code = cache[cfg] = make_code(fam, n, k, r)
            if family == "stripwise":
                assert isinstance(code, StripwiseRS)
                records.append(verify_stripwise(code, family=family))
            elif family == "spmd":
                records.append(verify_spmd(code, family=family))
            else:
                records.extend(verify_code(code, family=family))
    return records


def sweep_report(
    sweep: dict[str, list[tuple[str, int, int, int]]] | None = None,
) -> CheckReport:
    return CheckReport(plan_records=run_registry_sweep(sweep))


# --------------------------------------------------------- mutation testing

MUTATIONS: dict[str, str] = {
    # mutation name -> rule id that must catch it
    "swap_sends": R_COEFFICIENTS,
    "zero_decode_row": R_DECODE_RANK,
    "off_by_one_target_order": R_TARGET_ORDER,
    "drop_relayer_rank": R_UNIT_RANK,
    "cross_rack_helper": R_HELPER_RACKS,
    "wrong_placement": R_TOLERANCE,
    "inflate_cross_unit": R_SPMD_CROSS,
}


def mutate_plan(plan: RepairPlan, mutation: str) -> RepairPlan:
    """Return a *copy* of `plan` with one deliberate defect injected."""
    if mutation == "swap_sends":
        # swap the matrices of two node sends with equal shapes but
        # different sources — decodability breaks, the DAG stays legal.
        sends = list(plan.node_sends)
        for i in range(len(sends)):
            for j in range(i + 1, len(sends)):
                a, b = sends[i], sends[j]
                if (a.matrix.shape == b.matrix.shape
                        and not np.array_equal(a.matrix, b.matrix)):
                    sends[i] = Send(a.src, a.dst, b.matrix.copy())
                    sends[j] = Send(b.src, b.dst, a.matrix.copy())
                    return dataclasses.replace(plan, node_sends=sends)
        raise ValueError("no swappable send pair in plan")
    if mutation == "zero_decode_row":
        d = plan.decode.copy()
        d[0, :] = 0
        return dataclasses.replace(plan, decode=d)
    if mutation == "off_by_one_target_order":
        order = list(plan.target_order)
        order[0] += 1
        return dataclasses.replace(plan, target_order=order)
    if mutation == "drop_relayer_rank":
        # zero one relayer matrix: its units carry no information, so the
        # surviving units cannot span the failed node's rows any more.
        sends = list(plan.relayer_sends)
        if not sends:
            raise ValueError("plan has no relayer sends")
        s = sends[0]
        sends[0] = Send(s.src, s.dst, np.zeros_like(s.matrix))
        return dataclasses.replace(plan, relayer_sends=sends)
    if mutation == "cross_rack_helper":
        # reroute one helper's units to a relayer in another rack
        sends = list(plan.node_sends)
        relayers = [s.src for s in plan.relayer_sends]
        pl = plan.placement
        for i, s in enumerate(sends):
            if s.dst == TARGET:
                continue
            for v in relayers:
                if pl.rack_of(v) != pl.rack_of(s.src):
                    sends[i] = Send(s.src, v, s.matrix.copy())
                    return dataclasses.replace(plan, node_sends=sends)
        raise ValueError("no reroutable helper send in plan")
    if mutation == "wrong_placement":
        from repro_torch.core.placement import Placement

        flat = Placement(plan.placement.n, plan.placement.n)
        return dataclasses.replace(plan, placement=flat)
    if mutation == "inflate_cross_unit":
        # one relayer ships a redundant extra unit: the plan *and* the
        # SPMD schedule both inflate consistently, so only the closed-
        # form comparison in spmd.cross_bytes pins the regression.
        sends = list(plan.relayer_sends)
        if not sends:
            raise ValueError("plan has no relayer sends")
        s = sends[0]
        sends[0] = Send(s.src, s.dst, np.vstack([s.matrix, s.matrix[:1]]))
        return dataclasses.replace(plan, relayer_sends=sends)
    raise ValueError(f"unknown mutation {mutation!r}")


def self_test(
    cfg: tuple[str, int, int, int] = ("DRC", 6, 4, 3),
    mutations: Iterable[str] | None = None,
) -> list[tuple[str, str, bool]]:
    """Corrupt a known-good plan and assert each defect is caught by the
    rule that owns it.  Returns [(mutation, owning_rule, caught)].

    This is the CI mutation test: a verifier that passes everything is
    worthless, so the gate requires every row here to be ``caught``.
    """
    fam, n, k, r = cfg
    code = make_code(fam, n, k, r)
    base = code.repair_plan(0)
    if any(f.severity == FAIL for f in verify_plan(code, base)):
        raise AssertionError("baseline plan must verify clean before mutating")
    results: list[tuple[str, str, bool]] = []
    for mutation in (MUTATIONS if mutations is None else mutations):
        owner = MUTATIONS[mutation]
        mutated = mutate_plan(base, mutation)
        findings = verify_plan(code, mutated)
        caught = any(f.rule == owner and f.severity == FAIL for f in findings)
        results.append((mutation, owner, caught))
    return results
