"""Collective conformance: the traced sends and receives against the schedule.

The port's counterpart of ``repro.check.traced.collectives``.  The lowered
layer (``check/lowered/spmd.py``) proves properties of the *declared*
``SpmdRepairSpec``; these rules prove the *traced program* — the body of
``dist.collectives.make_mesh_repair`` as every rank of the ``(pod, node)``
mesh dispatched it — implements exactly that declaration and nothing else:

* ``traced.coll.pairing`` — every point-to-point op is well formed: its
  peer lies in ``[0, r·w)`` and is not its own rank, and each (source,
  destination) rank pair is sent, and received, at most once.
* ``traced.coll.permute-match`` — the sends, summed in rows per (source pod,
  destination pod) across pods, and the spec's ``permute_steps()`` whose
  source is not the destination match 1:1 (same pod pair, same rows): no
  orphan send the plan never scheduled, no scheduled step the program
  dropped.  Every send has a receive of the same (source, destination) rank
  pair on its peer and every receive a send, paired by rank and not by size.
* ``traced.coll.axis-scope`` — DoubleR's layering discipline as a mesh
  property: every all-gather and reduction runs over a group inside one pod,
  and a point-to-point op crosses pods only into the collector, rank
  ``(target_pod, 0)``.
* ``traced.coll.cross-bytes`` — the bytes the collector receives from other
  pods, read off the trace, equal ``plan.traffic_blocks()`` (``round(
  cross_rack_blocks·alpha)·sub``) and, for DRC, the Eq. (3) closed form:
  the paper's bound as a property of the program the ranks run.  This takes
  the place of the reference's compiled-HLO byte count.

The matcher (:func:`validate_p2p`, :func:`match_sends`) is pure data → data
so hypothesis can drive it over random shapes.  The rules read the program's
``footprint`` only, which the mutations corrupt.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from ..report import FAIL, Finding
from .base import COLL_FAMILY, as_witness, rule
from .capture import REPAIR, GroupOp, P2POp, TracedProgram

R_TC_PAIRING = "traced.coll.pairing"
R_TC_MATCH = "traced.coll.permute-match"
R_TC_AXIS = "traced.coll.axis-scope"
R_TC_BYTES = "traced.coll.cross-bytes"

Step = tuple[int, int, tuple[int, ...]]  # (src_pod, dst_pod, pool rows)


# ------------------------------------------------------------ pure matcher
def validate_p2p(sends: tuple[P2POp, ...], recvs: tuple[P2POp, ...],
                 world: int) -> list[str]:
    """Well-formedness defects of a program's sends and receives."""
    defects: list[str] = []
    for kind, ops in (("send", sends), ("recv", recvs)):
        pairs = []
        for p in ops:
            if not 0 <= p.peer < world:
                defects.append(f"{kind} on rank {p.rank}: peer {p.peer} outside [0, {world})")
            elif p.peer == p.rank:
                defects.append(f"self-{kind} on rank {p.rank}: bytes cross nothing")
            pairs.append((p.rank, p.peer) if kind == "send" else (p.peer, p.rank))
        for pair in sorted({pr for pr in pairs if pairs.count(pr) > 1}):
            defects.append(f"{kind}s of rank pair {pair} repeated {pairs.count(pair)} times")
    return defects


@dataclasses.dataclass(frozen=True)
class SendMatch:
    """1:1 matching between the traced sends (per pod pair) and the declared
    steps, and the point-to-point ops without a partner."""

    matched: tuple[tuple[tuple[int, int], int], ...]  # ((src pod, dst pod), step index)
    orphan_sends: tuple[tuple[int, int, int], ...]  # (src pod, dst pod, rows), never declared
    orphan_steps: tuple[int, ...]  # declared but never traced
    unpaired: tuple[tuple[str, int, int], ...]  # (kind, rank, peer) with no partner

    @property
    def complete(self) -> bool:
        return not (self.orphan_sends or self.orphan_steps or self.unpaired)


def match_sends(sends: tuple[P2POp, ...], recvs: tuple[P2POp, ...],
                steps: tuple[Step, ...], w: int) -> SendMatch:
    """Match the sends, summed in rows per (source pod, destination pod),
    to the declared steps whose source is not the destination, and pair each
    send with a receive by (source, destination) rank."""
    rows: dict[tuple[int, int], int] = {}
    for p in sends:
        pods = (p.rank // w, p.peer // w)
        if pods[0] != pods[1]:
            rows[pods] = rows.get(pods, 0) + p.rows
    free = {i: s for i, s in enumerate(steps) if s[0] != s[1]}
    matched, orphans = [], []
    for pods, n in sorted(rows.items()):
        hit = next((i for i, (src, dst, r) in free.items()
                    if (src, dst) == pods and len(r) == n), None)
        if hit is None:
            orphans.append((*pods, n))
        else:
            del free[hit]
            matched.append((pods, hit))
    sent = [(p.rank, p.peer) for p in sends]
    got = [(p.peer, p.rank) for p in recvs]
    unpaired = [("send", *pr) for pr in sent if pr not in got]
    unpaired += [("recv", pr[1], pr[0]) for pr in got if pr not in sent]
    return SendMatch(matched=tuple(matched), orphan_sends=tuple(orphans),
                     orphan_steps=tuple(sorted(free)), unpaired=tuple(unpaired))


def cross_pod_recv_bytes(recvs: tuple[P2POp, ...], collector: int, w: int) -> int:
    """Bytes the collector receives from ranks of other pods."""
    return sum(p.nbytes for p in recvs
               if p.rank == collector and p.peer // w != collector // w)


def _repair_meta(program: TracedProgram) -> Any | None:
    if program.kind != REPAIR:
        return None
    return program.meta.get("spec")


def _collector(spec: Any) -> int:
    return spec.target_pod * spec.w


# ------------------------------------------------------------------- rules
@rule(R_TC_PAIRING, COLL_FAMILY)
def check_pairing(program: TracedProgram) -> list[Finding]:
    """Every traced send and receive has a peer in the world other than its
    own rank, and no rank pair repeats."""
    spec = _repair_meta(program)
    if spec is None:
        return []
    fp = program.footprint
    world = spec.r * spec.w
    return [
        Finding(R_TC_PAIRING, FAIL, f"{program.name}: point-to-point malformed — {defect}",
                as_witness(program=program.name, defect=defect, world=world))
        for defect in validate_p2p(fp.sends, fp.recvs, world)
    ]


@rule(R_TC_MATCH, COLL_FAMILY)
def check_permute_match(program: TracedProgram) -> list[Finding]:
    """Traced sends (per pod pair) and declared schedule steps match 1:1,
    and every send has its receive."""
    spec = _repair_meta(program)
    if spec is None:
        return []
    fp = program.footprint
    if validate_p2p(fp.sends, fp.recvs, spec.r * spec.w):
        return []  # malformed pairing: traced.coll.pairing owns that
    steps = spec.permute_steps()
    m = match_sends(fp.sends, fp.recvs, steps, spec.w)
    out: list[Finding] = []
    for src, dst, rows in m.orphan_sends:
        out.append(Finding(
            R_TC_MATCH, FAIL,
            f"{program.name}: pod {src} sends pod {dst} {rows} row(s), which no "
            f"declared schedule step ships — bytes move that the plan never scheduled",
            as_witness(program=program.name, src=src, dst=dst, rows=rows),
        ))
    for si in m.orphan_steps:
        src, dst, rows = steps[si]
        out.append(Finding(
            R_TC_MATCH, FAIL,
            f"{program.name}: declared step #{si} (pod {src} -> {dst}, {len(rows)} "
            f"row(s)) has no traced send — a scheduled cross-rack ship was dropped",
            as_witness(program=program.name, step=si, src=src, dst=dst, rows=len(rows)),
        ))
    for kind, rank, peer in m.unpaired:
        out.append(Finding(
            R_TC_MATCH, FAIL,
            f"{program.name}: {kind} on rank {rank} (peer {peer}) has no matching "
            f"{'recv' if kind == 'send' else 'send'} — the ranks would deadlock",
            as_witness(program=program.name, kind=kind, rank=rank, peer=peer),
        ))
    return out


@rule(R_TC_AXIS, COLL_FAMILY)
def check_axis_scope(program: TracedProgram) -> list[Finding]:
    """Gathers and reductions stay inside a pod; only point-to-point ops
    cross pods, and only into the collector."""
    spec = _repair_meta(program)
    if spec is None:
        return []
    w, collector = spec.w, _collector(spec)
    fp = program.footprint
    out: list[Finding] = []
    groups: list[tuple[str, GroupOp]] = [("all_gather", g) for g in fp.gathers]
    groups += [("reduce", g) for g in fp.reduces]
    for kind, g in groups:
        pods = sorted({rank // w for rank in g.group})
        if len(pods) != 1:
            out.append(Finding(
                R_TC_AXIS, FAIL,
                f"{program.name}: {kind} `{g.name}` on rank {g.rank} runs over ranks "
                f"{list(g.group)} of pods {pods} — intra-rack aggregation must never "
                f"cross a pod boundary",
                as_witness(program=program.name, op=g.name, rank=g.rank,
                           group=list(g.group), pods=pods),
            ))
    p2p = [(p.rank, p.peer) for p in fp.sends] + [(p.peer, p.rank) for p in fp.recvs]
    for src, dst in p2p:
        if src // w != dst // w and dst != collector:
            out.append(Finding(
                R_TC_AXIS, FAIL,
                f"{program.name}: rank {src} ships to rank {dst} across pods, not to the "
                f"collector (rank {collector}) — cross-rack bytes go to the collector only",
                as_witness(program=program.name, src=src, dst=dst, collector=collector),
            ))
    return out


@rule(R_TC_BYTES, COLL_FAMILY)
def check_cross_bytes(program: TracedProgram) -> list[Finding]:
    """Bytes received across pods == plan bytes == Eq. (3)."""
    spec = _repair_meta(program)
    if spec is None:
        return []
    plan = program.meta["plan"]
    code = program.meta["code"]
    sub = int(program.meta["sub_bytes"])
    got = cross_pod_recv_bytes(program.footprint.recvs, _collector(spec), spec.w)
    blocks = float(plan.traffic_blocks()["cross_rack_blocks"])
    plan_bytes = round(blocks * plan.alpha) * sub
    if got != plan_bytes:
        return [Finding(
            R_TC_BYTES, FAIL,
            f"{program.name}: the collector receives {got} cross-pod byte(s) but the "
            f"plan accounts {plan_bytes} ({blocks:g} blocks x alpha={plan.alpha} x "
            f"sub={sub})",
            as_witness(program=program.name, traced_bytes=got, plan_bytes=plan_bytes,
                       blocks=blocks, sub=sub),
        )]
    try:
        bound = float(code.theoretical_cross_rack_blocks())
    except NotImplementedError:
        return []
    bound_bytes = round(bound * plan.alpha) * sub
    if got != bound_bytes:
        return [Finding(
            R_TC_BYTES, FAIL,
            f"{program.name}: the collector receives {got} cross-pod byte(s); the Eq. (3) "
            f"closed form gives {bound_bytes} ({bound:g} blocks x alpha={plan.alpha} x "
            f"sub={sub})",
            as_witness(program=program.name, traced_bytes=got, bound_bytes=bound_bytes,
                       bound_blocks=bound),
        )]
    return []


# --------------------------------------------------------------- mutations
# mutation name -> owning rule id; each corrupts the footprint of one
# captured repair program and must FAIL exactly its owner.
COLL_MUTATIONS: dict[str, str] = {
    "coll_orphan_permute": R_TC_MATCH,
    "coll_self_send": R_TC_PAIRING,
    "coll_axis_scope": R_TC_AXIS,
    "coll_hlo_bytes": R_TC_BYTES,
}


def coll_mutation_program(mutation: str, base: TracedProgram) -> TracedProgram:
    """Apply one named corruption to a captured repair program."""
    fp = base.footprint
    spec = base.meta["spec"]
    if not fp.sends:
        raise ValueError("base program traces no sends")
    if mutation == "coll_orphan_permute":
        # drop a scheduled ship: its step and its receive lose their partner
        new_fp = dataclasses.replace(fp, sends=fp.sends[1:])
    elif mutation == "coll_self_send":
        # the first send goes to its own rank
        bad = dataclasses.replace(fp.sends[0], peer=fp.sends[0].rank)
        new_fp = dataclasses.replace(fp, sends=(bad, *fp.sends[1:]))
    elif mutation == "coll_axis_scope":
        # an all-gather quietly aggregates over the rack axis
        bad = GroupOp(rank=0, name="allgather_",
                      group=tuple(p * spec.w for p in range(spec.r)))
        new_fp = dataclasses.replace(fp, gathers=(*fp.gathers, bad))
    elif mutation == "coll_hlo_bytes":
        # one cross-pod receive carries twice its bytes
        collector = _collector(spec)
        i = next(i for i, p in enumerate(fp.recvs)
                 if p.rank == collector and p.peer // spec.w != collector // spec.w)
        bad = dataclasses.replace(fp.recvs[i], nbytes=2 * fp.recvs[i].nbytes)
        new_fp = dataclasses.replace(fp, recvs=(*fp.recvs[:i], bad, *fp.recvs[i + 1:]))
    else:
        raise ValueError(f"unknown collective mutation {mutation!r}")
    return dataclasses.replace(base, footprint=new_fp)


__all__ = [
    "COLL_MUTATIONS", "SendMatch", "check_axis_scope", "check_cross_bytes",
    "check_pairing", "check_permute_match", "coll_mutation_program",
    "cross_pod_recv_bytes", "match_sends", "validate_p2p",
]
