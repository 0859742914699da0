"""Lower a ``RepairPlan`` to one SPMD program over a ``(pod, node)`` mesh,
and run it on an emulated mesh on one card.

The paper's DoubleR workflow (§2.2) maps onto a device mesh with the
rack structure made explicit: ``pod`` is the rack axis (r racks) and
``node`` the within-rack axis (w = n/r nodes); device (p, j) holds the
(alpha, sub) payload of node ``p*w + j``, matching
``Placement.rack_of``.  The lowering is two-phase:

* :func:`plan_to_spmd` compiles the plan's GF(256) DAG into a *static*
  :class:`SpmdRepairSpec` — stacked per-node NodeEncode matrices,
  per-relayer RelayerEncode matrices re-indexed onto the rack-local
  unit pool, and integer gather schedules for the cross-pod ship and
  the target decode.  Pure numpy, a copy of the reference's
  (``repro.dist.collectives``); tests hold the two equal.
* :func:`make_spmd_repair` turns a spec into a function over the
  node-major ``(n, alpha, sub)`` payload tensor, where device ``(p, j)``
  is row ``p*w + j``:

  - **inner** — NodeEncode for all n devices is one batched kernel
    launch; the ``node`` all-gather is a reshape to ``(r, w*nu, sub)``
    (no bytes move); RelayerEncode is one batched launch over the
    relayers;
  - **cross** — each source pod's ``ppermute`` is an index copy of
    exactly its ``cross_idx`` rows into the target pod's pool, so the
    bytes copied equal ``plan.traffic_blocks()["cross_rack_blocks"] *
    alpha * sub`` — the Eq. (3) bound;
  - **decode** — the collector (device (target_pod, 0), output row
    ``target_pod * w``) gathers its canonical unit order and applies the
    decode matrix.

:func:`spmd_repair` runs one stripe; :func:`spmd_node_recovery` runs S
stripes with the relayer role rotating per stripe (paper §5.2 load
balancing).  Both self-instrument through ``repro_torch.obs`` with the
same stage names / byte counters as ``core/repair.py``, so traced runs
cross-check against the plan's symbolic accounting.  A multi-GPU
backend over NCCL is later work.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.code_base import ErasureCode
from repro_torch.core.repair import TARGET, RepairPlan, Send
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class SpmdRepairSpec:
    """Static lowering of one RepairPlan onto the (pod, node) mesh."""

    family: str
    n: int
    k: int
    r: int
    alpha: int
    w: int  # nodes per pod (mesh "node" axis size)
    failed: int
    target_pod: int  # rack of the failed node; collector = (target_pod, 0)
    rel_idx: np.ndarray  # (num_relayers,) int32 — relayer node ids
    node_mats: np.ndarray  # (n, nu, alpha) uint8 — stacked NodeEncode rows
    relayer_mats: np.ndarray  # (n, ru, alpha + w*nu) uint8, pool-indexed
    cross_idx: tuple[tuple[int, ...], ...]  # per pod: pool rows it ships
    target_idx: tuple[int, ...]  # decode input rows in pool2, canonical order
    decode: np.ndarray  # (alpha, total units) uint8
    inner_units: int  # units moved intra-rack (traffic_blocks classification)

    @property
    def nu(self) -> int:
        return int(self.node_mats.shape[1])

    @property
    def ru(self) -> int:
        return int(self.relayer_mats.shape[1])

    @property
    def cross_units(self) -> int:
        """Units the collective-permute schedule ships across pods."""
        return sum(len(rows) for rows in self.cross_idx)

    @property
    def pool_rows(self) -> int:
        """Rows in each pod's gathered unit pool before the cross ship."""
        return self.w * self.nu + (self.w * self.ru if self.ru else 0)

    def permute_steps(self) -> tuple[tuple[int, int, tuple[int, ...]], ...]:
        """The declared collective-permute schedule: one ``(src_pod,
        dst_pod, pool_rows_shipped)`` step per pod with scheduled units.

        This is the artifact ``make_spmd_repair`` compiles and the
        lowered-layer verifier (``repro.check.lowered.spmd``) analyzes —
        both read the same steps, so a schedule the verifier proved
        self-send-free and byte-exact is the schedule that runs.
        """
        return tuple(
            (q, self.target_pod, rows)
            for q, rows in enumerate(self.cross_idx)
            if rows
        )

    def traffic_bytes(self, sub_bytes: int) -> dict[str, int]:
        """Scheduled bytes by scope — comparable to plan.traffic_blocks()
        via bytes == blocks * alpha * sub_bytes."""
        return {
            "inner_rack": self.inner_units * sub_bytes,
            "cross_rack": self.cross_units * sub_bytes,
        }


def _node_send_layout(plan: RepairPlan) -> dict[int, list[tuple[Send, int]]]:
    """Per node: its NodeEncode sends in canonical order (dst ascending,
    TARGET=-1 first) with each send's row offset in the stacked matrix."""
    by_src: dict[int, list[Send]] = {}
    for s in plan.node_sends:
        by_src.setdefault(s.src, []).append(s)
    layout: dict[int, list[tuple[Send, int]]] = {}
    for src, sends in by_src.items():
        sends.sort(key=lambda s: s.dst)
        off = 0
        entries: list[tuple[Send, int]] = []
        for s in sends:
            entries.append((s, off))
            off += s.units
        layout[src] = entries
    return layout


def plan_to_spmd(code: ErasureCode, plan: RepairPlan) -> SpmdRepairSpec:
    """Compile a RepairPlan into a static SPMD spec (pure numpy)."""
    pl = plan.placement
    n, r, w = pl.n, pl.r, pl.nodes_per_rack
    alpha = plan.alpha
    target_pod = pl.rack_of(plan.failed)
    layout = _node_send_layout(plan)

    # --- NodeEncode: one zero-padded (nu, alpha) matrix per node
    nu = max(
        (sum(s.units for s, _ in entries) for entries in layout.values()),
        default=0,
    )
    nu = max(nu, 1)
    node_mats = np.zeros((n, nu, alpha), np.uint8)
    send_off: dict[tuple[int, int], int] = {}
    for src, entries in layout.items():
        for s, off in entries:
            node_mats[src, off:off + s.units, :] = s.matrix
            send_off[(s.src, s.dst)] = off

    def y_row(src: int, off: int) -> int:
        # row of node `src`'s unit `off` in the rack-local gathered pool
        return (src % w) * nu + off

    # --- RelayerEncode: columns re-indexed from [own alpha ++ received
    # units in _relayer_input_order] onto [own alpha ++ the full rack
    # pool], so one matrix shape serves every relayer.
    rsends = sorted(plan.relayer_sends, key=lambda s: s.src)
    ru = max((s.units for s in rsends), default=0)
    relayer_mats = np.zeros((n, ru, alpha + w * nu), np.uint8)
    for s in rsends:
        relayer_mats[s.src, :s.units, :alpha] = s.matrix[:, :alpha]
        col = alpha
        for ns in plan._relayer_input_order(s.src):
            off = send_off[(ns.src, ns.dst)]
            for t in range(ns.units):
                relayer_mats[s.src, :s.units, alpha + y_row(ns.src, off + t)] = (
                    s.matrix[:s.units, col]
                )
                col += 1

    def z_row(src: int, row: int) -> int:
        return w * nu + (src % w) * ru + row

    # --- canonical target-unit order (matches build_target_order):
    # node sends to TARGET sorted by src, then relayer sends by src.
    units: list[tuple[int, int]] = []  # (src node, pool row in its pod)
    for s in sorted(
        (x for x in plan.node_sends if x.dst == TARGET), key=lambda x: x.src
    ):
        off = send_off[(s.src, TARGET)]
        for t in range(s.units):
            units.append((s.src, y_row(s.src, off + t)))
    for s in rsends:
        for t in range(s.units):
            units.append((s.src, z_row(s.src, t)))

    # --- cross-pod schedule: pool rows each non-target pod must ship,
    # in canonical-unit order (so received blocks concatenate cleanly)
    pool_rows = w * nu + (w * ru if ru else 0)
    cross_lists: list[list[int]] = [[] for _ in range(r)]
    cross_pos: dict[int, int] = {}  # unit index -> position in its pod list
    for idx, (src, row) in enumerate(units):
        q = pl.rack_of(src)
        if q != target_pod:
            cross_pos[idx] = len(cross_lists[q])
            cross_lists[q].append(row)

    bases: dict[int, int] = {}
    base = pool_rows
    for q in range(r):
        if q == target_pod or not cross_lists[q]:
            continue
        bases[q] = base
        base += len(cross_lists[q])

    target_idx: list[int] = []
    for idx, (src, row) in enumerate(units):
        q = pl.rack_of(src)
        if q == target_pod:
            target_idx.append(row)
        else:
            target_idx.append(bases[q] + cross_pos[idx])

    # --- inner-rack unit count, same classification as traffic_blocks()
    inner = 0
    for s in plan.node_sends:
        dst_rack = target_pod if s.dst == TARGET else pl.rack_of(s.dst)
        if pl.rack_of(s.src) == dst_rack:
            inner += s.units
    for s in rsends:
        if pl.rack_of(s.src) == target_pod:
            inner += s.units

    return SpmdRepairSpec(
        family=code.name,
        n=n, k=code.k, r=r, alpha=alpha, w=w,
        failed=plan.failed,
        target_pod=target_pod,
        rel_idx=np.asarray([s.src for s in rsends], np.int32),
        node_mats=node_mats,
        relayer_mats=relayer_mats,
        cross_idx=tuple(tuple(rows) for rows in cross_lists),
        target_idx=tuple(target_idx),
        decode=np.asarray(plan.decode, np.uint8),
        inner_units=inner,
    )


def make_spmd_repair(
    spec: SpmdRepairSpec,
) -> Callable[..., torch.Tensor]:
    """Build the emulated-mesh program ``repair(x, out=None)``: (n, alpha,
    sub) in and out.

    Output row ``target_pod * w`` (device (target_pod, 0)) carries the
    reconstructed payload; every other row is zero, as in the reference.
    ``out``, when given, is a contiguous (n, alpha, sub) uint8 tensor that
    is overwritten.  Each stage runs under its ``repro_torch.obs`` span.
    """
    r, w, nu, ru, alpha = spec.r, spec.w, spec.nu, spec.ru, spec.alpha
    rel = spec.rel_idx.astype(np.int64)
    # Non-relayer rows of relayer_mats are zero (plan_to_spmd), so their
    # RelayerEncode output is zero: computing only the rel_idx rows and
    # leaving the other rows of the pool at zero gives the same pool.
    relayer_mats = np.ascontiguousarray(spec.relayer_mats[rel])
    # declared schedule; plan_to_spmd never emits a (q, q) self-send
    cross = [(q, rows) for q, dst, rows in spec.permute_steps() if q != dst]

    def repair(x: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
        if x.dtype != torch.uint8 or tuple(x.shape[:2]) != (spec.n, alpha):
            raise ValueError(f"need ({spec.n}, {alpha}, sub) uint8, got {x.dtype} {tuple(x.shape)}")
        dev, sub = x.device, x.shape[2]
        x = x.contiguous()
        with obs.span("repair.inner", cat="repair", units=spec.inner_units):
            # NodeEncode on every device at once, then all_gather over
            # `node` == a view of the node-major result per pod
            y = ops.gf_matmul_batched(spec.node_mats, x)  # (n, nu, sub)
            pool = y.view(r, w * nu, sub)
            if ru:
                rel_t = torch.from_numpy(rel).to(dev)
                inp = torch.cat([x.index_select(0, rel_t),
                                 pool.index_select(0, rel_t // w)], dim=1)
                z = ops.gf_matmul_batched(relayer_mats, inp)  # (relayers, ru, sub)
                zf = torch.zeros((r, w, ru, sub), dtype=torch.uint8, device=dev)
                zf[rel_t // w, rel_t % w] = z
                pool = torch.cat([pool, zf.view(r, w * ru, sub)], dim=1)
        with obs.span("repair.cross", cat="repair", units=spec.cross_units,
                      permutes=len(cross)):
            # each source pod ships exactly its scheduled rows
            recvs = [
                pool[q].index_select(0, torch.tensor(rows, device=dev))
                for q, rows in cross
            ]
            pool2 = torch.cat([pool[spec.target_pod], *recvs], dim=0)
        with obs.span("repair.decode", cat="repair", units=len(spec.target_idx)):
            out = torch.zeros_like(x) if out is None else out.zero_()
            target_in = pool2.index_select(0, torch.tensor(spec.target_idx, device=dev))
            ops.gf_matmul(spec.decode, target_in, out=out[spec.target_pod * w])
        return out

    return repair


def _record_schedule(spec: SpmdRepairSpec, sub_bytes: int) -> None:
    """Book the static schedule into the obs counters — same names and
    scope classification as RepairPlan._record_send, so a traced SPMD
    run cross-checks against traffic_blocks() exactly."""
    moved = spec.traffic_bytes(sub_bytes)
    obs.counter_add("repair.bytes.inner_rack", moved["inner_rack"],
                    stage="spmd")
    obs.counter_add("repair.bytes.cross_rack", moved["cross_rack"],
                    stage="spmd")
    for q, rows in enumerate(spec.cross_idx):
        if rows and q != spec.target_pod:
            obs.counter_add("repair.units_cross", len(rows), pod=str(q))


def spmd_repair(
    code: ErasureCode, failed: int, payloads: torch.Tensor
) -> tuple[torch.Tensor, SpmdRepairSpec]:
    """Repair one stripe as a single SPMD program on the emulated mesh.

    payloads: (n, alpha, sub) uint8, node-major (row i = node i's
    payload; the failed row is ignored).  Returns the (n, alpha, sub)
    output — row ``spec.target_pod * spec.w`` is the reconstruction —
    plus the static spec.
    """
    spec = plan_to_spmd(code, code.repair_plan(failed))
    sub_bytes = int(payloads.shape[-1])
    with obs.span("repair.spmd", cat="repair", failed=failed,
                  family=spec.family, alpha=spec.alpha, sub_bytes=sub_bytes):
        _record_schedule(spec, sub_bytes)
        out = make_spmd_repair(spec)(payloads)
    return out, spec


def spmd_node_recovery(
    code: ErasureCode, failed: int, payloads: torch.Tensor
) -> tuple[torch.Tensor, list[SpmdRepairSpec]]:
    """Recover a whole node — S stripes — on the emulated mesh.

    payloads: (S, n, alpha, sub) uint8.  Stripe s uses
    ``repair_plan(failed, rotation=s)`` so the relayer role rotates
    across the helper nodes of each remote rack (paper §5.2: node-level
    repair load balance).  Returns ((S, n, alpha, sub), specs).
    """
    n_stripes = int(payloads.shape[0])
    specs = [plan_to_spmd(code, code.repair_plan(failed, rotation=s))
             for s in range(n_stripes)]
    sub_bytes = int(payloads.shape[-1])
    relayer_sets = {tuple(sp.rel_idx.tolist()) for sp in specs}
    with obs.span("repair.spmd_node_recovery", cat="repair", failed=failed,
                  family=specs[0].family if specs else "", stripes=n_stripes,
                  distinct_relayer_sets=len(relayer_sets)):
        for spec in specs:
            _record_schedule(spec, sub_bytes)
        out = torch.empty_like(payloads)
        for s, spec in enumerate(specs):
            make_spmd_repair(spec)(payloads[s], out=out[s])
    return out, specs


def cross_units_scheduled(spec: SpmdRepairSpec) -> int:
    """Cross-pod units the schedule will move (for verifiers)."""
    return spec.cross_units


def expected_cross_units(plan: RepairPlan) -> int:
    """Cross-rack units by the plan's own accounting (blocks * alpha)."""
    blocks = float(plan.traffic_blocks()["cross_rack_blocks"])
    return round(blocks * plan.alpha)
