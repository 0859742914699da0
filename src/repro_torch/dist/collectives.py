"""Lower a ``RepairPlan`` to one SPMD program over a ``(pod, node)`` mesh,
and run it on an emulated mesh on one card or over ``torch.distributed``.

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
* the spec runs in one of two executors:

  - :func:`make_spmd_repair`, the *emulated mesh*: the node-major
    ``(n, alpha, sub)`` payload tensor on one device, row ``p*w + j``
    standing for device ``(p, j)``.  NodeEncode computes only the coded
    rows of the stacked matrices, in one batched kernel launch into a
    preallocated unit buffer; a unit-vector row is the payload row it
    selects and a zero row is held by none, so the ``node`` all-gather is
    the payload and the buffer as they lie.  RelayerEncode reads both in
    place and writes its units into the same buffer; the cross ship and
    the decode's gather copy exactly the ``target_idx`` units into the
    collector's decode input (one copy per run of consecutive units, none
    when they already lie in order), whose cross-pod rows are the Eq. (3)
    bytes;
  - :func:`make_mesh_repair`, the *process-group executor*: one rank per
    device of a 2-D ``DeviceMesh`` (``launch.mesh.make_repair_mesh``).
    Each rank runs NodeEncode on its own payload, all-gathers over its
    ``node`` group, runs RelayerEncode if it is a relayer, and sends each
    unit the collector needs once, from the rank that produced it to the
    collector ``(target_pod, 0)``: the bytes sent between pods equal
    ``plan.traffic_blocks()["cross_rack_blocks"] * alpha * sub``.  The
    collector decodes; every other rank returns zeros.

  Either way output row ``target_pod * w`` (device ``(target_pod, 0)``)
  is the reconstruction and every other row is zero, as in the reference.

:func:`spmd_repair` runs one stripe; :func:`spmd_node_recovery` runs S
stripes with the relayer role rotating per stripe (paper §5.2 load
balancing).  Both take ``mesh=None`` for the emulated mesh.  Both
self-instrument through ``repro_torch.obs`` with the same stage names /
byte counters as ``core/repair.py``, so traced runs cross-check against
the plan's symbolic accounting.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable

import numpy as np
import torch
import torch.distributed as dist

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


def _pool2_sources(spec: SpmdRepairSpec) -> list[tuple[int, int]]:
    """(pod, pool row) of every row of the collector's ``pool2``: its own
    pod's pool, then each source pod's shipped rows in schedule order."""
    rows = [(spec.target_pod, row) for row in range(spec.pool_rows)]
    for q, dst, shipped in spec.permute_steps():
        if q != dst:
            rows.extend((q, row) for row in shipped)
    return rows


def _producer(spec: SpmdRepairSpec, pod: int, row: int) -> tuple[int, int]:
    """The node that produced pool row ``row`` of pod ``pod``, and the
    row's index in that node's [NodeEncode units ++ RelayerEncode units]."""
    wnu = spec.w * spec.nu
    if row < wnu:
        return pod * spec.w + row // spec.nu, row % spec.nu
    return pod * spec.w + (row - wnu) // spec.ru, spec.nu + (row - wnu) % spec.ru


# kinds of NodeEncode row, as ``_classify_units`` gives them and the
# ``repair.node_encode.units`` counter labels them
_SKIPPED, _IN_PLACE, _COMPUTED = 0, 1, 2
_UNIT_KINDS = ("skipped", "in_place", "computed")


def _classify_units(node_mats: np.ndarray) -> np.ndarray:
    """The kind of each row of ``node_mats`` (n, nu, alpha): ``_SKIPPED`` for
    a zero row, ``_IN_PLACE`` for a unit vector (one coefficient, equal to
    1: a copy of one payload row), ``_COMPUTED`` for any other.  A row's
    coefficients sum to 1 just where it is a unit vector."""
    return np.minimum(node_mats.sum(axis=-1, dtype=np.int64), _COMPUTED)


class _Rows:
    """A few 2-D tensors addressed as one stack of rows: row ``a`` of the
    part that starts at ``start`` is row ``start + a``.  Parts start at
    least one row past the end of the one before, so that no run of
    consecutive rows (``_row_runs``) spans two parts; a slice lies in one
    part and is a view of it."""

    def __init__(self, parts: list[tuple[int, torch.Tensor]]):
        self.parts = parts
        last_start, last = parts[-1]
        self.shape = (last_start + last.shape[0], last.shape[1])
        self.dtype, self.device = last.dtype, last.device

    def __getitem__(self, rows: slice) -> torch.Tensor:
        for start, part in reversed(self.parts):
            if rows.start >= start:
                return part[rows.start - start:rows.stop - start]
        raise IndexError(rows)


def _relayer_pieces(mats: np.ndarray, addr: list[list[int]],
                    gap: int) -> list[list[tuple[int, int, np.ndarray]]]:
    """Each relayer's product as pieces ``(first row, rows, matrix)``, one
    for the payload rows it reads (those below ``gap``) and one for the unit
    buffer's (those above): its matrix's nonzero columns over them, moved
    onto the span of rows they read.  ``mats`` is (relayers, ru, columns)
    and ``addr`` the row each column reads; ``gap`` stands for a zero unit,
    which none reads."""
    pieces = []
    for m, rows, nonzero in zip(mats, addr, mats.any(axis=1).tolist()):
        reads: tuple[list, list] = ([], [])  # (row, column) below and above the gap
        for col, (used, row) in enumerate(zip(nonzero, rows)):
            if used and row != gap:
                reads[row > gap].append((row, col))
        mine = []
        for part in reads:
            if not part:
                continue
            at, cols = zip(*part)
            first = min(at)
            span = max(at) - first + 1
            if at == tuple(range(first, first + span)):  # rows in order, once each
                piece = (m[:, cols[0]:cols[-1] + 1] if cols[-1] - cols[0] + 1 == span
                         else m[:, cols])
            else:
                piece = np.zeros((m.shape[0], span), np.uint8)
                for row, col in part:  # a row read twice takes the sum
                    piece[:, row - first] ^= m[:, col]
            mine.append((first, span, np.ascontiguousarray(piece)))
        pieces.append(mine)
    return pieces


def _relayer_encode(src: _Rows, pieces: list[list[tuple[int, int, np.ndarray]]],
                    z: torch.Tensor) -> None:
    """RelayerEncode of every relayer into ``z`` (relayers, ru, sub).

    Each relayer's input is its own payload and the units of its pod's
    NodeEncode pool it reads: payload rows, and the computed units in the
    unit buffer.  Each of its pieces (``_relayer_pieces``) reads a span of
    one of them in place, and the products are XORed into the first
    (``spmd_ablation`` times this against gathering the input once)."""
    for zi, mine in zip(z, pieces):
        if not mine:
            zi.zero_()
        for j, (first, rows, m) in enumerate(mine):
            if j == 0:
                ops.gf_matmul(m, src[first:first + rows], out=zi)
            else:
                zi.bitwise_xor_(ops.gf_matmul(m, src[first:first + rows]))


def _row_runs(pairs: Iterable[tuple[int, int]]) -> list[tuple[int, int, int]]:
    """Runs of ``(destination row, source row)`` pairs that are consecutive
    in both, as (destination row, source row, length)."""
    runs: list[tuple[int, int, int]] = []
    for dst, src in pairs:
        if runs and runs[-1][0] + runs[-1][2] == dst and runs[-1][1] + runs[-1][2] == src:
            runs[-1] = (runs[-1][0], runs[-1][1], runs[-1][2] + 1)
        else:
            runs.append((dst, src, 1))
    return runs


def _gather_rows(src: Any, runs: list[tuple[int, int, int]], dst: torch.Tensor) -> None:
    """``dst`` <- the rows of ``src`` (a tensor or ``_Rows``) that ``runs``
    name: one copy per run of consecutive rows (a copy moves bytes at the
    memory rate, where ``index_select`` gathers byte by byte; ``src`` may
    lie on the host)."""
    for d, s_, length in runs:
        dst[d:d + length].copy_(src[s_:s_ + length])


def _take_rows(src: Any, runs: list[tuple[int, int, int]], rows: int) -> torch.Tensor:
    """The ``rows`` rows of ``src`` (a tensor or ``_Rows``) that ``runs``
    name, as a view of ``src`` where they lie in order, else gathered into a
    new tensor."""
    if len(runs) == 1:
        _, s_, length = runs[0]
        return src[s_:s_ + length]
    dst = torch.empty((rows, src.shape[1]), dtype=src.dtype, device=src.device)
    _gather_rows(src, runs, dst)
    return dst


def make_spmd_repair(
    spec: SpmdRepairSpec,
) -> Callable[..., torch.Tensor]:
    """Build the emulated-mesh program ``repair(x, out=None)``: (n, alpha,
    sub) in and out.

    Output row ``target_pod * w`` (device (target_pod, 0)) carries the
    reconstructed payload; every other row is zero, as in the reference.
    ``out``, when given, is a contiguous (n, alpha, sub) uint8 tensor that
    is overwritten.  Each stage runs under its ``repro_torch.obs`` span,
    and each call books the schedule's ``repair.bytes.*`` and its
    NodeEncode rows by kind (``repair.node_encode.units``).

    NodeEncode computes only its coded rows (``_classify_units``): a zero
    row is computed and held by none, and a unit-vector row is the payload
    row it selects, which RelayerEncode and the decode input read where it
    lies.  The coded rows are one batched launch over the nodes from the
    first to the last that has any, ``R`` rows each (the most any node has,
    zero-padded), into a unit buffer that also holds the relayers' units.
    No other payload-sized buffer is made: the decode input holds only the
    ``target_idx`` units, copied from the payload and the unit buffer one
    run of consecutive rows at a time, or is a view where they lie in order.
    """
    n, w, nu, ru, alpha = spec.n, spec.w, spec.nu, spec.ru, spec.alpha
    rel = spec.rel_idx.tolist()
    kinds = _classify_units(spec.node_mats).tolist()  # (n, nu)
    per_node = [row.count(_COMPUTED) for row in kinds]
    R = max(per_node)
    enc_nodes = [node for node, c in enumerate(per_node) if c]
    lo, hi = (enc_nodes[0], enc_nodes[-1] + 1) if R else (0, 0)
    g = hi - lo
    # The rows the stages read: the payload's n*alpha rows, a gap row that
    # stands for every zero unit, then from `base` the unit buffer: the
    # computed units (node lo's first), then the relayers' units.
    gap = n * alpha
    base = gap + 1
    unit_rows = g * R + len(rel) * ru
    addr: list[int] = []  # the row each (node, NodeEncode row) is read from
    counts = [0] * len(_UNIT_KINDS)
    computed: list[tuple[int, int, int]] = []  # (node, its row, unit buffer row)
    for node, (row_kinds, cols) in enumerate(
            zip(kinds, spec.node_mats.argmax(axis=-1).tolist())):
        row = (node - lo) * R
        for local, (kind, col) in enumerate(zip(row_kinds, cols)):
            counts[kind] += 1
            if kind == _IN_PLACE:
                addr.append(node * alpha + col)
            elif kind == _COMPUTED:
                computed.append((node, local, row))
                addr.append(base + row)
                row += 1
            else:
                addr.append(gap)
    enc_mats = np.zeros((g * R, alpha), np.uint8)
    if computed:
        nodes, locals_, rows = zip(*computed)
        enc_mats[list(rows)] = spec.node_mats[list(nodes), list(locals_)]
    enc_mats = enc_mats.reshape(g, R, alpha)
    # Non-relayer rows of relayer_mats are zero (plan_to_spmd): only the
    # rel_idx rows are computed, and nothing reads the others.
    pieces = _relayer_pieces(
        spec.relayer_mats[rel],
        [[node * alpha + c for c in range(alpha)]
         + addr[node // w * w * nu:(node // w + 1) * w * nu] for node in rel],
        gap)
    rel_pos = {node: i for i, node in enumerate(rel)}

    wnu = w * nu

    def unit_addr(pod: int, row: int) -> int:
        # the row of pod `pod`'s pool row `row` (the rows `_producer` names)
        if row < wnu:
            return addr[pod * wnu + row]
        node, local = pod * w + (row - wnu) // ru, (row - wnu) % ru
        return base + g * R + rel_pos[node] * ru + local

    pool2 = _pool2_sources(spec)
    target = [unit_addr(*pool2[t]) for t in spec.target_idx]
    decode = spec.decode
    if gap in target:  # a zero unit adds nothing to the decode
        decode = np.ascontiguousarray(decode[:, np.asarray(target) != gap])
        target = [a for a in target if a != gap]
    runs = _row_runs(enumerate(target))
    permutes = sum(1 for q, dst, _ in spec.permute_steps() if q != dst)
    collector = spec.target_pod * w

    def repair(x: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
        if x.dtype != torch.uint8 or x.ndim != 3 or tuple(x.shape[:2]) != (n, alpha):
            raise ValueError(f"need ({n}, {alpha}, sub) uint8, got {x.dtype} {tuple(x.shape)}")
        if out is not None and (out.shape != x.shape or out.dtype != torch.uint8
                                or not out.is_contiguous() or out.device != x.device):
            raise ValueError(f"out must be a contiguous uint8 {tuple(x.shape)} tensor on {x.device}")
        dev, sub = x.device, x.shape[2]
        if obs.enabled():
            _record_schedule(spec, sub)
            for label, count in zip(_UNIT_KINDS, counts):
                obs.counter_add("repair.node_encode.units", count, kind=label)
        x = x.contiguous()
        parts = [(0, x.view(n * alpha, sub))]
        if unit_rows:
            units = torch.empty((unit_rows, sub), dtype=torch.uint8, device=dev)
            parts.append((base, units))
        src = _Rows(parts)
        with obs.span("repair.inner", cat="repair", units=spec.inner_units):
            # NodeEncode of the computed units on every device that has
            # any; the all_gather over `node` is the rows each stage reads
            if g:
                ops.gf_matmul_batched(enc_mats, x[lo:hi], out=units[:g * R].view(g, R, sub))
            if ru:
                _relayer_encode(src, pieces, units[g * R:].view(len(rel), ru, sub))
        with obs.span("repair.cross", cat="repair", units=spec.cross_units,
                      permutes=permutes):
            # each source pod's scheduled units and the target pod's own
            # land in the collector's decode input, in canonical order
            target_in = _take_rows(src, runs, len(target))
        with obs.span("repair.decode", cat="repair", units=len(spec.target_idx)):
            out = torch.empty_like(x) if out is None else out
            out[:collector].zero_()
            out[collector + 1:].zero_()
            ops.gf_matmul(decode, target_in, out=out[collector])
        return out

    return repair


# ------------------------------------------------- process-group executor
def _staged(group: Any, t: torch.Tensor) -> bool:
    """Whether a collective of ``group`` on ``t`` goes through host memory:
    ``gloo`` takes host tensors, so a device payload is copied to the host
    before the collective and back after it, explicitly and counted."""
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    obs.counter_add("repair.bytes.host_staged", t.numel(), direction="to_host")
    return t.cpu()


def _from_host(dst: torch.Tensor, host: torch.Tensor) -> None:
    obs.counter_add("repair.bytes.host_staged", host.numel(), direction="from_host")
    dst.copy_(host)


def _all_gather_rows(src: torch.Tensor, dst: torch.Tensor, group: Any) -> None:
    """``dst`` (size * rows, sub) <- every group member's ``src`` (rows, sub),
    in group-rank order."""
    size = dist.get_world_size(group)
    if _staged(group, src):
        host = torch.empty(dst.shape, dtype=dst.dtype)
        dist.all_gather(list(host.chunk(size)), _to_host(src), group=group)
        _from_host(dst, host)
    else:
        dist.all_gather(list(dst.chunk(size)), src, group=group)


def _check_mesh(spec: SpmdRepairSpec, mesh: Any) -> None:
    names, shape = tuple(mesh.mesh_dim_names or ()), tuple(mesh.shape)
    if (names, shape) != (("pod", "node"), (spec.r, spec.w)):
        raise ValueError(
            f"mesh axes {dict(zip(names, shape))} of shape {shape} do not match the "
            f"code's rack layout {{'pod': {spec.r}, 'node': {spec.w}}}"
        )


def make_mesh_repair(spec: SpmdRepairSpec, mesh: Any) -> Callable[..., torch.Tensor]:
    """Build this rank's body ``repair(x, out=None)`` of the SPMD program
    over ``mesh``, a ``DeviceMesh`` with dims ``("pod", "node")`` of sizes
    (r, w) whose rank at (p, j) holds node ``p*w + j``.

    ``x`` is this rank's (1, alpha, sub) uint8 shard on any device; the
    result is (1, alpha, sub) on x's device: the reconstruction on the
    collector (target_pod, 0), zeros elsewhere.  Every rank of the mesh
    must call its body for the same spec.  The collector books the
    schedule's ``repair.bytes.*``, once per call, so the counters summed
    over ranks equal the emulated mesh's.
    """
    _check_mesh(spec, mesh)
    w, nu, ru, alpha = spec.w, spec.nu, spec.ru, spec.alpha
    p, j = (int(c) for c in mesh.get_coordinate())
    me = p * w + j
    ranks = mesh.mesh  # (r, w) global ranks
    collector_rank = int(ranks[spec.target_pod, 0])
    is_collector = (p, j) == (spec.target_pod, 0)
    node_group = mesh.get_group("node")
    relayer = me in spec.rel_idx.tolist()
    # every unit of the decode input that is not in the collector's own
    # NodeEncode pool is sent once, by the node that produced it
    local: list[tuple[int, int]] = []  # (decode position, pool row)
    ships: dict[int, list[tuple[int, int]]] = {}  # node -> [(position, its unit row)]
    pool2 = _pool2_sources(spec)
    for pos, t in enumerate(spec.target_idx):
        pod, row = pool2[t]
        if pod == spec.target_pod and row < w * nu:
            local.append((pos, row))
        else:
            node, unit = _producer(spec, pod, row)
            ships.setdefault(node, []).append((pos, unit))
    local_runs = _row_runs(local)
    # a message carries its producer's units in decode order
    send_runs = {node: _row_runs(enumerate(unit for _, unit in units))
                 for node, units in ships.items()}
    recv_runs = {node: _row_runs((pos, i) for i, (pos, _) in enumerate(units))
                 for node, units in ships.items()}
    permutes = sum(1 for q, dst, _ in spec.permute_steps() if q != dst)

    def repair(x: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
        if x.dtype != torch.uint8 or x.ndim != 3 or tuple(x.shape[:2]) != (1, alpha):
            raise ValueError(f"need (1, {alpha}, sub) uint8, got {x.dtype} {tuple(x.shape)}")
        dev, sub = x.device, x.shape[2]
        if is_collector and obs.enabled():
            _record_schedule(spec, sub)
        own = x[0].contiguous()
        out = torch.empty_like(x) if out is None else out
        # [own payload ++ the pod's NodeEncode pool]: the relayer's input,
        # with the pool filled in place by the all-gather
        inp = torch.empty((alpha + w * nu, sub), dtype=torch.uint8, device=dev)
        pool = inp[alpha:]
        with obs.span("repair.inner", cat="repair", units=spec.inner_units):
            y = ops.gf_matmul(spec.node_mats[me], own)  # (nu, sub)
            _all_gather_rows(y, pool, node_group)
            units = y
            if ru and relayer:
                inp[:alpha].copy_(own)
                units = torch.cat([y, ops.gf_matmul(spec.relayer_mats[me], inp)])
        with obs.span("repair.cross", cat="repair", units=spec.cross_units,
                      permutes=permutes):
            if me in ships and not is_collector:
                msg = _take_rows(units, send_runs[me], len(ships[me]))
                dist.send(_to_host(msg) if _staged(None, msg) else msg, dst=collector_rank)
            if is_collector:
                target_in = torch.empty((len(spec.target_idx), sub), dtype=torch.uint8,
                                        device=dev)
                _gather_rows(pool, local_runs, target_in)
                for node in sorted(ships):
                    if node == me:
                        _gather_rows(units, recv_runs[node], target_in)
                        continue
                    staged = _staged(None, target_in)
                    buf = torch.empty((len(ships[node]), sub), dtype=torch.uint8,
                                      device="cpu" if staged else dev)
                    dist.recv(buf, src=int(ranks[node // w, node % w]))
                    if staged:
                        obs.counter_add("repair.bytes.host_staged", buf.numel(),
                                        direction="from_host")
                    _gather_rows(buf, recv_runs[node], target_in)
        with obs.span("repair.decode", cat="repair", units=len(spec.target_idx)):
            if is_collector:
                ops.gf_matmul(spec.decode, target_in, out=out[0])
            else:
                out.zero_()
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
    code: ErasureCode, failed: int, payloads: torch.Tensor, mesh: Any = None
) -> tuple[torch.Tensor, SpmdRepairSpec]:
    """Repair one stripe as a single SPMD program.

    Without ``mesh``, on the emulated mesh: payloads is (n, alpha, sub)
    uint8, node-major (row i = node i's payload; the failed row is
    ignored), and the (n, alpha, sub) output's row ``spec.target_pod *
    spec.w`` is the reconstruction.  With a ``(pod, node)`` ``DeviceMesh``
    (every rank calls this): payloads is this rank's (1, alpha, sub) shard
    and the output is this rank's (1, alpha, sub) block.
    """
    with obs.span("repair.spmd", cat="repair", failed=failed, family=code.name,
                  alpha=code.alpha, sub_bytes=int(payloads.shape[-1])):
        with obs.span("repair.plan", cat="repair", stripes=1):
            spec = plan_to_spmd(code, code.repair_plan(failed))
            body = make_spmd_repair(spec) if mesh is None else make_mesh_repair(spec, mesh)
        with obs.span("repair.launch", cat="repair", stripes=1):
            out = body(payloads)
    return out, spec


def spmd_node_recovery(
    code: ErasureCode, failed: int, payloads: torch.Tensor, mesh: Any = None
) -> tuple[torch.Tensor, list[SpmdRepairSpec]]:
    """Recover a whole node — S stripes — as one SPMD program.

    payloads: (S, n, alpha, sub) uint8 on the emulated mesh, or this
    rank's (S, 1, alpha, sub) with a ``DeviceMesh``.  Stripe s uses
    ``repair_plan(failed, rotation=s)`` so the relayer role rotates
    across the helper nodes of each remote rack (paper §5.2: node-level
    repair load balance).  Returns (output of payloads' shape, specs).

    Under ``repro_torch.obs`` the call is one ``repair.spmd_node_recovery``
    span with two children: ``repair.plan`` (every stripe's plan lookup,
    lowering and program) and ``repair.launch`` (the programs' runs).
    """
    n_stripes = int(payloads.shape[0])
    with obs.span("repair.spmd_node_recovery", cat="repair", failed=failed,
                  family=code.name, stripes=n_stripes) as root:
        with obs.span("repair.plan", cat="repair", stripes=n_stripes):
            specs = [plan_to_spmd(code, code.repair_plan(failed, rotation=s))
                     for s in range(n_stripes)]
            bodies = [make_spmd_repair(sp) if mesh is None else make_mesh_repair(sp, mesh)
                      for sp in specs]
        if obs.enabled():
            root.set_attr("distinct_relayer_sets",
                          len({tuple(sp.rel_idx.tolist()) for sp in specs}))
        with obs.span("repair.launch", cat="repair", stripes=n_stripes):
            out = torch.empty_like(payloads)
            for s, body in enumerate(bodies):
                body(payloads[s], out=out[s])
    return out, specs


def cross_units_scheduled(spec: SpmdRepairSpec) -> int:
    """Cross-pod units the schedule will move (for verifiers)."""
    return spec.cross_units


def expected_cross_units(plan: RepairPlan) -> int:
    """Cross-rack units by the plan's own accounting (blocks * alpha)."""
    blocks = float(plan.traffic_blocks()["cross_rack_blocks"])
    return round(blocks * plan.alpha)
