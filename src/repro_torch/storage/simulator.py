"""Hierarchical-cluster repair simulator (paper §6: Table 3, Figs. 6-8).

Executes `RepairPlan`s against the calibrated cost model: per-stage times
are derived from the plan's exact byte movement (which subblocks each
node reads, what each relayer receives/re-encodes, what crosses the
gateway), mirroring the paper's Table-3 decomposition:

    disk read → NodeEncode → inner-rack transfer → RelayerEncode →
    cross-rack transfer → Decode.

Two operations:

* degraded read (single block): the strip pipeline hides part of the
  non-bottleneck stages behind the cross-rack transfer
  (`overlap_degraded`);
* node recovery (many stripes, rotated targets/relayers — paper §5.2
  "Parallelization"): stripes pipeline against each other, so throughput
  is governed by the per-block bottleneck stage (`overlap_recovery`).

The strip/block-size effects of Fig. 8 come from per-strip call overhead
(small strips) and pipeline-fill + thread-starvation (large strips).

A copy of ``repro.storage.simulator`` over the port's plan layer; tests
hold ``StageTimes``, Table 3 and Figs. 6-8 equal to the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch import obs

from ..core.code_base import ErasureCode
from ..core.repair import TARGET, RepairPlan
from .costmodel import CostModel

MIB = 2**20


@dataclass
class StageTimes:
    disk: float
    node_encode: float
    inner: float
    relayer_encode: float
    cross: float
    decode: float
    write: float

    def as_dict(self) -> dict[str, float]:
        # Key order IS the pipeline order; names must match obs.STAGE_NAMES
        # so simulated and measured traces share one schema.
        return {
            "disk": self.disk,
            "node_encode": self.node_encode,
            "inner": self.inner,
            "relayer_encode": self.relayer_encode,
            "cross": self.cross,
            "decode": self.decode,
            "write": self.write,
        }

    def emit_spans(self, track: str, **attrs) -> None:
        """Render the decomposition as back-to-back `repro_torch.obs` stage spans
        (cat="stage") on `track` — no-op without an active tracer."""
        if not obs.enabled():
            return
        for name, dur in self.as_dict().items():
            obs.record_span(name, dur, cat="stage", track=track, **attrs)

    @property
    def bottleneck(self) -> str:
        d = self.as_dict()
        return max(d, key=d.get)

    @property
    def total(self) -> float:
        return sum(self.as_dict().values())

    @property
    def max_stage(self) -> float:
        return max(self.as_dict().values())


def _is_selector(matrix: np.ndarray) -> bool:
    """Repair-by-transfer rows: one unit coefficient per row, no arithmetic."""
    return all(
        np.count_nonzero(row) == 1 and row[np.nonzero(row)[0][0]] == 1
        for row in matrix
    )


def _used_cols(matrix: np.ndarray) -> int:
    return int(np.count_nonzero(matrix.any(axis=0)))


class ClusterSim:
    def __init__(self, cost: CostModel | None = None):
        self.cost = cost or CostModel()

    # ------------------------------------------------------------- stages
    def stage_times(
        self,
        code: ErasureCode,
        plan: RepairPlan,
        block_mib: float,
        gateway_gbps: float,
    ) -> StageTimes:
        c = self.cost
        alpha = plan.alpha
        sub = block_mib / alpha  # MiB per subblock unit
        rack = plan.placement.rack_of
        target_rack = rack(plan.failed)

        # disk: each participant reads the subblocks its sends actually use
        read_mib: dict[int, float] = {}
        enc_time: dict[int, float] = {}
        for s in plan.node_sends:
            used = _used_cols(s.matrix)
            read_mib[s.src] = read_mib.get(s.src, 0.0) + used * sub
            if not _is_selector(s.matrix):
                enc_time[s.src] = enc_time.get(s.src, 0.0) + (used * sub) / (
                    c.gf_compute_mib_s * c.node_encode_speedup
                )
        relayer_recv: dict[int, float] = {}
        for s in plan.node_sends:
            if s.dst != TARGET:
                relayer_recv[s.dst] = relayer_recv.get(s.dst, 0.0) + s.units * sub
        rel_time: dict[int, float] = {}
        for s in plan.relayer_sends:
            own = _used_cols(s.matrix[:, :alpha]) * sub
            read_mib[s.src] = read_mib.get(s.src, 0.0) + own
            rel_time[s.src] = (own + relayer_recv.get(s.src, 0.0)) / c.gf_compute_mib_s

        disk = max(read_mib.values(), default=0.0) / c.disk_mib_s
        node_encode = max(enc_time.values(), default=0.0)

        # inner transfers into relayers (the paper's Table-3 "inner-rack"
        # row is relayer-side; locals->target rides the same 10 GbE and
        # hides under the gateway-bound stages).  Per-rack links parallel.
        inner_by_rack: dict[int, float] = {}
        for s in plan.node_sends:
            if s.dst == TARGET:
                continue
            dst_rack = rack(s.dst)
            inner_by_rack[dst_rack] = inner_by_rack.get(dst_rack, 0.0) + s.units * sub
        inner = max(inner_by_rack.values(), default=0.0) / c.inner_mib_s

        relayer_encode = max(rel_time.values(), default=0.0)

        cross_mib = 0.0
        for s in plan.relayer_sends:
            if rack(s.src) != target_rack:
                cross_mib += s.units * sub
        for s in plan.node_sends:
            if s.dst == TARGET and rack(s.src) != target_rack:
                cross_mib += s.units * sub
        cross = cross_mib / c.gateway_mib_s(gateway_gbps)

        decode_in = sum(
            s.units for s in plan.node_sends if s.dst == TARGET
        ) + sum(s.units for s in plan.relayer_sends)
        decode = decode_in * sub / c.gf_compute_mib_s
        write = block_mib / c.disk_mib_s
        t = StageTimes(disk, node_encode, inner, relayer_encode, cross, decode, write)
        tracer = obs.current()
        if tracer is not None:
            t.emit_spans(
                track=f"sim:{tracer.next_seq()}:{code!r}",
                code=repr(code), failed=plan.failed, block_mib=block_mib,
                gateway_gbps=gateway_gbps,
            )
            traffic = plan.traffic_blocks()
            obs.counter_add("sim.bytes.inner_rack",
                            traffic["inner_rack_blocks"] * block_mib * MIB)
            obs.counter_add("sim.bytes.cross_rack",
                            traffic["cross_rack_blocks"] * block_mib * MIB)
        return t

    # ------------------------------------------------- strip-size effects
    def _strip_penalty(self, t: StageTimes, block_mib: float, strip_kib: float):
        c = self.cost
        strips = max(1.0, block_mib * 1024.0 / strip_kib)
        call = strips * c.call_overhead_s
        frac = 1.0 / strips
        fill = (c.pipeline_stages - 1) * t.max_stage * frac
        starve = 1.0 if strips >= c.threads else strips / c.threads
        return call, fill, starve

    # ---------------------------------------------------------- operations
    def degraded_read_time(
        self,
        code: ErasureCode,
        block_mib: float = 64.0,
        gateway_gbps: float = 1.0,
        strip_kib: float = 256.0,
        failed: int = 0,
    ) -> float:
        with obs.span("sim.degraded_read", cat="sim", code=repr(code),
                      block_mib=block_mib, gateway_gbps=gateway_gbps):
            plan = code.repair_plan(failed)
            t = self.stage_times(code, plan, block_mib, gateway_gbps)
            call, fill, _ = self._strip_penalty(t, block_mib, strip_kib)
            others = t.total - t.cross
            latency = (
                t.cross + (1.0 - self.cost.overlap_degraded) * others + call + fill
            )
            obs.gauge_set("sim.degraded_read_s", latency, code=repr(code),
                          gateway_gbps=str(gateway_gbps))
            return latency

    def node_recovery_throughput(
        self,
        code: ErasureCode,
        num_stripes: int = 20,
        block_mib: float = 64.0,
        gateway_gbps: float = 1.0,
        strip_kib: float = 256.0,
    ) -> float:
        """MiB/s of repaired data (paper Fig. 6 / Fig. 8)."""
        with obs.span("sim.node_recovery", cat="sim", code=repr(code),
                      num_stripes=num_stripes, block_mib=block_mib,
                      gateway_gbps=gateway_gbps, strip_kib=strip_kib):
            return self._node_recovery_throughput(
                code, num_stripes, block_mib, gateway_gbps, strip_kib
            )

    def _node_recovery_throughput(
        self, code, num_stripes, block_mib, gateway_gbps, strip_kib
    ) -> float:
        per_block = []
        for s in range(num_stripes):
            failed = s % code.n  # rotate the failed block's node per stripe
            plan = code.repair_plan(failed)
            t = self.stage_times(code, plan, block_mib, gateway_gbps)
            call, fill, starve = self._strip_penalty(t, block_mib, strip_kib)
            others = t.total - t.max_stage
            compute_scale = 1.0 / starve
            per_block.append(
                t.max_stage * compute_scale
                + (1.0 - self.cost.overlap_recovery) * others
                + call
                + fill
                + self.cost.fixed_block_overhead_s / num_stripes
            )
        total_time = float(np.sum(per_block)) + self.cost.fixed_block_overhead_s
        tput = num_stripes * block_mib / total_time
        obs.gauge_set("sim.recovery_mib_s", tput, code=repr(code),
                      gateway_gbps=str(gateway_gbps))
        return tput

    # ------------------------------------------------------------ table 3
    def table3_breakdown(
        self, code: ErasureCode, block_mib: float, gateway_gbps: float = 1.0
    ) -> dict[str, float]:
        plan = code.repair_plan(0)
        t = self.stage_times(code, plan, block_mib, gateway_gbps)
        d = t.as_dict()
        d.pop("write")
        return d
