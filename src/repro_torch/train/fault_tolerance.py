"""Fault-tolerance control plane: failure detection, straggler
mitigation, elastic rescale — over the port's erasure-coded checkpoints.

This is the policy layer a multi-node deployment drives: heartbeats feed
`FailureDetector`; step-time reports feed `StragglerMonitor`; on a
failure the `FaultToleranceManager` picks the cheapest recovery action:

* 1 lost state shard  → layered DRC repair (cross-rack bytes = Eq. (3));
* ≤ n-k lost          → MDS decode from survivors;
* > n-k lost          → roll back to the last durable checkpoint;
* cluster resize      → elastic re-encode onto a new (n, k, r) stripe
                        matching the new rack topology.

All decisions are pure functions of reported state, the reference's
(``repro.train.fault_tolerance``), with the same ``ft.*`` spans and
counters.  Restore and re-encode run the GF(256) products on the
checkpoint payloads' device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from repro_torch import obs

from .checkpoint import EncodedCheckpoint, encode_state, restore_state

# One injectable time source threaded through the whole control plane:
# production uses the monotonic clock, tests pass a fake and every
# timeout decision becomes deterministic.
Clock = Callable[[], float]


@dataclass
class FailureDetector:
    timeout_s: float = 60.0
    clock: Clock = time.monotonic
    last_beat: dict[int, float] = field(default_factory=dict)

    def heartbeat(self, node: int, now: float | None = None):
        self.last_beat[node] = self.clock() if now is None else now
        obs.counter_add("ft.heartbeats", 1, node=str(node))

    def failed_nodes(self, now: float | None = None) -> list[int]:
        now = self.clock() if now is None else now
        return sorted(
            n for n, t in self.last_beat.items() if now - t > self.timeout_s
        )


@dataclass
class StragglerMonitor:
    """Flags nodes whose step time exceeds median by `threshold`x.

    Mitigation policy mirrors the paper's §5.2 parallelization note:
    rotate relayer/target roles away from slow nodes so repair (and
    checkpoint encode) work avoids stragglers.
    """

    threshold: float = 1.5
    window: int = 16
    clock: Clock = time.monotonic
    times: dict[int, list[float]] = field(default_factory=dict)
    last_seen: dict[int, float] = field(default_factory=dict)

    def report(self, pod: int, step_time: float, now: float | None = None):
        self.last_seen[pod] = self.clock() if now is None else now
        self.times.setdefault(pod, []).append(step_time)
        self.times[pod] = self.times[pod][-self.window :]
        obs.counter_add("ft.step_reports", 1, pod=str(pod))

    def stragglers(self) -> list[int]:  # check: ignore[uninstrumented-entrypoint] pure query
        if len(self.times) < 2:
            return []
        med = {p: float(np.median(t)) for p, t in self.times.items()}
        overall = float(np.median(list(med.values())))
        return sorted(p for p, m in med.items() if m > self.threshold * overall)

    def preferred_relayer_order(self, pods: list[int]) -> list[int]:
        slow = set(self.stragglers())
        return sorted(pods, key=lambda p: (p in slow, p))


@dataclass
class RecoveryAction:
    kind: str  # noop | repair | decode | rollback
    detail: dict = field(default_factory=dict)


class FaultToleranceManager:
    def __init__(self, *, family="DRC", n=9, k=6, r=3, clock: Clock | None = None):
        self.spec = (family, n, k, r)
        self.clock = clock if clock is not None else time.monotonic
        self.detector = FailureDetector(clock=self.clock)
        self.straggler = StragglerMonitor(clock=self.clock)

    def plan_recovery(self, ckpt: EncodedCheckpoint, lost: list[int]) -> RecoveryAction:
        with obs.span("ft.plan_recovery", cat="ft", lost=len(lost)):
            n, k = ckpt.code_spec[1], ckpt.code_spec[2]
            if not lost:
                return RecoveryAction("noop")
            if len(lost) == 1:
                return RecoveryAction("repair", {"node": lost[0]})
            if len(lost) <= n - k:
                return RecoveryAction("decode", {"nodes": lost})
            return RecoveryAction("rollback", {})

    def execute(self, ckpt: EncodedCheckpoint, like: Any, lost: list[int]):
        action = self.plan_recovery(ckpt, lost)
        with obs.span("ft.execute", cat="ft", kind=action.kind,
                      lost=len(lost)):
            if action.kind == "noop":
                state, report = restore_state(ckpt, like)
                return state, report, action
            if action.kind == "rollback":
                raise RuntimeError(
                    f"{len(lost)} failures exceed n-k; roll back to durable checkpoint"
                )
            available = set(ckpt.payloads) - set(lost)
            state, report = restore_state(ckpt, like, available=available)
            obs.counter_add("ft.recoveries", 1, kind=action.kind)
            return state, report, action

    # ------------------------------------------------------------- elastic
    def rescale(
        self, ckpt: EncodedCheckpoint, like: Any, *, family=None, n=None, k=None, r=None
    ) -> EncodedCheckpoint:
        """Re-encode the stripe for a new cluster topology (elastic scale
        up/down): decode current state, encode with the new (n, k, r) on
        the payloads' device."""
        fam, n0, k0, r0 = ckpt.code_spec
        with obs.span("ft.rescale", cat="ft", old=f"({n0},{k0},{r0})",
                      new=f"({n or n0},{k or k0},{r or r0})"):
            state, _ = restore_state(ckpt, like)
            return encode_state(
                state,
                family=family or fam,
                n=n or n0,
                k=k or k0,
                r=r or r0,
                step=ckpt.step,
                device=next(iter(ckpt.payloads.values())).device,
            )
