"""Beyond-paper extensions from the paper's §7 related work, over tensors.

* Multi-failure repair (CORE [28] / §3.4's multi-node repair model): up
  to n-k concurrent failures are decoded from any k survivors; the
  traffic accounting mirrors the paper's reliability model (C = k per
  repaired node, all-surviving-rack-local blocks fetched first).
* Lazy repair (Total Recall [7] / Silberstein [45]): defer repair until
  the number of failures reaches a threshold, batching the decode cost.
* HACFS-style code switching [51]: keep *hot* stripes in a fast-repair
  code (DRC) and *cold* stripes in a low-redundancy code (RS),
  re-encoding on access-heat changes.

The policies are those of ``repro.core.multi_failure``; the payloads are
uint8 tensors, and every GF(256) product (decode, re-encode) goes through
``repro_torch.kernels.ops.gf_matmul``, so a CUDA payload launches the
kernel.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.kernels import ops

from .code_base import ErasureCode
from .codes import make_code


# ---------------------------------------------------------- multi-failure
@dataclass
class MultiRepairReport:
    failed: list[int]
    helpers: list[int]
    cross_rack_blocks: float
    inner_rack_blocks: float


def multi_failure_repair(
    code: ErasureCode, failed: list[int], payloads: dict[int, torch.Tensor]
) -> tuple[dict[int, torch.Tensor], MultiRepairReport]:
    """Repair up to n-k concurrent failures.

    Single failure delegates to the layered plan (Eq. (3) traffic); multi
    failure decodes from k survivors at one target, preferring helpers in
    the first failed node's rack (the paper's C = k model), and re-encodes
    only the failed nodes' generator rows.
    """
    if not failed:
        return {}, MultiRepairReport([], [], 0.0, 0.0)
    if len(failed) > code.n - code.k:
        raise ValueError(f"{len(failed)} failures exceed n-k={code.n - code.k}")
    if len(failed) == 1:
        f = failed[0]
        plan = code.repair_plan(f)
        t = plan.traffic_blocks()
        out = plan.execute(payloads)
        return {f: out}, MultiRepairReport(
            failed, plan.participants(), t["cross_rack_blocks"], t["inner_rack_blocks"]
        )
    pl = code.placement
    target_rack = pl.rack_of(failed[0])
    survivors = [i for i in range(code.n) if i not in failed]
    # prefer local helpers (free inner-rack transfer), then others
    helpers = sorted(
        survivors, key=lambda u: (pl.rack_of(u) != target_rack, u)
    )[: code.k]
    data = code.decode({i: payloads[i] for i in helpers})
    coded = ops.gf_matmul(np.concatenate([code.node_coeffs(f) for f in failed]), data)
    a = code.alpha
    out = {f: coded[i * a : (i + 1) * a] for i, f in enumerate(failed)}
    cross = sum(1.0 for u in helpers if pl.rack_of(u) != target_rack)
    inner = len(helpers) - cross
    return out, MultiRepairReport(failed, helpers, cross, inner)


# -------------------------------------------------------------- lazy repair
@dataclass
class LazyRepairPolicy:
    """Defer repair until `threshold` failures accumulate (or a hot read
    forces a degraded repair).  Returns the action stream for tests and
    the simulator."""

    code_spec: tuple[str, int, int, int] = ("DRC", 9, 6, 3)
    threshold: int = 2
    failed: set[int] = field(default_factory=set)

    def on_failure(self, node: int) -> str:
        self.failed.add(node)
        n, k = self.code_spec[1], self.code_spec[2]
        if len(self.failed) >= n - k:
            return "repair_now"  # at fault-tolerance edge: must repair
        if len(self.failed) >= self.threshold:
            return "repair_batch"
        return "defer"

    def on_degraded_read(self, node: int) -> str:
        return "repair_single" if node in self.failed else "direct"

    def repaired(self, nodes: list[int]):
        self.failed -= set(nodes)

    def batched_saving_blocks(self) -> float:
        """Traffic saved vs eager repair: eager repairs each failure with
        a single-failure plan; lazy batches one k-block decode."""
        fam, n, k, r = self.code_spec
        code = make_code(fam, n, k, r)
        eager = len(self.failed) * (
            code.repair_plan(0).traffic_blocks()["total_blocks"]
        )
        lazy = float(k)
        return eager - lazy


# ----------------------------------------------------------- code switching
@dataclass
class CodeSwitcher:
    """HACFS-style two-code scheme: hot data in a fast-repair code, cold
    data in a compact code; switch on access-heat crossings."""

    hot_spec: tuple[str, int, int, int] = ("DRC", 9, 6, 3)
    cold_spec: tuple[str, int, int, int] = ("RS", 8, 6, 4)
    hot_threshold: float = 5.0  # EWMA accesses (decay 0.9 -> asymptote 10)
    heat: dict[int, float] = field(default_factory=dict)
    placement: dict[int, str] = field(default_factory=dict)  # stripe -> hot|cold

    def record_access(self, stripe: int, weight: float = 1.0):
        self.heat[stripe] = self.heat.get(stripe, 0.0) * 0.9 + weight

    def target_code(self, stripe: int) -> tuple[str, int, int, int]:
        hot = self.heat.get(stripe, 0.0) >= self.hot_threshold
        return self.hot_spec if hot else self.cold_spec

    def plan_switches(self) -> list[tuple[int, str]]:
        out = []
        for stripe, h in self.heat.items():
            want = "hot" if h >= self.hot_threshold else "cold"
            if self.placement.get(stripe, "cold") != want:
                out.append((stripe, want))
        return out

    def switch(self, stripe: int, blocks: torch.Tensor) -> list[torch.Tensor]:
        """Re-encode a stripe's data blocks (uint8, k blocks' bytes in any
        shape) into its target code; the payloads land on blocks' device."""
        fam, n, k, r = self.target_code(stripe)
        code = make_code(fam, n, k, r)
        want = "hot" if (fam, n, k, r) == self.hot_spec else "cold"
        self.placement[stripe] = want
        kb = blocks.reshape(code.k, -1)
        pad = (-kb.shape[1]) % code.alpha
        if pad:
            kb = torch.nn.functional.pad(kb, (0, pad))
        return code.encode_blocks(kb.contiguous())
