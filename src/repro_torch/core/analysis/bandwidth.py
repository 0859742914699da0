"""Numerical analysis of cross-rack repair bandwidth (paper §3.3, Fig. 3).

Unlike the paper's closed-form plots, these numbers are *measured from the
actual repair plans* of the implemented codes (averaged over every failed
node) and then cross-checked against Eq. (1)/(2)/(3); any divergence is a
bug in a construction, which is why the benchmark asserts equality.
A copy of ``repro.core.analysis.bandwidth`` over the port's codes.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..codes import make_code
from ..codes.registry import PAPER_CODES


@dataclass(frozen=True)
class BandwidthRow:
    family: str
    n: int
    k: int
    r: int
    cross_rack_blocks: float  # measured from repair plans
    closed_form: float  # Eq. (1)/(2)/(3) prediction
    total_blocks: float
    storage_overhead: float
    rack_tolerance: int

    @property
    def label(self) -> str:
        return f"{self.family}({self.n},{self.k},{self.r})"


def measure(family: str, n: int, k: int, r: int) -> BandwidthRow:
    code = make_code(family, n, k, r)
    cross = 0.0
    total = 0.0
    for f in range(code.n):
        t = code.repair_plan(f).traffic_blocks()
        cross += t["cross_rack_blocks"]
        total += t["total_blocks"]
    cross /= code.n
    total /= code.n
    return BandwidthRow(
        family=family,
        n=n,
        k=k,
        r=code.r,
        cross_rack_blocks=cross,
        closed_form=code.theoretical_cross_rack_blocks(),
        total_blocks=total,
        storage_overhead=code.storage_overhead,
        rack_tolerance=code.placement.rack_failure_tolerance(n - k),
    )


def fig3_rows() -> list[BandwidthRow]:
    """All Fig. 3 configurations, grouped by n-k like the paper."""
    return [measure(*cfg) for cfg in PAPER_CODES]


def cross_rack_table() -> dict[str, float]:
    return {row.label: row.cross_rack_blocks for row in fig3_rows()}


def paper_observations() -> dict[str, float]:
    """The §3.3 bullet-point claims, computed from measured rows."""
    t = cross_rack_table()
    return {
        # RS(8,6,8) has 50% higher cross-rack bw than RS(6,4,6)
        "rs86_vs_rs64_pct": 100.0 * (t["RS(8,6,8)"] / t["RS(6,4,6)"] - 1.0),
        # RS(6,4,3) is 25% below RS(6,4,6); MSR(6,4,3) 20% below MSR(6,4,6)
        "rs643_saving_pct": 100.0 * (1.0 - t["RS(6,4,3)"] / t["RS(6,4,6)"]),
        "msr643_saving_pct": 100.0 * (1.0 - t["MSR(6,4,3)"] / t["MSR(6,4,6)"]),
        # DRC(9,5,3) incurs 66.7% less cross-rack bw than RS(9,5,3)
        "drc953_vs_rs953_pct": 100.0 * (1.0 - t["DRC(9,5,3)"] / t["RS(9,5,3)"]),
        # DRC(9,5,3) incurs 33.3% less than MSR(8,4,4)
        "drc953_vs_msr844_pct": 100.0 * (1.0 - t["DRC(9,5,3)"] / t["MSR(8,4,4)"]),
    }
