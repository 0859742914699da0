"""Block placement: flat (r = n) vs hierarchical (r < n) — paper §2.1/§3.1.

A stripe's n blocks live on n distinct nodes spread evenly over r racks
(n/r nodes per rack).  Flat placement (r = n) is the conventional
one-block-per-rack layout; hierarchical placement (r < n) trades rack-level
fault tolerance for minimal cross-rack repair bandwidth.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Placement:
    n: int
    r: int

    def __post_init__(self):
        if self.r < 1 or self.r > self.n or self.n % self.r != 0:
            raise ValueError(f"r={self.r} must divide n={self.n}")

    @property
    def nodes_per_rack(self) -> int:
        return self.n // self.r

    def rack_of(self, node: int) -> int:
        if not 0 <= node < self.n:
            raise ValueError(f"node {node} out of range")
        return node // self.nodes_per_rack

    def nodes_in_rack(self, rack: int) -> list[int]:
        w = self.nodes_per_rack
        return list(range(rack * w, (rack + 1) * w))

    def rack_mates(self, node: int) -> list[int]:
        return [u for u in self.nodes_in_rack(self.rack_of(node)) if u != node]

    def other_racks(self, rack: int) -> list[int]:
        return [t for t in range(self.r) if t != rack]

    @property
    def is_flat(self) -> bool:
        return self.r == self.n

    def rack_failure_tolerance(self, n_minus_k: int) -> int:
        """How many whole-rack failures the stripe survives."""
        return n_minus_k // self.nodes_per_rack
