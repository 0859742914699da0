"""Reed-Solomon baseline (paper §3.1 Eq. (1), §3.3).

α = 1.  Repair of one block retrieves k available blocks; under hierarchical
placement the target takes all n/r - 1 local blocks first and the remaining
k - (n/r - 1) from non-local racks (the paper's best-case RS accounting).
"""
from __future__ import annotations

import numpy as np

from .. import gf
from ..code_base import ErasureCode, rs_repair_blocks
from ..repair import TARGET, RepairPlan, Send, build_target_order


class RSCode(ErasureCode):
    name = "RS"

    def __init__(self, n: int, k: int, r: int | None = None):
        super().__init__(n, k, r if r is not None else n, alpha=1)

    def _build_generator(self) -> np.ndarray:
        return gf.rs_generator(self.n, self.k)

    def repair_plan(self, failed: int, rotation: int = 0) -> RepairPlan:
        pl = self.placement
        local = [u for u in pl.rack_mates(failed)]
        helpers = list(local[: self.k])
        if len(helpers) < self.k:
            # fill from non-local racks, round-robin for balance
            racks = pl.other_racks(pl.rack_of(failed))
            pools = [list(pl.nodes_in_rack(t)) for t in racks]
            i = 0
            while len(helpers) < self.k:
                if pools[i % len(pools)]:
                    helpers.append(pools[i % len(pools)].pop(0))
                i += 1
        helpers = sorted(helpers)
        rows = np.concatenate([self.node_coeffs(u) for u in helpers], axis=0)
        # decode: d @ rows = G_failed
        d = gf.gf_solve(rows.T, self.node_coeffs(failed).T).T
        node_sends = [
            Send(src=u, dst=TARGET, matrix=np.eye(1, dtype=np.uint8)) for u in helpers
        ]
        plan = RepairPlan(
            failed=failed,
            placement=pl,
            alpha=1,
            node_sends=node_sends,
            relayer_sends=[],
            decode=np.ascontiguousarray(d),
            target_order=build_target_order(node_sends, []),
            family=self.name,
        )
        return plan

    def theoretical_cross_rack_blocks(self) -> float:
        return rs_repair_blocks(self.k) - (self.placement.nodes_per_rack - 1)

    def theoretical_total_blocks(self) -> float:
        return rs_repair_blocks(self.k)
