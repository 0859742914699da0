"""DRC Family 2: DRC(3z, 2z-1, 3) — paper §4.3 (repair-by-transfer).

Construction: each block is split into α = 2 subblocks; the subblocks at the
same offset across the k = 2z-1 data blocks form a *set*; each set is
independently encoded with a systematic (3z, 2z-1) RS code into z+1 parity
subblocks.  Node i stores (set-0 symbol i, set-1 symbol i).  n = 3z blocks
are placed across 3 racks of z nodes.

Repair of node f (rack R_i): assign set 0 to one non-local rack R_j and set 1
to the other, R_l.  For set s and helper rack R_h there is (generically) a
unique dual codeword h of the per-set RS code supported on R_i ∪ R_h with
h_f ≠ 0.  Non-relayer nodes of R_h forward their raw set-s subblock to the
relayer (repair-by-transfer: pure disk read, no arithmetic — paper Goal /
§4.3); the relayer combines them with weights h|R_h and ships ONE unit
cross-rack.  The target cancels the local part h|R_i using its rack-mates'
raw subblocks and solves for the failed symbol.  Cross-rack traffic:
2 × B/2 = B = Eq. (3) minimum; each relayer ships exactly one unit (Goal 8).
"""
from __future__ import annotations

import numpy as np

from .. import gf
from ..code_base import drc_min_cross_rack_blocks
from ..repair import TARGET, RepairPlan, Send, build_target_order
from .stripwise import StripwiseRS


class DRCFamily2(StripwiseRS):
    name = "DRC"

    def __init__(self, n: int, k: int, r: int = 3):
        if r != 3 or n % 3 or k != 2 * (n // 3) - 1:
            raise ValueError(
                f"Family 2 requires (n,k,r)=(3z,2z-1,3); got ({n},{k},{r})"
            )
        self.z = n // 3
        super().__init__(n, k, r, alpha=2)

    # ------------------------------------------------------------------
    def _dual_two_racks(self, s_set: int, rack_i: int, rack_h: int, failed: int):
        """Dual codeword of the per-set code supported on racks i∪h, h_f != 0."""
        pl = self.placement
        dual = gf.gf_nullspace(self.set_gens[s_set].T)  # rows h: h @ G_t = 0
        outside = [
            u
            for u in range(self.n)
            if pl.rack_of(u) not in (rack_i, rack_h)
        ]
        combo_ns = gf.gf_nullspace(dual[:, outside].T)  # combos vanishing outside
        if combo_ns.shape[0] == 0:
            return None
        for c in combo_ns:
            h = gf.gf_matmul(c.reshape(1, -1), dual).ravel()
            if h[failed] != 0:
                return h
        # try random combos in the surviving space
        rng = gf.GFRandom(seed=failed * 131 + s_set)
        for _ in range(64):
            c = rng.any((1, combo_ns.shape[0]))
            h = gf.gf_matmul(gf.gf_matmul(c, combo_ns), dual).ravel()
            if h[failed] != 0 and not h[outside].any():
                return h
        return None

    def repair_plan(self, failed: int, rotation: int = 0) -> RepairPlan:
        pl = self.placement
        rack_f = pl.rack_of(failed)
        helper_racks = pl.other_racks(rack_f)
        # balanced assignment: set s -> helper rack (rotated by failed rack for
        # cluster-level balance when repairing many stripes)
        assignments = [
            (0, helper_racks[0], 1, helper_racks[1]),
            (0, helper_racks[1], 1, helper_racks[0]),
        ]
        last_err = None
        for a0_set, a0_rack, a1_set, a1_rack in assignments:
            try:
                return self._plan_with_assignment(
                    failed, {a0_set: a0_rack, a1_set: a1_rack}, rotation
                )
            except ValueError as e:  # degenerate dual; try the swap
                last_err = e
        raise ValueError(f"no feasible Family-2 plan for node {failed}: {last_err}")

    def _plan_with_assignment(
        self, failed: int, set_to_rack: dict[int, int], rotation: int = 0
    ) -> RepairPlan:
        pl = self.placement
        rack_f = pl.rack_of(failed)
        duals = {}
        for s_set, rack_h in set_to_rack.items():
            h = self._dual_two_racks(s_set, rack_f, rack_h, failed)
            if h is None:
                raise ValueError(f"no dual codeword for set {s_set} rack {rack_h}")
            duals[s_set] = h

        node_sends: list[Send] = []
        relayer_sends: list[Send] = []

        # local rack-mates ship both raw subblocks (inner-rack)
        locals_ = pl.rack_mates(failed)
        for u in locals_:
            node_sends.append(Send(u, TARGET, np.eye(2, dtype=np.uint8)))

        # helper racks: repair-by-transfer into the relayer, combine, ship one
        relayer_units: dict[int, np.ndarray] = {}
        for s_set, rack_h in sorted(set_to_rack.items()):
            h = duals[s_set]
            nodes = pl.nodes_in_rack(rack_h)
            relayer = nodes[(failed + rotation) % len(nodes)]  # per-stripe rotation
            mates = [u for u in nodes if u != relayer]
            sel = np.zeros((1, 2), dtype=np.uint8)
            sel[0, s_set] = 1  # raw set-s subblock, no arithmetic
            for u in mates:
                node_sends.append(Send(u, relayer, sel.copy()))
            # relayer input = [own 2 subblocks] ++ [mates' raw units in src order]
            in_dim = 2 + len(mates)
            m = np.zeros((1, in_dim), dtype=np.uint8)
            m[0, s_set] = h[relayer]
            for pos, u in enumerate(sorted(mates)):
                m[0, 2 + pos] = h[u]
            relayer_sends.append(Send(relayer, TARGET, m))
            relayer_units[s_set] = h

        # ---------------- decode at target ----------------
        # target input order: local raw units (src asc) then relayer units
        # (src asc).  Build coefficient rows and solve for G_failed.
        coeffs = self.all_node_coeffs()
        rows = []
        for u in sorted(locals_):
            rows.append(coeffs[u])
        for s in sorted(relayer_sends, key=lambda x: x.src):
            inputs = [coeffs[s.src]]
            for ns in sorted(
                (x for x in node_sends if x.dst == s.src), key=lambda x: x.src
            ):
                inputs.append(gf.gf_matmul(ns.matrix, coeffs[ns.src]))
            rows.append(gf.gf_matmul(s.matrix, np.concatenate(inputs, axis=0)))
        stacked = np.concatenate(rows, axis=0)
        decode = gf.gf_solve(stacked.T, coeffs[failed].T).T
        return RepairPlan(
            failed=failed,
            placement=pl,
            alpha=2,
            node_sends=node_sends,
            relayer_sends=relayer_sends,
            decode=np.ascontiguousarray(decode),
            target_order=build_target_order(node_sends, relayer_sends),
            family=self.name,
        )

    def theoretical_cross_rack_blocks(self) -> float:
        return drc_min_cross_rack_blocks(self.n, self.k, self.r)
