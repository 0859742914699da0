"""DRC Family 1: DRC(n, k, n/(n-k)) — paper §4.2 (interference alignment).

Construction (paper): split each block into m = n-k subblocks; the
subblocks at the same offset across the k data blocks form a *set*
(m sets); each set is independently encoded with a systematic Cauchy-RS
(n, k) code.  Node i stores the i-th symbol of every set.  n blocks are
placed across r = n/m racks of m nodes each (k = (r-1)·m data nodes fill
r-1 racks; the parity nodes fill the last rack).

Repair (generic interference-alignment solver).  For failed node f:

* rack-mates of f ship their full blocks (inner-rack);
* in every non-local rack, each non-relayer node ships `budget` encoded
  subblock(s) c_u·(its m subblocks) to the rack's relayer (inner-rack);
* each relayer ships exactly m re-encoded subblocks cross-rack (Goal 8),
  so the cross-rack traffic is (r-1)·m·(B/m) = (r-1)·B — Eq. (3)'s minimum
  for r = n/(n-k).

The alignment condition is that G_f's rows lie in the span of
[locals ∪ relayer-own rows ∪ {c_u G_u}].  We solve for the c_u directions
with the dual method: let Q span the nullspace of the fixed rows; the
residual nullspace after adding the tunable rows must sit inside
Null(G_f·). We pick a random v*-dimensional subspace V* of that null space
(v* = dim Null(fixed) - #tunables) and constrain every c_u to annihilate
V*'s image W_u = G_u Qᵀ — a *linear* condition on c_u.  Randomize-and-
verify handles degeneracies; `budget` auto-increases for parameter sets
where one subblock per non-relayer cannot absorb the alignment constraints
(all of the paper's deployed configs — (6,4,3), (8,6,4), (9,6,3) — work at
budget 1, which is what Goal 7 'relayer-in ≤ relayer-out' requires).

For the paper's per-node walk-through of (9,6,3) see §4.2; this module
reproduces those bandwidth numbers exactly (tests/test_codes.py).
"""
from __future__ import annotations

import functools

import numpy as np

from .. import gf
from ..code_base import drc_min_cross_rack_blocks
from ..repair import TARGET, RepairPlan, Send, build_target_order
from .stripwise import StripwiseRS


class DRCFamily1(StripwiseRS):
    name = "DRC"

    def __init__(self, n: int, k: int, r: int | None = None):
        m = n - k
        if n % m:
            raise ValueError(f"Family 1 needs (n-k) | n; got ({n},{k})")
        want_r = n // m
        if r is not None and r != want_r:
            raise ValueError(f"Family 1 fixes r = n/(n-k) = {want_r}; got {r}")
        if m < 2:
            raise ValueError("n-k must be >= 2 (use RS otherwise)")
        super().__init__(n, k, want_r, alpha=m)

    # ------------------------------------------------------------------
    @functools.lru_cache(maxsize=64)
    def repair_plan(self, failed: int, rotation: int = 0) -> RepairPlan:  # type: ignore[override]
        """Find the lowest-inner-traffic feasible alignment.

        Non-relayer budgets (encoded subblocks shipped to the rack relayer)
        start at 1 each and are escalated one unit at a time, round-robin
        across racks, up to the full block.  Goal 7 (relayer-in ≤
        relayer-out = m units) holds as long as the per-rack total stays
        ≤ m; the paper's deployed configs (6,4,3)/(9,6,3) resolve at 1 per
        node and (8,6,4) at one full block — all within the Goal-7 cap.
        """
        pl, m = self.placement, self.alpha
        # Data-node repair: the paper's structured interference alignment
        # (§4.2) — budget exactly 1 per non-relayer, Goal 7 tight.
        if failed < self.k:
            for attempt in range(8):
                plan = self._structured_data_plan(failed, seed=attempt, rotation=rotation)
                if plan is not None:
                    return plan
        # Parity nodes (and any degenerate draw): generic escalation solver.
        racks = pl.other_racks(pl.rack_of(failed))
        max_extra = len(racks) * (m - 1) * (m - 1)
        for extra in range(max_extra + 1):
            for attempt in range(6):
                plan = self._try_plan(
                    failed, extra, seed=attempt * 977 + failed * 13 + extra,
                    rotation=rotation,
                )
                if plan is not None:
                    return plan
        raise ValueError(f"no feasible Family-1 alignment for node {failed}")

    # -------------------------------------------------- structured (paper)
    def _coord(self, node: int, t: int) -> int:
        """Data-coordinate index of data node `node`, set t."""
        return node * self.alpha + t

    def _structured_data_plan(
        self, failed: int, seed: int, rotation: int = 0
    ) -> RepairPlan | None:
        """Paper §4.2 alignment, generalized.

        e_1 is a combination of the parity relayer's own subblocks; every
        further unit e_q adds exactly one parity mate's single combination,
        tuned (inhomogeneous square solve) so that e_q's projection onto
        every *far* data node equals e_1's.  Far mates then ship that very
        projection as their single combo; data-rack relayers reproduce
        proj_{rack}(e_j) from [own block ++ mate combos]; the target strips
        locals and per-rack units from e_j, leaving an m×m system on the
        failed node's subblocks.
        """
        pl, m = self.placement, self.alpha
        rng = gf.GFRandom(seed * 7919 + failed)
        coeffs = self.all_node_coeffs()
        rack_f = pl.rack_of(failed)
        parity_rack = pl.r - 1
        if rack_f == parity_rack:
            return None
        locals_ = sorted(pl.rack_mates(failed))
        data_racks = [
            t for t in pl.other_racks(rack_f) if t != parity_rack
        ]
        w = pl.nodes_in_rack(parity_rack)[(failed + rotation) % m]  # parity relayer
        w_mates = sorted(u for u in pl.nodes_in_rack(parity_rack) if u != w)
        relayer_of = {
            t: pl.nodes_in_rack(t)[(failed + rotation) % m] for t in data_racks
        }
        far = sorted(
            u
            for t in data_racks
            for u in pl.nodes_in_rack(t)
            if u != relayer_of[t]
        )
        far_coords = [self._coord(u, t) for u in far for t in range(m)]

        g_w = coeffs[w]  # (m, D)
        sigma = rng.nonzero((1, m))
        e = [gf.gf_matmul(sigma, g_w).ravel()]  # e_1
        # far-mate combos: c_u = proj_u(e_1); every later e_q must align to
        # a *scalar multiple* of c_u on node u's coordinates (the relayer
        # rescales each received combo independently per sent unit).
        c_far = {
            u: e[0][[self._coord(u, t) for t in range(m)]].reshape(1, -1)
            for u in far
        }
        if any(not c_far[u].any() for u in far):
            return None
        lambdas: dict[tuple[int, int], int] = {(0, u): 1 for u in far}

        d_combos: dict[int, np.ndarray] = {}
        for qi, wq in enumerate(w_mates):
            # homogeneous system in (gamma, d, lambda_u):
            #   proj_far(gamma·G_w + d·G_wq) - sum_u lambda_u·c_u|_u = 0
            nfar = len(far)
            a = np.zeros((len(far_coords), 2 * m + nfar), dtype=np.uint8)
            a[:, :m] = g_w[:, far_coords].T
            a[:, m : 2 * m] = coeffs[wq][:, far_coords].T
            for ui, u in enumerate(far):
                for t in range(m):
                    a[ui * m + t, 2 * m + ui] = c_far[u][0, t]
            kernel = gf.gf_nullspace(a)  # rows = solutions
            # pick a kernel element with d != 0
            cand = [v for v in kernel if v[m : 2 * m].any()]
            if not cand:
                return None
            mix = rng.any((1, len(cand)))
            sol = gf.gf_matmul(mix, np.stack(cand, axis=0)).ravel()
            if not sol[m : 2 * m].any():
                sol = cand[0]
            gamma, d, lam = sol[:m], sol[m : 2 * m], sol[2 * m :]
            e_q = gf.gf_matmul(gamma.reshape(1, -1), g_w) ^ gf.gf_matmul(
                d.reshape(1, -1), coeffs[wq]
            )
            e.append(e_q.ravel())
            d_combos[wq] = d.reshape(1, -1)
            for ui, u in enumerate(far):
                lambdas[(qi + 1, u)] = int(lam[ui])
        e_mat = np.stack(e, axis=0)  # (m, D)

        # failed-node projection matrix must be invertible
        m_proj = e_mat[:, [self._coord(failed, t) for t in range(m)]]
        if gf.gf_rank(m_proj) < m:
            return None
        m_inv = gf.gf_inv_matrix(m_proj)

        node_sends: list[Send] = []
        for u in locals_:
            node_sends.append(Send(u, TARGET, np.eye(m, dtype=np.uint8)))
        for t in data_racks:
            for u in pl.nodes_in_rack(t):
                if u != relayer_of[t]:
                    node_sends.append(Send(u, relayer_of[t], c_far[u].copy()))
        for wq in w_mates:
            node_sends.append(Send(wq, w, d_combos[wq].copy()))

        relayer_sends: list[Send] = []
        # data-rack relayers: s^b_j = proj_{R_b}(e_j)
        for t in data_racks:
            v = relayer_of[t]
            mates = sorted(u for u in pl.nodes_in_rack(t) if u != v)
            rmat = np.zeros((m, m + len(mates)), dtype=np.uint8)
            for j in range(m):
                rmat[j, :m] = e_mat[j, [self._coord(v, tt) for tt in range(m)]]
                for mi, u in enumerate(mates):
                    rmat[j, m + mi] = lambdas[(j, u)]
            relayer_sends.append(Send(v, TARGET, rmat))
        # parity relayer: express e_j over [own rows ++ received mate units]
        pmat = self._parity_relayer_matrix(e_mat, coeffs, w, w_mates, d_combos)
        if pmat is None:
            return None
        relayer_sends.append(Send(w, TARGET, pmat))

        # ---- decode ----
        # target units: locals raw (m each, src asc), then relayer units
        # (src asc; data relayers and the parity relayer interleaved by id).
        unit_srcs: list[tuple[int, int]] = []  # (src, row)
        for u in sorted(locals_):
            unit_srcs += [(u, j) for j in range(m)]
        for s in sorted(relayer_sends, key=lambda x: x.src):
            unit_srcs += [(s.src, j) for j in range(m)]
        n_units = len(unit_srcs)
        c = np.zeros((m, n_units), dtype=np.uint8)
        for j in range(m):
            for pos, (src, row) in enumerate(unit_srcs):
                if src == w and row == j:
                    c[j, pos] = 1
                elif src in relayer_of.values() and row == j:
                    c[j, pos] = 1  # subtract s^b_j (char 2)
                elif src in locals_:
                    c[j, pos] = e_mat[j, self._coord(src, row)]
        decode = gf.gf_matmul(m_inv, c)

        plan = RepairPlan(
            failed=failed,
            placement=pl,
            alpha=m,
            node_sends=node_sends,
            relayer_sends=relayer_sends,
            decode=decode,
            target_order=build_target_order(node_sends, relayer_sends),
            family=self.name,
        )
        if not plan.coefficient_check(coeffs):
            return None
        return plan

    def _parity_relayer_matrix(self, e_mat, coeffs, w, w_mates, d_combos):
        """Express e_j over [w's own rows ++ received mate units]."""
        basis = [coeffs[w]]
        for wq in sorted(w_mates):
            basis.append(gf.gf_matmul(d_combos[wq], coeffs[wq]))
        stack = np.concatenate(basis, axis=0)
        try:
            x = gf.gf_solve(stack.T, e_mat.T)
        except np.linalg.LinAlgError:
            return None
        return np.ascontiguousarray(x.T)

    def _budgets(self, failed: int, extra: int, rotation: int = 0) -> dict[int, int] | None:
        """Per-non-relayer unit budgets: all 1 plus `extra` units assigned
        round-robin across racks (capped at a full block of m units)."""
        pl, m = self.placement, self.alpha
        racks = pl.other_racks(pl.rack_of(failed))
        relayers = {
            t: pl.nodes_in_rack(t)[(failed + rotation) % m] for t in racks
        }
        order = [
            u
            for _ in range(m - 1)
            for t in racks
            for u in pl.nodes_in_rack(t)
            if u != relayers[t]
        ]
        budgets = {u: 1 for t in racks for u in pl.nodes_in_rack(t) if u != relayers[t]}
        for i in range(extra):
            if i >= len(order):
                return None
            budgets[order[i]] += 1
            if budgets[order[i]] > m:
                return None
        return budgets

    def _try_plan(
        self, failed: int, extra: int, seed: int, rotation: int = 0
    ) -> RepairPlan | None:
        pl, m = self.placement, self.alpha
        rng = gf.GFRandom(seed)
        rack_f = pl.rack_of(failed)
        coeffs = self.all_node_coeffs()
        g_f = coeffs[failed]

        budgets = self._budgets(failed, extra, rotation)
        if budgets is None:
            return None
        locals_ = sorted(pl.rack_mates(failed))
        racks = pl.other_racks(rack_f)
        relayers = {
            t: pl.nodes_in_rack(t)[(failed + rotation) % m] for t in racks
        }
        nonrelayers = {
            t: [u for u in pl.nodes_in_rack(t) if u != relayers[t]] for t in racks
        }

        fixed_rows = [coeffs[u] for u in locals_] + [coeffs[relayers[t]] for t in racks]
        fixed = np.concatenate(fixed_rows, axis=0)
        q_basis = gf.gf_nullspace(fixed)  # (q, D)
        q = q_basis.shape[0]
        tunable_nodes = [u for t in racks for u in nonrelayers[t]]
        n_tun = sum(budgets[u] for u in tunable_nodes)
        vstar_dim = max(q - n_tun, 0)

        c_vecs: dict[int, np.ndarray] = {}
        if vstar_dim == 0:
            for u in tunable_nodes:
                c_vecs[u] = rng.nonzero((budgets[u], m))
        else:
            if any(vstar_dim > m - budgets[u] for u in tunable_nodes):
                return None  # cannot absorb alignment at these budgets
            # V* = random subspace of Null(F) where F = G_f @ Q^T
            f_mat = gf.gf_matmul(g_f, q_basis.T)  # (m, q)
            null_f = gf.gf_nullspace(f_mat)  # (q - p, q) rows: beta with F beta = 0
            if null_f.shape[0] < vstar_dim:
                return None
            mix = rng.any((vstar_dim, null_f.shape[0]))
            b_star = gf.gf_matmul(mix, null_f)  # (v*, q)
            if gf.gf_rank(b_star) < vstar_dim:
                return None
            for u in tunable_nodes:
                bu = budgets[u]
                w_u = gf.gf_matmul(coeffs[u], q_basis.T)  # (m, q)
                cond = gf.gf_matmul(w_u, b_star.T)  # (m, v*): need c_u @ cond = 0
                space = gf.gf_nullspace(cond.T)  # rows: valid c_u
                if space.shape[0] < bu:
                    return None
                mixu = rng.any((bu, space.shape[0]))
                cu = gf.gf_matmul(mixu, space)
                if gf.gf_rank(cu) < bu:
                    cu = space[:bu]
                c_vecs[u] = cu

        tun_rows = [gf.gf_matmul(c_vecs[u], coeffs[u]) for u in tunable_nodes]
        all_rows = np.concatenate([fixed] + tun_rows, axis=0) if tun_rows else fixed
        # feasibility: G_f in span(all rows)
        try:
            x = gf.gf_solve(all_rows.T, g_f.T)  # (rows, m): all^T x = G_f^T
        except np.linalg.LinAlgError:
            return None
        xt = x.T  # (m, rows): G_f = xt @ all_rows

        # ---- assemble plan ----
        node_sends: list[Send] = []
        for u in locals_:
            node_sends.append(Send(u, TARGET, np.eye(m, dtype=np.uint8)))
        for t in racks:
            for u in nonrelayers[t]:
                node_sends.append(Send(u, relayers[t], c_vecs[u].copy()))

        # column ranges of all_rows per provenance
        col = 0
        col_of: dict[tuple[str, int], tuple[int, int]] = {}
        for u in locals_:
            col_of[("local", u)] = (col, col + m)
            col += m
        for t in racks:
            col_of[("rel", relayers[t])] = (col, col + m)
            col += m
        for u in tunable_nodes:
            col_of[("tun", u)] = (col, col + budgets[u])
            col += budgets[u]

        relayer_sends: list[Send] = []
        for t in racks:
            v = relayers[t]
            mates = sorted(nonrelayers[t])
            in_dim = m + sum(budgets[u] for u in mates)
            rmat = np.zeros((m, in_dim), dtype=np.uint8)
            lo, hi = col_of[("rel", v)]
            rmat[:, :m] = xt[:, lo:hi]
            off = m
            for u in mates:
                lo, hi = col_of[("tun", u)]
                rmat[:, off : off + budgets[u]] = xt[:, lo:hi]
                off += budgets[u]
            relayer_sends.append(Send(v, TARGET, rmat))

        # decode: local raw units use xt coefficients; relayer units are the
        # pre-aggregated per-rack contributions -> identity coefficients.
        n_target_units = m * len(locals_) + m * len(racks)
        decode = np.zeros((m, n_target_units), dtype=np.uint8)
        pos = 0
        for u in sorted(locals_):
            lo, hi = col_of[("local", u)]
            decode[:, pos : pos + m] = xt[:, lo:hi]
            pos += m
        for v in sorted(relayers[t] for t in racks):
            decode[:, pos : pos + m] = np.eye(m, dtype=np.uint8)
            pos += m

        plan = RepairPlan(
            failed=failed,
            placement=pl,
            alpha=m,
            node_sends=node_sends,
            relayer_sends=relayer_sends,
            decode=decode,
            target_order=build_target_order(node_sends, relayer_sends),
            family=self.name,
        )
        if not plan.coefficient_check(coeffs):
            return None
        return plan

    def theoretical_cross_rack_blocks(self) -> float:
        return drc_min_cross_rack_blocks(self.n, self.k, self.r)
