"""MSR codes with d = n-1 via coupled-layer (Ye-Barg / Clay) construction.

The paper's prototype uses Butterfly codes (n-k = 2) and MISER codes
(n = 2k) as its MSR baselines; both sit at the same operating point —
systematic MDS, d = n-1 helpers, repair bandwidth B(n-1)/(n-k) (Eq. (2)).
We implement that operating point once, for *any* (n, k) with (n-k) | n,
using the coupled-layer construction:

* s = n-k, m = n/s; nodes are a grid (x, y) ∈ [s]×[m], node id = y·s + x.
* Subpacketization α = s^m; symbol planes z ∈ [s]^m.
* Stored (coupled) symbols C(x,y; z).  Uncoupled symbols:
      U(x,y;z) = C(x,y;z)                      if z_y = x
      U(x,y;z) = C(x,y;z) + γ·C(z_y,y; z(y→x)) otherwise,
  a pairwise invertible transform for γ ∉ {0,1} in GF(2^8)
  (det [[1,γ],[γ,1]] = (1+γ)² in char 2).
* Every plane's n uncoupled symbols satisfy the s parity checks of a
  systematic Cauchy-RS(n,k) code.

Repair of node f = (x0,y0) reads the s^{m-1} planes with z_{y0} = x0;
every helper ships its *raw* symbols in those planes (optimal access,
β = α/s per helper), and the target solves the α×α plane-equation system
for f's symbols.  Bandwidth: (n-1)/(n-k) blocks — exactly Eq. (2); with
hierarchical placement (r < n) the cross-rack share is (n - n/r)/(n-k)
blocks, reproducing Theorem 1 for n-k=2, r=n/2.

The construction is *verified, not assumed*: __init__ searches a small γ
space until the MDS property and every node's repair both check out
(GF(2^8) is large enough that the first candidate virtually always works).
"""
from __future__ import annotations

import functools
import itertools

import numpy as np

from .. import gf
from ..code_base import ErasureCode, msr_repair_blocks
from ..repair import TARGET, RepairPlan, Send, build_target_order


@functools.lru_cache(maxsize=64)
def _construction(n: int, k: int) -> tuple[np.ndarray, int]:
    """Build (generator, gamma) for the coupled-layer MSR code."""
    s = n - k
    if n % s:
        raise ValueError(f"coupled-layer MSR needs (n-k) | n; got ({n},{k})")
    m = n // s
    alpha = s**m
    g_rs = gf.rs_generator(n, k)  # [I; P]
    h_rs = np.concatenate(  # H = [P | I], H @ G = 0 in char 2
        [g_rs[k:], np.eye(s, dtype=np.uint8)], axis=1
    )

    def digits(z: int) -> list[int]:
        out = []
        for _ in range(m):
            out.append(z % s)
            z //= s
        return out

    def with_digit(z: int, y: int, v: int) -> int:
        d = digits(z)
        d[y] = v
        out = 0
        for j in reversed(range(m)):
            out = out * s + d[j]
        return out

    def sym(i: int, z: int) -> int:
        return i * alpha + z

    for gamma in (2, 3, 7, 29, 113, 197):
        # constraint matrix over C-symbols: s checks per plane
        rows = []
        for z in range(alpha):
            dz = digits(z)
            # U(i; z) expressed over C-symbols
            u_expr = []
            for i in range(n):
                x, y = i % s, i // s
                expr = [(sym(i, z), 1)]
                if dz[y] != x:
                    j = y * s + dz[y]
                    zp = with_digit(z, y, x)
                    expr.append((sym(j, zp), gamma))
                u_expr.append(expr)
            for c in range(s):
                row = np.zeros(n * alpha, dtype=np.uint8)
                for i in range(n):
                    hc = int(h_rs[c, i])
                    if hc:
                        for col, coef in u_expr[i]:
                            row[col] ^= gf.gf_mul(hc, coef)
                rows.append(row)
        M = np.stack(rows, axis=0)  # (s*alpha, n*alpha)
        m_data, m_par = M[:, : k * alpha], M[:, k * alpha :]
        try:
            par_map = gf.gf_matmul(gf.gf_inv_matrix(m_par), m_data)
        except np.linalg.LinAlgError:
            continue
        gen = np.concatenate(
            [np.eye(k * alpha, dtype=np.uint8), par_map], axis=0
        )
        return gen, gamma
    raise RuntimeError(f"no feasible gamma for coupled-layer MSR({n},{k})")


class MSRCode(ErasureCode):
    name = "MSR"

    def __init__(self, n: int, k: int, r: int | None = None):
        s = n - k
        if n % s:
            raise ValueError(f"MSR (coupled-layer) needs (n-k) | n; got ({n},{k})")
        self.s = s
        self.m = n // s
        super().__init__(n, k, r if r is not None else n, alpha=s**self.m)

    def _build_generator(self) -> np.ndarray:
        gen, self.gamma = _construction(self.n, self.k)
        return gen

    # ------------------------------------------------------------------
    def _digits(self, z: int) -> list[int]:
        out, s = [], self.s
        for _ in range(self.m):
            out.append(z % s)
            z //= s
        return out

    def _repair_planes(self, failed: int) -> list[int]:
        x0, y0 = failed % self.s, failed // self.s
        return [z for z in range(self.alpha) if self._digits(z)[y0] == x0]

    @functools.lru_cache(maxsize=64)
    def _repair_decode(self, failed: int) -> np.ndarray:
        """Solve the plane equations for f's α symbols from helpers' raw
        repair-plane symbols.  Returns (alpha, (n-1)*beta) decode matrix
        with helper units ordered (node asc, plane asc)."""
        n, k, s, alpha = self.n, self.k, self.s, self.alpha
        planes = self._repair_planes(failed)
        beta = len(planes)
        helpers = [u for u in range(n) if u != failed]
        # column index of helper unit (u, z)
        ucol = {
            (u, z): hi * beta + zi
            for hi, u in enumerate(helpers)
            for zi, z in enumerate(planes)
        }
        # unknown index of f's symbols (all alpha planes)
        a_unk = np.zeros((s * beta, alpha), dtype=np.uint8)
        a_kno = np.zeros((s * beta, (n - 1) * beta), dtype=np.uint8)
        g_rs = gf.rs_generator(n, k)
        h_rs = np.concatenate([g_rs[k:], np.eye(s, dtype=np.uint8)], axis=1)
        gamma = self.gamma
        row = 0
        for z in planes:
            dz = self._digits(z)
            for c in range(s):
                for i in range(n):
                    hc = int(h_rs[c, i])
                    if not hc:
                        continue
                    x, y = i % s, i // s
                    # U(i; z) expansion
                    terms: list[tuple[int, int, int]] = [(i, z, 1)]  # (node, plane, coef)
                    if dz[y] != x:
                        j = y * s + dz[y]
                        zp = z - (dz[y] - x) * (s**y)  # with_digit(z, y, x)
                        terms.append((j, zp, gamma))
                    for node, plane, coef in terms:
                        v = gf.gf_mul(hc, coef)
                        if node == failed:
                            a_unk[row, plane] ^= v
                        else:
                            a_kno[row, ucol[(node, plane)]] ^= v
                row += 1
        # a_unk @ x_f = a_kno @ units  (char 2: moving terms is free)
        sol = gf.gf_solve(a_unk, a_kno)  # (alpha, (n-1)*beta)
        return np.ascontiguousarray(sol)

    def repair_plan(self, failed: int, rotation: int = 0) -> RepairPlan:
        planes = self._repair_planes(failed)
        beta = len(planes)
        sel = np.zeros((beta, self.alpha), dtype=np.uint8)
        for zi, z in enumerate(planes):
            sel[zi, z] = 1
        node_sends = [
            Send(u, TARGET, sel.copy()) for u in range(self.n) if u != failed
        ]
        return RepairPlan(
            failed=failed,
            placement=self.placement,
            alpha=self.alpha,
            node_sends=node_sends,
            relayer_sends=[],
            decode=self._repair_decode(failed),
            target_order=build_target_order(node_sends, []),
        )

    def theoretical_cross_rack_blocks(self) -> float:
        w = self.placement.nodes_per_rack
        return (self.n - w) / (self.n - self.k)

    def theoretical_total_blocks(self) -> float:
        return msr_repair_blocks(self.n, self.k)
