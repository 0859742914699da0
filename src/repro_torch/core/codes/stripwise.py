"""Shared strip-wise RS generator for both DRC families (paper §4.2/§4.3).

Each block is split into α subblocks; subblocks at the same offset across
the k data blocks form a *set*; set t is encoded with a systematic
(n, k) RS code G^(t).  Node i stores the i-th symbol of every set.

The per-set generators are *distinct*: set t's parity block is a Cauchy
matrix on its own evaluation points, P^(t)[q, j] = 1/(x^(t)_q + y_j) with
x^(t)_q = k + t·(n-k) + q.  Each set is individually MDS (Cauchy), but the
sets are *geometrically independent* — this matters for the Family-1
interference alignment.  Two weaker twists fail structurally:

* row scaling (P^(t) = D_t·P): h ⊥ δp ⟺ h ⊥ p, so all sets present
  byte-identical orthogonality geometry;
* column scaling (P^(t) = P·D_t): the ratios ρ_t(u) = P^(t)[q',u]/P^(t)[q,u]
  between parity rows are scaling-invariant, which forces every aligned
  repair unit's projection onto the failed node into a single direction
  (rank-1 m_proj — alignment can never complete).

The paper's §4.2 example likewise tunes coefficients per set.  Requires
k + α·(n-k) ≤ 256 (all paper configurations are far below).
"""
from __future__ import annotations

import numpy as np

from .. import gf
from ..code_base import ErasureCode


class StripwiseRS(ErasureCode):
    """Generator: node i's subblock t = set-t RS symbol i (α sets)."""

    def _build_generator(self) -> np.ndarray:
        n, k, a = self.n, self.k, self.alpha
        if k + a * (n - k) > 256:
            raise ValueError(f"GF(256) too small for stripwise ({n},{k})x{a}")
        ys = np.arange(k, dtype=np.uint8)
        self.set_gens: list[np.ndarray] = []
        for t in range(a):
            xs = np.arange(k + t * (n - k), k + (t + 1) * (n - k), dtype=np.uint8)
            parity = gf.cauchy_matrix(xs, ys)
            gt = np.concatenate([np.eye(k, dtype=np.uint8), parity], axis=0)
            self.set_gens.append(gt)
        g = np.zeros((n * a, k * a), dtype=np.uint8)
        for i in range(n):
            for t in range(a):
                g[i * a + t, t::a] = self.set_gens[t][i]
        return g
