"""Markov MTTDL reliability analysis (paper §3.4, Tables 1 and 2).

States count healthy nodes: n (all healthy) down to k-1 (data loss,
absorbing).  Independent node failures move i -> i-1 at rate i·λ1.
Correlated (rack power-outage) failures act only from the all-healthy
state: with w = n/r nodes per rack, a j-node correlated failure in one of
r racks has rate r·C(w,j)·λ2^j (the paper's 9λ2 / 9λ2² / 3λ2³ cases for
(9,6,3)).  Repair of a single failure runs at μ = γ/(C·S) with C the
repair bandwidth per unit of repaired data (C = 8/3 for MSR(9,6) flat,
C = 2 for DRC(9,6,3)); deeper states repair one node at a time at
μ' = γ/(k·S).

MTTDL is the expected absorption time from state n, solved exactly from
the embedded linear system (no simulation).
A copy of ``repro.core.analysis.reliability``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

SECONDS_PER_YEAR = 365.25 * 24 * 3600


@dataclass
class MTTDLModel:
    n: int = 9
    k: int = 6
    r: int = 9  # racks; r == n -> flat placement
    mttf_years: float = 4.0  # 1/λ1
    lambda2: float = 0.0  # correlated per-node failure rate (per year)
    gamma_gbps: float = 1.0  # available cross-rack bandwidth
    node_capacity_tib: float = 1.0  # S
    c_single: float = 8.0 / 3.0  # repair bw per unit data, single failure
    c_multi: float | None = None  # defaults to k (MDS whole-stripe repair)

    def _mu(self, c: float) -> float:
        """Repair rate (per year) for repair cost c·S at γ Gb/s."""
        bits = c * self.node_capacity_tib * (2**40) * 8
        seconds = bits / (self.gamma_gbps * 1e9)
        return SECONDS_PER_YEAR / seconds

    def mttdl_years(self) -> float:
        n, k = self.n, self.k
        lam1 = 1.0 / self.mttf_years
        lam2 = self.lambda2
        w = n // self.r
        mu_single = self._mu(self.c_single)
        mu_multi = self._mu(self.c_multi if self.c_multi is not None else self.k)

        states = list(range(n, k - 1, -1))  # transient: n .. k
        idx = {s: i for i, s in enumerate(states)}
        m = len(states)
        # Q[i][j]: rate from state i to state j (transient only);
        # absorption rate folds into the diagonal.
        q = np.zeros((m, m))
        out = np.zeros(m)
        for s in states:
            i = idx[s]
            # independent failures
            rate = s * lam1
            out[i] += rate
            if s - 1 >= k:
                q[i, idx[s - 1]] += rate
            # correlated failures from the all-healthy state only
            if s == n and lam2 > 0:
                for j in range(1, w + 1):
                    rate = self.r * math.comb(w, j) * (lam2**j)
                    out[i] += rate
                    if s - j >= k:
                        q[i, idx[s - j]] += rate
            # repairs
            if s < n:
                mu = mu_single if s == n - 1 else mu_multi
                out[i] += mu
                q[i, idx[s + 1]] += mu
        # T_i = 1/out_i + sum_j (q_ij/out_i) T_j  ->  (I - P) T = 1/out
        p = q / out[:, None]
        t = np.linalg.solve(np.eye(m) - p, 1.0 / out)
        return float(t[idx[n]])


def _model(flat: bool, correlated: bool, mttf: float, gamma: float) -> MTTDLModel:
    if flat:
        return MTTDLModel(
            r=9,
            c_single=8.0 / 3.0,  # MSR(9,6) flat, Eq. (2)
            mttf_years=mttf,
            lambda2=0.005 if correlated else 0.0,
            gamma_gbps=gamma,
        )
    return MTTDLModel(
        r=3,
        c_single=2.0,  # DRC(9,6,3), Eq. (3)
        mttf_years=mttf,
        lambda2=0.005 if correlated else 0.0,
        gamma_gbps=gamma,
    )


def table1_rows(gamma_gbps: float = 1.0) -> dict[str, list[float]]:
    """Paper Table 1: vary 1/λ1 in years at γ = 1 Gb/s."""
    mttfs = [2, 4, 6, 8, 10]
    return {
        "mttf_years": mttfs,
        "flat_no_corr": [_model(True, False, m, gamma_gbps).mttdl_years() for m in mttfs],
        "flat_corr": [_model(True, True, m, gamma_gbps).mttdl_years() for m in mttfs],
        "hier_no_corr": [_model(False, False, m, gamma_gbps).mttdl_years() for m in mttfs],
        "hier_corr": [_model(False, True, m, gamma_gbps).mttdl_years() for m in mttfs],
    }


def table2_rows(mttf_years: float = 4.0) -> dict[str, list[float]]:
    """Paper Table 2: vary γ in Gb/s at 1/λ1 = 4 years."""
    gammas = [0.2, 0.5, 1.0, 2.0]
    return {
        "gamma_gbps": gammas,
        "flat_no_corr": [_model(True, False, mttf_years, g).mttdl_years() for g in gammas],
        "flat_corr": [_model(True, True, mttf_years, g).mttdl_years() for g in gammas],
        "hier_no_corr": [_model(False, False, mttf_years, g).mttdl_years() for g in gammas],
        "hier_corr": [_model(False, True, mttf_years, g).mttdl_years() for g in gammas],
    }


# The paper's published values, used as regression targets (±15%: the
# paper does not state its exact TiB/year unit conventions).
PAPER_TABLE1 = {
    "flat_no_corr": [2.56e6, 4.08e7, 2.06e8, 6.52e8, 1.59e9],
    "flat_corr": [2.54e6, 4.00e7, 2.00e8, 6.27e8, 1.51e9],
    "hier_no_corr": [3.41e6, 5.44e7, 2.75e8, 8.69e8, 2.12e9],
    "hier_corr": [3.28e6, 4.69e7, 1.96e8, 4.81e8, 8.80e8],
}
PAPER_TABLE2 = {
    "flat_no_corr": [3.32e5, 5.12e6, 4.08e7, 3.26e8],
    "flat_corr": [3.26e5, 5.02e6, 4.00e7, 3.19e8],
    "hier_no_corr": [4.42e5, 6.82e6, 5.44e7, 4.34e8],
    "hier_corr": [4.25e5, 6.33e6, 4.69e7, 3.09e8],
}
