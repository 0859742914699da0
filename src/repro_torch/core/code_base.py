"""Erasure-code abstraction shared by RS / MSR / DRC (paper §3–§4).

Every code is linear over GF(2^8) with subpacketization α: node i stores α
subblocks, each a GF(256)-linear combination of the k·α data subsymbols.  The
whole code is a systematic generator matrix

    G ∈ GF(256)^{nα × kα},   G[:kα] = I   (systematic, Goal 2)

plus per-failed-node `RepairPlan`s (see repro_torch.core.repair).  Encoding,
decoding and repairing real payloads are all GF matrix products on device
tensors, run by the CUDA kernel behind ``repro_torch.kernels.ops.gf_matmul``;
the matrices themselves stay numpy.
"""
from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import ops

from . import gf
from .placement import Placement
from .repair import RepairPlan


class ErasureCode:
    """Base class. Subclasses set name/n/k/alpha, build G and repair plans."""

    name: str = "base"

    def __init__(self, n: int, k: int, r: int, alpha: int):
        if not (0 < k < n):
            raise ValueError(f"need 0<k<n, got n={n} k={k}")
        self.n = n
        self.k = k
        self.alpha = alpha
        self.placement = Placement(n, r)
        self.generator = self._build_generator()
        expected = (n * alpha, k * alpha)
        if self.generator.shape != expected:
            raise ValueError(f"generator shape {self.generator.shape} != {expected}")
        if not np.array_equal(
            self.generator[: k * alpha], np.eye(k * alpha, dtype=np.uint8)
        ):
            raise ValueError("generator is not systematic")

    # -------------------------------------------------------------- virtuals
    def _build_generator(self) -> np.ndarray:
        raise NotImplementedError

    def repair_plan(self, failed: int, rotation: int = 0) -> RepairPlan:
        """`rotation` rotates relayer/helper choices across stripes
        (paper §5.2 node-recovery parallelization); codes without
        relayers may ignore it."""
        raise NotImplementedError

    # ------------------------------------------------------------ properties
    @property
    def r(self) -> int:
        return self.placement.r

    @property
    def params(self) -> tuple[int, int, int]:
        return (self.n, self.k, self.r)

    def __repr__(self) -> str:
        return f"{self.name}({self.n},{self.k},{self.r})"

    def node_coeffs(self, i: int) -> np.ndarray:
        """(alpha, k*alpha) generator rows of node i."""
        return self.generator[i * self.alpha : (i + 1) * self.alpha]

    def all_node_coeffs(self) -> list[np.ndarray]:
        return [self.node_coeffs(i) for i in range(self.n)]

    @property
    def storage_overhead(self) -> float:
        return self.n / self.k

    # ---------------------------------------------------------------- encode
    def encode(self, data: torch.Tensor) -> list[torch.Tensor]:
        """Encode data bytes into n node payloads.

        data: (k*alpha, sub_bytes) uint8 tensor — k blocks split into alpha
        subblocks each.  Returns [n x (alpha, sub_bytes)] views of one coded
        tensor on data's device.
        """
        if data.ndim != 2 or data.shape[0] != self.k * self.alpha:
            raise ValueError(f"data must be (k*alpha, sub_bytes), got {tuple(data.shape)}")
        coded = ops.gf_matmul(self.generator, data)
        return [
            coded[i * self.alpha : (i + 1) * self.alpha] for i in range(self.n)
        ]

    def encode_blocks(self, blocks: torch.Tensor) -> list[torch.Tensor]:
        """Encode k equal-size blocks: (k, block_bytes) -> n node payloads."""
        k, bb = blocks.shape
        if k != self.k or bb % self.alpha:
            raise ValueError(f"need ({self.k}, multiple of alpha) blocks")
        data = blocks.reshape(self.k * self.alpha, bb // self.alpha)
        return self.encode(data)

    # ---------------------------------------------------------------- decode
    @functools.lru_cache(maxsize=512)
    def _decode_matrix(self, available: tuple[int, ...]) -> np.ndarray:
        """Matrix reconstructing all k*alpha data subsymbols from the stacked
        subblocks of `available` nodes (any set whose rows have full rank)."""
        rows = np.concatenate([self.node_coeffs(i) for i in available], axis=0)
        # Solve rows @ X = I  ->  want D with D @ rows = I:  D = solve(rows^T x = e)
        d = gf.gf_solve(rows.T, np.eye(self.k * self.alpha, dtype=np.uint8))
        return np.ascontiguousarray(d.T)

    def decode(self, available: dict[int, torch.Tensor]) -> torch.Tensor:
        """Reconstruct the (k*alpha, sub_bytes) data from >=k available nodes."""
        ids = tuple(sorted(available))
        dm = self._decode_matrix(ids)
        stacked = torch.cat([available[i] for i in ids], dim=0)
        return ops.gf_matmul(dm, stacked)

    # ------------------------------------------------------------ validation
    def is_mds(self, exhaustive_limit: int = 512, seed: int = 0) -> bool:
        """Any k nodes must carry full-rank (k*alpha) coefficient rows."""
        combos = list(itertools.combinations(range(self.n), self.k))
        if len(combos) > exhaustive_limit:
            rng = np.random.default_rng(seed)
            combos = [
                tuple(sorted(rng.choice(self.n, size=self.k, replace=False)))
                for _ in range(exhaustive_limit)
            ]
        need = self.k * self.alpha
        for c in combos:
            rows = np.concatenate([self.node_coeffs(i) for i in c], axis=0)
            if gf.gf_rank(rows) != need:
                return False
        return True

    def verify_repair(self, failed: int) -> bool:
        plan = self.repair_plan(failed)
        return plan.coefficient_check(self.all_node_coeffs())

    # --------------------------------------------------------- repair helper
    def repair(self, failed: int, payloads: dict[int, torch.Tensor]) -> torch.Tensor:
        return self.repair_plan(failed).execute(payloads)

    # ------------------------------------------------- closed-form bandwidth
    def theoretical_cross_rack_blocks(self) -> float:
        """Paper Eq. (1)/(2)/(3) — overridden per family."""
        raise NotImplementedError


@dataclass(frozen=True)
class CodeSpec:
    """Registry key: code family + (n, k, r)."""

    family: str
    n: int
    k: int
    r: int

    def __str__(self) -> str:
        return f"{self.family}({self.n},{self.k},{self.r})"


def drc_min_cross_rack_blocks(n: int, k: int, r: int) -> float:
    """Paper Eq. (3): minimum cross-rack repair bandwidth, in blocks."""
    return (r - 1) / (r - (k * r) // n)


def msr_repair_blocks(n: int, k: int) -> float:
    """Paper Eq. (2): MSR total repair bandwidth (d = n-1), in blocks."""
    return (n - 1) / (n - k)


def rs_repair_blocks(k: int) -> float:
    """Paper Eq. (1), in blocks."""
    return float(k)
