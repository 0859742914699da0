"""GF(2^8) arithmetic of the benchmark's plain reference, written apart from
the program under test.

A field is fixed by its reduction polynomial: 0x11D (x^8+x^4+x^3+x^2+1, the
one Intel ISA-L and the paper use) for the reference; the control uses another
one.  Small matrices are numpy uint8; payload bytes are torch uint8 tensors on
any device, multiplied by table lookups.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

ISA_L_POLY = 0x11D
CHUNK = 1 << 22  # payload columns per lookup pass: bounds the int64 index tensor


def carryless_mul(a: int, b: int, poly: int) -> int:
    """a * b in GF(2^8) by shift and add, reduced by ``poly``: the slow
    definition the tables are checked against."""
    out = 0
    while b:
        if b & 1:
            out ^= a
        b >>= 1
        a <<= 1
        if a & 0x100:
            a ^= poly
    return out


class Field:
    """GF(2^8) with reduction polynomial ``poly`` (degree 8)."""

    def __init__(self, poly: int = ISA_L_POLY):
        if not 0x100 <= poly < 0x200:
            raise ValueError(f"need a degree-8 polynomial, got {poly:#x}")
        self.poly = poly
        rows = [[carryless_mul(a, b, poly) for b in range(256)] for a in range(256)]
        self.mul = np.asarray(rows, dtype=np.uint8)
        inv = np.zeros(256, dtype=np.uint8)
        for a in range(1, 256):
            hits = np.flatnonzero(self.mul[a] == 1)
            if len(hits) != 1:
                raise ValueError(f"{poly:#x} is not irreducible: {a} has no inverse")
            inv[a] = hits[0]
        self.inv = inv
        self._device_tables: dict[str, torch.Tensor] = {}

    # ---------------------------------------------------- small matrices
    def matmul(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        a = np.asarray(a, dtype=np.uint8)
        b = np.asarray(b, dtype=np.uint8)
        out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
        for j in range(a.shape[1]):
            out ^= self.mul[a[:, j][:, None], b[j][None, :]]
        return out

    def inverse(self, a: np.ndarray) -> np.ndarray:
        """Inverse of a square matrix by Gauss-Jordan; raises if singular."""
        a = np.array(a, dtype=np.uint8)
        n = a.shape[0]
        aug = np.concatenate([a, np.eye(n, dtype=np.uint8)], axis=1)
        for col in range(n):
            pivots = np.flatnonzero(aug[col:, col]) + col
            if len(pivots) == 0:
                raise ValueError("singular matrix")
            p = pivots[0]
            aug[[col, p]] = aug[[p, col]]
            aug[col] = self.mul[self.inv[aug[col, col]], aug[col]]
            for row in range(n):
                if row != col and aug[row, col]:
                    aug[row] ^= self.mul[aug[row, col], aug[col]]
        return aug[:, n:]

    # ------------------------------------------------------ payload bytes
    def table(self, device: torch.device) -> torch.Tensor:
        key = str(device)
        if key not in self._device_tables:
            self._device_tables[key] = torch.from_numpy(self.mul.reshape(-1).copy()).to(device)
        return self._device_tables[key]

    def apply(self, m: np.ndarray, x: torch.Tensor) -> torch.Tensor:
        """(R, K) matrix over this field times (K, B) payload bytes -> (R, B),
        one table lookup and XOR per nonzero coefficient."""
        m = np.asarray(m, dtype=np.uint8)
        if x.dtype != torch.uint8 or x.ndim != 2 or x.shape[0] != m.shape[1]:
            raise ValueError(f"need ({m.shape[1]}, B) uint8 bytes, got {x.dtype} {tuple(x.shape)}")
        table = self.table(x.device)
        out = torch.zeros((m.shape[0], x.shape[1]), dtype=torch.uint8, device=x.device)
        for c0 in range(0, x.shape[1], CHUNK):
            c1 = min(c0 + CHUNK, x.shape[1])
            idx = x[:, c0:c1].long()
            for r in range(m.shape[0]):
                acc = out[r, c0:c1]
                for j in np.flatnonzero(m[r]).tolist():
                    acc ^= torch.take(table, idx[j] + 256 * int(m[r, j]))
        return out


@functools.lru_cache(maxsize=4)
def field(poly: int = ISA_L_POLY) -> Field:
    return Field(poly)
