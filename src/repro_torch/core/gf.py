"""GF(2^8) arithmetic and linear algebra (plan-time, numpy).

This module is the *plan-time* arithmetic layer: repair plans, generator
matrices, interference-alignment solves and dual-codeword searches are all
small dense GF(256) linear algebra problems, computed once per (code, failed
node) and cached.  The *data path* (encoding/repairing real bytes) runs on
device tensors through `repro_torch.kernels.ops.gf_matmul` (the CUDA kernel
on the card, `repro_torch.core.gf_torch.gf_matmul_table` on the CPU).

Field: GF(2^8) with the AES/ISA-L primitive polynomial x^8+x^4+x^3+x^2+1
(0x11D), generator 2 — byte-compatible with Intel ISA-L used by the paper.
"""
from __future__ import annotations

import numpy as np

PRIM_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1
FIELD = 256
ORDER = FIELD - 1  # multiplicative group order


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(2 * ORDER, dtype=np.uint8)  # doubled to skip "mod 255"
    log = np.zeros(FIELD, dtype=np.int32)
    x = 1
    for i in range(ORDER):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= PRIM_POLY
    exp[ORDER:] = exp[:ORDER]
    log[0] = -1  # sentinel; never dereferenced on the zero-guarded paths
    return exp, log


GF_EXP, GF_LOG = _build_tables()

# Full 256x256 multiplication table: tiny (64 KiB) and by far the most robust
# plan-time path.  Also exported to the JAX layer.
_A, _B = np.meshgrid(np.arange(FIELD), np.arange(FIELD), indexing="ij")
GF_MUL_TABLE = np.zeros((FIELD, FIELD), dtype=np.uint8)
_nz = (_A > 0) & (_B > 0)
GF_MUL_TABLE[_nz] = GF_EXP[(GF_LOG[_A[_nz]] + GF_LOG[_B[_nz]])]

GF_INV_TABLE = np.zeros(FIELD, dtype=np.uint8)
GF_INV_TABLE[1:] = GF_EXP[ORDER - GF_LOG[np.arange(1, FIELD)]]


def gf_mul(a, b):
    """Element-wise GF(256) multiply for uint8 arrays/scalars."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    return GF_MUL_TABLE[a, b]


def gf_div(a, b):
    b = np.asarray(b, dtype=np.uint8)
    if np.any(b == 0):
        raise ZeroDivisionError("GF(256) division by zero")
    return gf_mul(a, GF_INV_TABLE[b])


def gf_inv(a):
    a = np.asarray(a, dtype=np.uint8)
    if np.any(a == 0):
        raise ZeroDivisionError("GF(256) inverse of zero")
    return GF_INV_TABLE[a]


def gf_pow(a: int, e: int) -> int:
    if e == 0:
        return 1
    if a == 0:
        return 0
    return int(GF_EXP[(int(GF_LOG[a]) * e) % ORDER])


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Matrix product over GF(256): (m,k) x (k,p) -> (m,p).

    XOR-accumulation of table products.  Vectorized over the output row: for
    plan-time sizes (<= a few thousand) this is plenty fast.
    """
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad shapes {a.shape} x {b.shape}")
    m, k = a.shape
    _, p = b.shape
    out = np.zeros((m, p), dtype=np.uint8)
    for j in range(k):  # rank-1 updates: table[a[:,j]][:,None] "times" b[j,:]
        col = a[:, j]
        row = b[j, :]
        out ^= GF_MUL_TABLE[col[:, None], row[None, :]]
    return out


def gf_matvec(a: np.ndarray, v: np.ndarray) -> np.ndarray:
    return gf_matmul(a, v.reshape(-1, 1)).ravel()


def gf_rref(a: np.ndarray) -> tuple[np.ndarray, list[int]]:
    """Reduced row-echelon form over GF(256). Returns (R, pivot_columns)."""
    r = np.asarray(a, dtype=np.uint8).copy()
    rows, cols = r.shape
    pivots: list[int] = []
    pr = 0
    for c in range(cols):
        if pr >= rows:
            break
        nz = np.nonzero(r[pr:, c])[0]
        if nz.size == 0:
            continue
        piv = pr + nz[0]
        if piv != pr:
            r[[pr, piv]] = r[[piv, pr]]
        r[pr] = gf_mul(r[pr], GF_INV_TABLE[r[pr, c]])
        mask = np.nonzero(r[:, c])[0]
        mask = mask[mask != pr]
        if mask.size:
            r[mask] ^= GF_MUL_TABLE[r[mask, c][:, None], r[pr][None, :]]
        pivots.append(c)
        pr += 1
    return r, pivots


def gf_rank(a: np.ndarray) -> int:
    if a.size == 0:
        return 0
    return len(gf_rref(a)[1])


def gf_solve(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Solve a @ x = b over GF(256); raises if inconsistent.

    Returns one solution (free variables set to 0).  b may be a matrix.
    """
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    single = b.ndim == 1
    if single:
        b = b.reshape(-1, 1)
    aug = np.concatenate([a, b], axis=1)
    r, pivots = gf_rref(aug)
    n = a.shape[1]
    for c in pivots:
        if c >= n:
            raise np.linalg.LinAlgError("inconsistent GF(256) system")
    x = np.zeros((n, b.shape[1]), dtype=np.uint8)
    for i, c in enumerate(pivots):
        x[c] = r[i, n:]
    return x.ravel() if single else x


def gf_inv_matrix(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, dtype=np.uint8)
    n = a.shape[0]
    if a.shape != (n, n):
        raise ValueError("square matrix required")
    aug = np.concatenate([a, np.eye(n, dtype=np.uint8)], axis=1)
    r, pivots = gf_rref(aug)
    if pivots != list(range(n)):
        raise np.linalg.LinAlgError("singular GF(256) matrix")
    return r[:, n:]


def gf_nullspace(a: np.ndarray) -> np.ndarray:
    """Basis (rows) of the right nullspace of a over GF(256)."""
    a = np.asarray(a, dtype=np.uint8)
    rows, cols = a.shape
    r, pivots = gf_rref(a)
    free = [c for c in range(cols) if c not in pivots]
    basis = np.zeros((len(free), cols), dtype=np.uint8)
    for bi, fc in enumerate(free):
        basis[bi, fc] = 1
        for i, pc in enumerate(pivots):
            basis[bi, pc] = r[i, fc]  # -r == r in char 2
    return basis


def cauchy_matrix(xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Cauchy matrix C[i,j] = 1/(x_i + y_j); any square submatrix invertible."""
    xs = np.asarray(xs, dtype=np.uint8)
    ys = np.asarray(ys, dtype=np.uint8)
    s = xs[:, None] ^ ys[None, :]
    if np.any(s == 0):
        raise ValueError("x_i + y_j must be nonzero for a Cauchy matrix")
    return GF_INV_TABLE[s]


def rs_generator(n: int, k: int) -> np.ndarray:
    """Systematic (n,k) RS generator over GF(256): [I_k ; P] (n x k).

    Parity part is Cauchy, so every k x k submatrix of G is invertible (MDS).
    Requires n <= 256.
    """
    if not (0 < k < n <= FIELD):
        raise ValueError(f"bad RS parameters n={n} k={k}")
    xs = np.arange(k, n, dtype=np.uint8)  # n-k values
    ys = np.arange(0, k, dtype=np.uint8)
    parity = cauchy_matrix(xs, ys)  # (n-k, k)
    return np.concatenate([np.eye(k, dtype=np.uint8), parity], axis=0)


def gf_mul_bitmatrix(c: int) -> np.ndarray:
    """8x8 GF(2) matrix M with: bits(c * x) = M @ bits(x) (mod 2).

    Column j is bits(c * 2^j).  Bit order: LSB first.
    """
    m = np.zeros((8, 8), dtype=np.uint8)
    for j in range(8):
        prod = int(gf_mul(c, 1 << j))
        for i in range(8):
            m[i, j] = (prod >> i) & 1
    return m


def gf_matrix_to_bitmatrix(a: np.ndarray) -> np.ndarray:
    """Expand (m,k) GF(256) matrix to (8m,8k) GF(2) bit-matrix.

    GF(256) matmul == bit-matrix matmul over GF(2) on bit-unpacked data;
    the CUDA kernel expands the same columns (c * 2^j) on the fly.
    """
    a = np.asarray(a, dtype=np.uint8)
    m, k = a.shape
    out = np.zeros((8 * m, 8 * k), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            if a[i, j]:
                out[8 * i : 8 * i + 8, 8 * j : 8 * j + 8] = gf_mul_bitmatrix(int(a[i, j]))
    return out


class GFRandom:
    """Deterministic GF(256) randomness for construction searches."""

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)

    def nonzero(self, shape=()) -> np.ndarray:
        return self._rng.integers(1, FIELD, size=shape, dtype=np.uint8)

    def any(self, shape=()) -> np.ndarray:
        return self._rng.integers(0, FIELD, size=shape, dtype=np.uint8)
