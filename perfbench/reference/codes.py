"""Generator matrices of the benchmark's codes, built again from the paper's
constructions over a given field, apart from the program under test.

Layout (paper §4, and the stripe layout every cell uses): node i stores alpha
subblocks; row ``i * alpha + t`` of a stripe is node i's subblock t; the
first ``k * alpha`` rows are the data (systematic code).

* ``cauchy_rs`` (alpha 1): ``[I_k ; P]`` with ``P[q, j] = 1 / (x_q + y_j)``,
  ``x = k .. n-1``, ``y = 0 .. k-1``.
* ``stripwise_cauchy`` (DRC, paper §4.2-§4.3): set t of the alpha sets is
  the subblocks at offset t of the k data blocks; it is encoded by its own
  systematic Cauchy RS code with ``x = k + t (n-k) + q``, ``y = 0 .. k-1``,
  and node i stores symbol i of every set.
"""
from __future__ import annotations

import numpy as np

from .gf256 import Field


def _cauchy(f: Field, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    s = np.asarray(xs, dtype=np.uint8)[:, None] ^ np.asarray(ys, dtype=np.uint8)[None, :]
    if np.any(s == 0):
        raise ValueError("x_i + y_j must be nonzero")
    return f.inv[s]


def generator(cfg: dict, f: Field) -> np.ndarray:
    """The (n*alpha, k*alpha) systematic generator that ``cfg`` names."""
    n, k, a = cfg["n"], cfg["k"], cfg["alpha"]
    kind = cfg["generator"]
    if kind == "cauchy_rs":
        if a != 1:
            raise ValueError("cauchy_rs has alpha 1")
        parity = _cauchy(f, np.arange(k, n), np.arange(k))
        return np.concatenate([np.eye(k, dtype=np.uint8), parity], axis=0)
    if kind == "stripwise_cauchy":
        if k + a * (n - k) > 256:
            raise ValueError("field too small for the stripwise construction")
        g = np.zeros((n * a, k * a), dtype=np.uint8)
        for t in range(a):
            xs = np.arange(k + t * (n - k), k + (t + 1) * (n - k))
            gt = np.concatenate([np.eye(k, dtype=np.uint8), _cauchy(f, xs, np.arange(k))])
            for i in range(n):
                g[i * a + t, t::a] = gt[i]
        return g
    raise ValueError(f"unknown generator construction {kind!r}")


def node_rows(cfg: dict, node: int) -> slice:
    a = cfg["alpha"]
    return slice(node * a, (node + 1) * a)


def rebuild_from_helpers(cfg: dict, f: Field, helpers: dict[int, "object"], lost: int):
    """The lost node's (alpha, sub) bytes decoded from the first k helpers
    (node id -> (alpha, sub) uint8 tensor) over field ``f``: invert the
    helpers' generator rows, recover the data, re-encode the lost rows."""
    import torch

    g = generator(cfg, f)
    ids = sorted(helpers)[: cfg["k"]]
    rows = np.concatenate([g[node_rows(cfg, i)] for i in ids], axis=0)
    decode = f.matmul(g[node_rows(cfg, lost)], f.inverse(rows))
    stacked = torch.cat([helpers[i] for i in ids], dim=0)
    return f.apply(decode, stacked)
