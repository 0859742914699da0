"""Seeded inputs: the stripes' data bytes and the random draws of a run.

Every stream is derived from ``--seed`` and a name, so the same seed gives
the same bytes and the same draws, and streams do not overlap.  Data bytes
are drawn on the device, one stripe's data rows per call.
"""
from __future__ import annotations

import numpy as np
import torch


def _entropy(seed: int, name: str) -> list[int]:
    return [seed % (1 << 64), *name.encode()]


def rng(seed: int, name: str) -> np.random.Generator:
    """A numpy generator for the host-side draws named ``name``."""
    return np.random.default_rng(np.random.SeedSequence(_entropy(seed, name)))


def torch_generator(seed: int, name: str, device: torch.device | str) -> torch.Generator:
    state = np.random.SeedSequence(_entropy(seed, name)).generate_state(2, np.uint32)
    g = torch.Generator(device=torch.device(device))
    g.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return g


def fill_rows(rows: list[torch.Tensor], seed: int, name: str) -> None:
    """Fill each (rows, sub) uint8 tensor with seeded random bytes, in order,
    from one generator on their device."""
    if not rows:
        return
    g = torch_generator(seed, name, rows[0].device)
    for t in rows:
        t.random_(0, 256, generator=g)


def data_rows(cfg: dict, stripes: int, seed: int, device: torch.device | str):
    """Regenerate stripe s's (k*alpha, sub) data bytes for s = 0, 1, ...:
    the bytes ``fill_rows(..., seed, "data")`` put into a pool's data rows."""
    ka = cfg["k"] * cfg["alpha"]
    g = torch_generator(seed, "data", device)
    buf = torch.empty((ka, cfg["sub_bytes"]), dtype=torch.uint8, device=device)
    for s in range(stripes):
        buf.random_(0, 256, generator=g)
        yield s, buf


def new_pool(cfg: dict, stripes: int, seed: int, device: torch.device | str) -> torch.Tensor:
    """(stripes, n*alpha, sub) uint8: seeded data rows, parity rows zero
    (the caller encodes them)."""
    n, k, a, sub = cfg["n"], cfg["k"], cfg["alpha"], cfg["sub_bytes"]
    pool = torch.zeros((stripes, n * a, sub), dtype=torch.uint8, device=device)
    fill_rows([pool[s, : k * a] for s in range(stripes)], seed, "data")
    return pool
