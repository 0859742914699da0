"""What every stripe of a pool must hold, worked out again from the seed:
the seeded data rows, and parity rows encoded by the reference's own
generator and GF(2^8) arithmetic over 0x11D."""
from __future__ import annotations

from typing import Iterator

import torch

from perfbench import data

from .codes import generator
from .gf256 import ISA_L_POLY, field


def true_stripes(cfg: dict, stripes: int, seed: int,
                 device: torch.device | str) -> Iterator[tuple[int, torch.Tensor]]:
    """(s, the (n*alpha, sub) stripe s must hold) for s = 0 .. stripes-1, one
    stripe in memory at a time."""
    f = field(ISA_L_POLY)
    g = generator(cfg, f)
    ka = cfg["k"] * cfg["alpha"]
    for s, rows in data.data_rows(cfg, stripes, seed, device):
        yield s, torch.cat([rows, f.apply(g[ka:], rows)], dim=0)
