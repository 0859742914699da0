"""GF(2^8) data-path operations on torch tensors.

The counterpart of ``repro.core.gf_jax``.  Plan-time linear algebra lives in
`repro_torch.core.gf` (numpy); this module applies GF(256) matrices to
payload bytes with plain torch ops.  ``gf_matmul_table`` is the plain
version of the CUDA kernel (``repro_torch.kernels.gf_matmul``): the CPU
tests run it, and ``chip_smoke.py`` holds the kernel against it on the card.

Two torch hazards shape the code:

* a ``uint8`` index tensor is read as a boolean mask, so every table lookup
  casts its indices to ``long``;
* torch has no XOR reduction, so products are XOR-accumulated in a loop over
  the contraction axis, as ``repro_torch.core.gf.gf_matmul`` does in numpy.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import gf as _gf


@functools.lru_cache(maxsize=None)
def mul_table(device: torch.device) -> torch.Tensor:
    """The (256, 256) uint8 GF(256) multiplication table on ``device``."""
    return torch.from_numpy(_gf.GF_MUL_TABLE).to(device)


def gf_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Element-wise GF(256) product of uint8 tensors (broadcasting)."""
    table = mul_table(a.device)
    return table[a.long(), b.long()]


def gf_matmul_table(m: torch.Tensor | np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """GF(256) matrix product (R, K) @ (K, B) -> (R, B), all uint8.

    XOR-accumulated table products, one rank-1 update per column of ``m``:
    ``out ^= table[m[:, j]][:, x[j]]``.  Unlike ``gf_matmul_jnp`` this never
    materialises the (R, K, B) gather, which at full payload width would be
    gigabytes.
    """
    if isinstance(m, np.ndarray):
        m = torch.from_numpy(np.ascontiguousarray(m, dtype=np.uint8))
    m = m.to(device=x.device, dtype=torch.uint8)
    if m.ndim != 2 or x.ndim != 2 or m.shape[1] != x.shape[0]:
        raise ValueError(f"bad shapes {tuple(m.shape)} x {tuple(x.shape)}")
    if x.dtype != torch.uint8:
        raise TypeError(f"payload must be uint8, got {x.dtype}")
    rows = mul_table(x.device)[m.long()]  # (R, K, 256): row j is "times m[:, j]"
    out = torch.zeros((m.shape[0], x.shape[1]), dtype=torch.uint8, device=x.device)
    for j in range(m.shape[1]):
        out ^= rows[:, j][:, x[j].long()]
    return out


def xor_reduce(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """XOR of the uint8 slices of ``x`` along ``axis``."""
    if x.dtype != torch.uint8:
        raise TypeError(f"xor_reduce takes uint8, got {x.dtype}")
    out = torch.zeros_like(x.select(axis, 0))
    for t in x.unbind(axis):
        out ^= t
    return out


def _shifts(device: torch.device) -> torch.Tensor:
    return torch.arange(8, dtype=torch.uint8, device=device)


def bytes_to_bits(x: torch.Tensor) -> torch.Tensor:
    """Unpack uint8 (..., B) -> uint8 bits (..., 8, B), LSB first."""
    return (x.unsqueeze(-2) >> _shifts(x.device)[:, None]) & 1


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """Pack uint8 bits (..., 8, B) (LSB first) -> uint8 (..., B)."""
    planes = (bits.to(torch.uint8) & 1) << _shifts(bits.device)[:, None]
    return xor_reduce(planes, axis=-2)
