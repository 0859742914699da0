"""Public entry points of the GF(2^8) product: the one path every caller uses.

``gf_matmul(m, x)`` serves the codes' encode/decode, the repair executors
and the checkpoint encode.  It

* moves the plan-time GF(256) matrix (numpy) to the payload's device, cached
  by content,
* launches the CUDA kernel on a CUDA payload (every call; the kernel masks
  its own ragged edge), or runs the plain table version on a CPU payload.

Under an active ``repro_torch.obs`` tracer every call records a
``kernel.gf_matmul`` span with wall-clock and achieved GB/s (payload in + out
bytes).  Only then does the call synchronise the device around the launch,
so traced runs are synchronous and untraced runs are not.
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import gf as _gf

from . import gf_matmul as _kernel


@functools.lru_cache(maxsize=4096)
def _bitmatrix_cached(key: bytes, shape: tuple[int, int]) -> np.ndarray:
    m = np.frombuffer(key, dtype=np.uint8).reshape(shape)
    return _gf.gf_matrix_to_bitmatrix(m).astype(np.int8)


def bit_expand(m: np.ndarray) -> np.ndarray:
    """(R, K) GF(256) matrix -> (8R, 8K) int8 GF(2) bit-matrix (cached).

    The TPU kernel's operand; kept for tests and for reading the reference.
    """
    m = np.ascontiguousarray(np.asarray(m, dtype=np.uint8))
    return _bitmatrix_cached(m.tobytes(), m.shape)


@functools.lru_cache(maxsize=4096)
def _matrix_cached(key: bytes, shape: tuple[int, ...], device: torch.device) -> torch.Tensor:
    host = torch.frombuffer(bytearray(key), dtype=torch.uint8).reshape(shape)
    return host.to(device)


def _device_matrix(m: np.ndarray | torch.Tensor, device: torch.device) -> torch.Tensor:
    if isinstance(m, torch.Tensor):
        return m.to(device=device, dtype=torch.uint8).contiguous()
    m = np.ascontiguousarray(np.asarray(m, dtype=np.uint8))
    return _matrix_cached(m.tobytes(), m.shape, device)


def gf_matmul(
    m: np.ndarray | torch.Tensor, x: torch.Tensor, *, out: torch.Tensor | None = None
) -> torch.Tensor:
    """GF(256) coding product: (R, K) @ (K, B) -> (R, B) uint8.

    ``out``, when given, must be a contiguous (R, B) uint8 tensor on x's
    device; the product is written into it in place.
    """
    if x.dtype != torch.uint8 or x.ndim != 2:
        raise ValueError(f"payload must be 2-D uint8, got {x.dtype} {tuple(x.shape)}")
    mt = _device_matrix(m, x.device)
    if mt.ndim != 2 or mt.shape[1] != x.shape[0]:
        raise ValueError(f"payload {tuple(x.shape)} does not match matrix {tuple(mt.shape)}")
    y = _traced(mt[None], x.contiguous()[None], None if out is None else out[None])
    return y[0]


def gf_matmul_batched(
    m: np.ndarray | torch.Tensor, x: torch.Tensor, *, out: torch.Tensor | None = None
) -> torch.Tensor:
    """G products in one launch: (G, R, K) @ (G, K, B) -> (G, R, B) uint8."""
    mt = _device_matrix(m, x.device)
    return _traced(mt, x.contiguous(), out)


def _traced(m: torch.Tensor, x: torch.Tensor, out: torch.Tensor | None) -> torch.Tensor:
    tracer = obs.current()
    if tracer is None:
        return _kernel.gf_matmul_batched(m, x, out)
    g, r, k = m.shape
    b = x.shape[2]
    path = "cuda" if x.is_cuda else "ref"
    if x.is_cuda:  # traced timing must observe the finished launch
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    y = _kernel.gf_matmul_batched(m, x, out)
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    dt = max(time.perf_counter() - t0, 1e-9)
    moved = g * (k + r) * b  # payload bytes in + out
    tracer.record_span("kernel.gf_matmul", dt, cat="kernel", track="kernel",
                       at_s=tracer.now_us() / 1e6 - dt,
                       r=r, k=k, b=b, g=g, path=path, gbps=moved / dt / 1e9)
    tracer.counter_add("kernel.gf_matmul.bytes", moved, path=path)
    tracer.counter_add("kernel.gf_matmul.calls", 1, path=path)
    tracer.gauge_set("kernel.gf_matmul.gbps", moved / dt / 1e9, path=path)
    return y


def encode_payload(generator: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """Systematic encode: only compute the parity rows on the data path."""
    ka = generator.shape[1]
    parity = gf_matmul(generator[ka:], data)
    return torch.cat([data, parity], dim=0)
