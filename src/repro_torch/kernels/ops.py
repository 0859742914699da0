"""Public entry points of the GF(2^8) product: the one path every caller uses.

``gf_matmul(m, x)`` serves the codes' encode/decode, the repair executors
and the checkpoint encode.  It

* moves the plan-time GF(256) matrix (numpy) to the payload's device, cached
  by content (not for a fake payload: a fake tensor must not outlive its
  mode),
* launches the CUDA kernel on a CUDA payload (every call; the kernel masks
  its own ragged edge), or runs the plain table version on a CPU payload.

Under an active ``repro_torch.obs`` tracer every call records a measured
``kernel.gf_matmul`` span on the calling thread, nested in its caller's
span: the host time of the call, the matrix's move to the device and the
launch (the call does not wait for the kernel).  The counters
``kernel.gf_matmul.calls`` and ``.bytes`` (payload in + out) count the
calls.  The kernel's device time is read from ``torch.profiler``, whose
trace lies on the span's clock (``obs.Tracer.unix_us``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

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


def _matrix(key: bytes, shape: tuple[int, ...], device: torch.device) -> torch.Tensor:
    host = torch.frombuffer(bytearray(key), dtype=torch.uint8).reshape(shape)
    return host.to(device)


_matrix_cached = functools.lru_cache(maxsize=4096)(_matrix)


def _device_matrix(m: np.ndarray | torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if isinstance(m, torch.Tensor):
        return m.to(device=x.device, dtype=torch.uint8).contiguous()
    m = np.ascontiguousarray(np.asarray(m, dtype=np.uint8))
    load = _matrix if is_fake(x) else _matrix_cached
    return load(m.tobytes(), m.shape, x.device)


def gf_matmul(
    m: np.ndarray | torch.Tensor, x: torch.Tensor, *, out: torch.Tensor | None = None
) -> torch.Tensor:
    """GF(256) coding product: (R, K) @ (K, B) -> (R, B) uint8.

    ``out``, when given, must be a contiguous (R, B) uint8 tensor on x's
    device; the product is written into it in place.
    """
    if x.dtype != torch.uint8 or x.ndim != 2:
        raise ValueError(f"payload must be 2-D uint8, got {x.dtype} {tuple(x.shape)}")
    with obs.span("kernel.gf_matmul", cat="kernel") as span:
        mt = _device_matrix(m, x)
        if mt.ndim != 2 or mt.shape[1] != x.shape[0]:
            raise ValueError(f"payload {tuple(x.shape)} does not match matrix {tuple(mt.shape)}")
        y = _kernel.gf_matmul_batched(mt[None], x.contiguous()[None],
                                      None if out is None else out[None])
    _record(span, y, x.shape[0], x.is_cuda)
    return y[0]


def gf_matmul_batched(
    m: np.ndarray | torch.Tensor, x: torch.Tensor, *, out: torch.Tensor | None = None
) -> torch.Tensor:
    """G products in one launch: (G, R, K) @ (G, K, B) -> (G, R, B) uint8."""
    with obs.span("kernel.gf_matmul", cat="kernel") as span:
        y = _kernel.gf_matmul_batched(_device_matrix(m, x), x.contiguous(), out)
    _record(span, y, x.shape[1], x.is_cuda)
    return y


def _record(span: obs.Span, y: torch.Tensor, k: int, on_card: bool) -> None:
    """The call's shape on its span, and its counters (after the span
    closed, so that the span times the call alone)."""
    tracer = obs.current()
    if tracer is None or not isinstance(span, obs.Span):
        return
    g, r, b = y.shape
    path = "cuda" if on_card else "ref"
    span.attrs.update(r=r, k=k, b=b, g=g, path=path)
    tracer.counter_add("kernel.gf_matmul.bytes", g * (k + r) * b, path=path)
    tracer.counter_add("kernel.gf_matmul.calls", 1, path=path)


def encode_payload(generator: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """Systematic encode: only compute the parity rows on the data path."""
    ka = generator.shape[1]
    parity = gf_matmul(generator[ka:], data)
    return torch.cat([data, parity], dim=0)
