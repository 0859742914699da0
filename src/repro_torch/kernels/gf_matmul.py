"""Launch wrapper of the CUDA GF(2^8) product kernel (``csrc/gf_matmul.cu``).

Replaces ``src/repro/kernels/gf_matmul.py::_gf_bitplane_kernel`` (launched
by ``gf_matmul_pallas``), the TPU kernel of every erasure-coding product:
ISA-L's ``ec_encode_data`` (paper §5.2).

What bounds it on Hopper: the TPU kernel runs the product as an int8
bitplane matmul, ``pack((bits(M) @ unpack(X)) & 1)``, with the whole
(8R, 8K) bit-matrix resident in VMEM.  That matrix exceeds a block's 227 KB
of shared memory at the main path's widest product (MSR(9,6,3) encode:
840 KB), and the bitplane form multiplies 64x the GF coefficients.  The CUDA
kernel keeps the R*K GF(256) coefficients resident instead and expands each
into its eight bit-matrix columns ``c * 2^i`` through an 8 KB table, applying
them to 4 payload bytes at a time with one LOP3 per column (see the source).
At the main path's shapes it is bound by integer issue, not by bytes.

On a CPU tensor the wrapper runs the plain version,
``repro_torch.core.gf_torch.gf_matmul_table``; on a CUDA tensor it launches
the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.gf_torch import gf_matmul_table

from . import build

_ALIGN = 16  # the kernel's vector path: 16-byte strips


@functools.lru_cache(maxsize=1)
def _launch_fn():
    fn = build.load("gf_matmul").gf_matmul_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(m: torch.Tensor, x: torch.Tensor, out: torch.Tensor | None) -> None:
    if m.dtype != torch.uint8 or x.dtype != torch.uint8:
        raise TypeError(f"m and x must be uint8, got {m.dtype} and {x.dtype}")
    if m.ndim != 3 or x.ndim != 3 or m.shape[0] != x.shape[0] or m.shape[2] != x.shape[1]:
        raise ValueError(f"need m (G,R,K), x (G,K,B); got {tuple(m.shape)}, {tuple(x.shape)}")
    if m.device != x.device:
        raise ValueError(f"m on {m.device} but x on {x.device}")
    if not (m.is_contiguous() and x.is_contiguous()):
        raise ValueError("m and x must be contiguous")
    if out is not None:
        want = (m.shape[0], m.shape[1], x.shape[2])
        if out.dtype != torch.uint8 or tuple(out.shape) != want:
            raise ValueError(f"out must be uint8 {want}, got {out.dtype} {tuple(out.shape)}")
        if out.device != x.device or not out.is_contiguous():
            raise ValueError("out must be contiguous and on x's device")


def gf_matmul_batched(
    m: torch.Tensor, x: torch.Tensor, out: torch.Tensor | None = None
) -> torch.Tensor:
    """G independent GF(256) products: m (G,R,K) x x (G,K,B) -> (G,R,B) uint8.

    ``out``, when given, is written in place (it may be a contiguous view
    into a larger buffer, e.g. a stripe's parity rows).
    """
    _check(m, x, out)
    g, r, k = m.shape
    b = x.shape[2]
    if out is None:
        out = torch.empty((g, r, b), dtype=torch.uint8, device=x.device)
    if x.device.type == "cpu":
        for i in range(g):
            out[i] = gf_matmul_table(m[i], x[i])
        return out
    if x.device.type != "cuda":
        raise ValueError(f"no GF(256) kernel for device {x.device}")
    if g == 0 or r == 0 or b == 0:
        return out
    if k == 0:
        return out.zero_()
    aligned = b % _ALIGN == 0 and all(
        t.data_ptr() % _ALIGN == 0 for t in (x, out)
    )
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launch_fn()(m.data_ptr(), x.data_ptr(), out.data_ptr(),
                           g, r, k, b, int(aligned), stream)
    if err != 0:
        raise RuntimeError(f"gf_matmul kernel launch failed: cudaError {err}")
    gf_matmul_batched.launches += 1
    return out


gf_matmul_batched.launches = 0  # kernel launches; the CPU path does not count
