"""Launch wrapper of the CUDA GF(2^8) product kernel (``csrc/gf_matmul.cu``).

Replaces ``src/repro/kernels/gf_matmul.py::_gf_bitplane_kernel`` (launched
by ``gf_matmul_pallas``), the TPU kernel of every erasure-coding product:
ISA-L's ``ec_encode_data`` (paper §5.2).

The CUDA kernel is a bitsliced GF(2^8) product (see the source's header):
each lane transposes 32 payload bytes into 8 bit-planes and forms the
multiples x * 2^i by doubling in plane form; each nonzero coefficient of a
work list adds to its row's accumulator (in shared memory) the multiples its
bits select, one warp-uniform indirect branch per nibble.  Payload rows
stream through a 2-stage shared-memory ring (``cp.async``) per group of
warps, so a payload byte is read from device memory once per block.  The
TPU kernel's int8 bitplane form was weighed and not taken: 64 int8 MACs per
GF multiply-add, plus unpacking and packing.  One kernel serves every
shape; it is bound by integer issue: a little above the byte time at the
small-K products, several times it at the MSR(9,6,3) encode.

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

_ALIGN = 16  # the kernel's vector path: cp.async and 16-byte stores


def bind(lib: ctypes.CDLL):
    """``gf_matmul_launch`` of a built library, with its C signature."""
    fn = lib.gf_matmul_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=1)
def _launch_fn():
    return bind(build.load("gf_matmul"))


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


def launch(fn, m: torch.Tensor, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """One launch of ``gf_matmul_launch`` (``fn``, from a build of a source)
    on CUDA tensors m (G,R,K), x (G,K,B) and out (G,R,B) that ``_check`` has
    passed, with G, R, K and B nonzero; raises if it fails."""
    g, r, k = m.shape
    b = x.shape[2]
    aligned = b % _ALIGN == 0 and all(t.data_ptr() % _ALIGN == 0 for t in (x, out))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(m.data_ptr(), x.data_ptr(), out.data_ptr(), g, r, k, b, int(aligned), stream)
    if err != 0:
        raise RuntimeError(f"gf_matmul kernel launch failed: cudaError {err}")
    return out


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
    launch(_launch_fn(), m, x, out)
    gf_matmul_batched.launches += 1
    return out


gf_matmul_batched.launches = 0  # kernel launches; the CPU path does not count
