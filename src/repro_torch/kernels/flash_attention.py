"""Launch wrapper of the CUDA flash-attention forward kernel
(``csrc/flash_attention.cu``) and its plain version.

Replaces ``src/repro/kernels/flash_attention.py::_flash_kernel`` (launched
by ``flash_attention``), the TPU kernel of the serving path's full-sequence
attention (``models/attention.py``).

What bounds it on Hopper: at the model's prefill shape (StarCoder2-3B,
B 4, S 4096, H 24 over 2 KV heads, D 128, causal) the forward is about
4.1e11 FLOP against 218 MB moved, so it is bound by operations (about
0.42 ms at the data sheet's 989 TFLOP/s bf16, against 0.07 ms for the bytes).
The kernel keeps the (S, S) scores out of device memory, runs both
products of the bf16 path on the tensor cores (``mma.sync``), and skips the
kv tiles above the causal diagonal.  See the source for the design.

On a CPU tensor the wrapper runs the plain version, ``flash_attention_ref``;
on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build
from .ref import streaming_attention

REF_BLOCK_K = 256  # the TPU kernel's default kv block
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """The TPU kernel's arithmetic in plain PyTorch, in f32.

    q (B, Sq, H, D), k/v (B, Sk, kvH, D) -> (B, Sq, H, D) in q's dtype.  The
    kv axis is walked in blocks of ``REF_BLOCK_K`` (``ref.streaming_attention``);
    q is scaled in f32 before the product and P stays in f32, as in
    ``_flash_kernel``.  Blocks above the causal diagonal contribute exactly
    nothing (p = 0, corr = 1), so they are not skipped here.
    """
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    qf = q.float().reshape(b, sq, kvh, h // kvh, d) * (1.0 / math.sqrt(d))
    out = streaming_attention(qf, k, v, causal=causal, block=REF_BLOCK_K)
    return out.reshape(b, sq, h, d).to(q.dtype)


@functools.lru_cache(maxsize=1)
def _launch_fn():
    fn = build.load("flash_attention").flash_attention_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        *[ctypes.c_longlong] * 12,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share f32 or bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B,Sq,H,D), k/v (B,Sk,kvH,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not pair "
                         "(batch, head dim, or H not a multiple of kvH)")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if q.device.type == "cuda":
        if d not in HEAD_DIMS:
            raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.stride(3) != 1:
                raise ValueError(f"{name} must be contiguous along the head dim")
            if t.data_ptr() % 16 or any(s * t.element_size() % 16 for s in t.stride()[:3]):
                raise ValueError(f"{name} rows must be 16-byte aligned (strides {t.stride()})")


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, kvH, D) -> (B, Sq, H, D) in q's dtype.

    Causal masking keeps ``row >= col`` with positions from 0 for both q
    and k.  q head ``h`` reads kv head ``h // (H / kvH)``.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if sk == 0:
        return out.zero_()
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launch_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                           b, sq, sk, h, kvh, d, *strides,
                           int(causal), _DTYPE_CODE[q.dtype], 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0  # kernel launches; the CPU path does not count
