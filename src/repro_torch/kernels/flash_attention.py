"""Launch wrapper of the CUDA flash-attention forward kernel
(``csrc/flash_attention.cu``) and its plain version.

Replaces ``src/repro/kernels/flash_attention.py::_flash_kernel`` (launched
by ``flash_attention``), the TPU kernel of the serving path's full-sequence
attention (``models/attention.py``).

What bounds it on Hopper: at the model's prefill shape (StarCoder2-3B,
B 4, S 4096, H 24 over 2 KV heads, D 128, causal) the forward is 4.12e11
FLOP against 218 MB moved, so it is bound by operations (0.417 ms at the
data sheet's 989 TFLOP/s bf16, against 0.065 ms for the bytes).  The bf16
kernel is built to keep the tensor cores fed: persistent CTAs, one per SM,
walk the (batch*head, 128 q rows) items longest first; in each, a producer
warpgroup's one thread feeds a two-stage ring of K/V tiles by TMA, and two
consumer warpgroups run both products as ``wgmma``, taking turns to issue
them so that one's online softmax (on the accumulators, in registers) runs
while the other's products do.  The (S, S) scores never leave the SM and kv
tiles above the causal diagonal are skipped.  See the source for the
design; the f32 path runs on the CUDA cores.

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


def bind(lib: ctypes.CDLL):
    """``flash_attention_launch`` of a built library, with its C signature."""
    fn = lib.flash_attention_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        *[ctypes.c_longlong] * 12,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=1)
def _launch_fn():
    return bind(build.load("flash_attention"))


# The bf16 kernel's tiling (``Tiles<D>`` and the constants above it in
# csrc/flash_attention.cu): 128 q rows per CTA, 64 per consumer warpgroup;
# 128 kv rows per ring stage; 2 stages; a producer warpgroup and two consumer
# warpgroups, whose registers setmaxnreg sets.
TILE_M, TILE_N, STAGES, THREADS = 128, 128, 2, 384
PRODUCER_REGS, CONSUMER_REGS = 24, 240
SMEM_LIMIT = 232_448  # bytes of shared memory one block can use on Hopper


def hopper_geometry(head_dim: int) -> dict[str, int]:
    """The bf16 kernel's geometry at ``head_dim``, as its source computes it.

    A tile row of D bf16 is staged by TMA in boxes of ``box_cols`` columns
    under a ``swizzle_bytes`` swizzle (128 B, or 64 B at D 32), the layout
    the ``wgmma`` descriptors read; at D 128 a row is two boxes.  Shared
    memory holds Q, the output tile staged for its TMA store, the ring's K
    and V stages, four barriers per stage and two for Q, and 1024 bytes to
    align the swizzle period.
    """
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head dim {head_dim} not in {HEAD_DIMS}")
    swizzle = min(2 * head_dim, 128)
    smem = (2 * TILE_M + 2 * STAGES * TILE_N) * head_dim * 2 + 8 * (2 + 4 * STAGES) + 1024
    return {"tile_m": TILE_M, "tile_n": TILE_N, "stages": STAGES, "threads": THREADS,
            "smem_bytes": smem, "producer_regs": PRODUCER_REGS,
            "consumer_regs": CONSUMER_REGS, "swizzle_bytes": swizzle,
            "box_cols": swizzle // 2, "boxes": head_dim // (swizzle // 2)}


def hopper_config(head_dim: int) -> dict[str, int]:
    """The same geometry as the built kernel reports it (needs the build)."""
    keys = list(hopper_geometry(head_dim))
    out = (ctypes.c_int * len(keys))()
    err = build.load("flash_attention").flash_attention_hopper_config(head_dim, out)
    if err != 0:
        raise RuntimeError(f"flash_attention_hopper_config({head_dim}) failed: {err}")
    return dict(zip(keys, out))


def rows_aligned(t: torch.Tensor) -> bool:
    """TMA reads a (B, S, heads, D) tensor whose base and byte strides are
    multiples of 16; the kernel's tensor maps take the strides as they are."""
    return t.data_ptr() % 16 == 0 and all(
        s * t.element_size() % 16 == 0 for s in t.stride()[:3])


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
            if not rows_aligned(t):
                raise ValueError(f"{name} rows must be 16-byte aligned (strides {t.stride()})")


def launch(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    """One launch of ``flash_attention_launch`` (``fn``, from a build of the
    source) on CUDA tensors that ``_check`` has passed; raises if it fails."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, sq, sk, h, kvh, d, *strides,
                 int(causal), _DTYPE_CODE[q.dtype], 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    return out


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, kvH, D) -> (B, Sq, H, D) in q's dtype.

    Causal masking keeps ``row >= col`` with positions from 0 for both q
    and k.  q head ``h`` reads kv head ``h // (H / kvH)``.

    The kernel is a forward only (so is the TPU kernel): its output has no
    autograd edge.  On a CUDA tensor it raises where autograd would record
    the call; the differentiable path is the chunked attention
    (``models.attention.attention(..., use_flash=False)``).
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            "the flash-attention kernel has no backward: under autograd take the "
            "chunked path (models.attention.attention(..., use_flash=False)) or "
            "call it under torch.no_grad()")
    if q.numel() == 0:
        return q.new_empty(q.shape)
    if k.shape[1] == 0:
        return q.new_zeros(q.shape)
    out = launch(_launch_fn(), q, k, v, causal)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0  # kernel launches; the CPU path does not count
