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
on a CUDA tensor it launches the kernel or raises.  The launch is the custom
op ``torch.ops.repro_torch.flash_attention``, so that a program traced under
``FakeTensorMode`` (the dry run) sees it: its fake kernel gives the output's
shape and dtype, and ``torch.utils.flop_counter`` counts :func:`flops` for
it.  A fake tensor launches nothing and is not counted in ``launches``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils.flop_counter import register_flop_formula

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


# The f32 path's tiling (``kBlockM``/``kBlockN`` and ``dispatch`` in the
# source): one block per (64 q rows, batch*head), 256 threads.
F32_BLOCK_M, F32_BLOCK_N, F32_THREADS = 64, 64, 256
MAX_GRID_Y = 65_535
MAX_ITEMS = 2**31 - 1
# the fields ``flash_attention_work_geometry_query`` returns, in order
WORK_FIELDS = ("grid_x", "grid_y", "items", "threads", "smem", "sms")


@dataclasses.dataclass(frozen=True)
class FlashWorkGeometry:
    """One launch's grid and the work its blocks walk, for the checker
    (``repro_torch.check.lowered.cuda``) to sweep without a card.

    bf16 (``launch_hopper``): a persistent grid of ``min(items, sms)`` CTAs;
    CTA ``x`` walks items ``x, x + grid_x, ..``, item ``w`` being q tile
    ``m_tiles - 1 - w // (B*H)`` (128 rows from ``q0``) of batch*head ``w %
    (B*H)``, its kv tiles walked last first, and each consumer warpgroup
    storing its 64 rows by TMA, which clips rows past Sq.  f32
    (``dispatch``): block ``(x, y)`` is q rows ``[64x, 64x + 64)`` of
    batch*head ``y``, one item each.
    """

    b: int
    sq: int
    sk: int
    h: int
    kvh: int
    d: int
    causal: bool
    bf16: bool
    grid_x: int
    grid_y: int
    items: int
    threads: int
    smem: int
    sms: int

    def query_fields(self) -> dict[str, int]:
        return {name: getattr(self, name) for name in WORK_FIELDS}

    @property
    def tile_m(self) -> int:
        return TILE_M if self.bf16 else F32_BLOCK_M

    @property
    def tile_n(self) -> int:
        return TILE_N if self.bf16 else F32_BLOCK_N

    def block_items(self) -> tuple[np.ndarray, np.ndarray]:
        """(block, item) of every item visit, in each block's order (a block
        is its linear index ``x + grid_x * y``)."""
        if not self.bf16:
            item = np.arange(self.items, dtype=np.int64)
            return item, item
        bx = np.arange(self.grid_x, dtype=np.int64)
        mine = np.where(bx < self.items, (self.items - 1 - bx) // max(self.grid_x, 1) + 1, 0)
        blocks = np.repeat(bx, mine)
        step = np.arange(len(blocks), dtype=np.int64) - np.repeat(np.cumsum(mine) - mine, mine)
        return blocks, blocks + step * self.grid_x

    def place(self, item: np.ndarray) -> dict[str, np.ndarray]:
        """Item -> its batch ``b``, head ``h``, kv head ``kh``, first q row
        ``q0`` and kv tiles ``n_tiles``."""
        bh = self.b * self.h
        if self.bf16:
            m_tiles = -(-self.sq // TILE_M)
            q0 = (m_tiles - 1 - item // bh) * TILE_M
            head = item % bh
        else:
            q0 = (item % self.grid_x) * F32_BLOCK_M
            head = item // self.grid_x
        return {"b": head // self.h, "h": head % self.h,
                "kh": (head % self.h) // (self.h // self.kvh), "q0": q0,
                "n_tiles": self.kv_tiles(q0, self.tile_m)}

    def kv_tiles(self, q0: np.ndarray, rows: int) -> np.ndarray:
        """kv tiles the q rows [q0, q0 + rows) visit: with a causal mask,
        none strictly above the diagonal of their last row."""
        n = -(-self.sk // self.tile_n)
        if not self.causal:
            return np.full_like(q0, n)
        return np.minimum(n, (np.minimum(q0 + rows, self.sq) - 1) // self.tile_n + 1)

    def store_rows(self, q0: np.ndarray) -> list[tuple[np.ndarray, np.ndarray]]:
        """The output rows [lo, hi) each writer of an item stores: bf16, the
        two consumer warpgroups (64 rows each; one whose rows all lie past Sq
        stores nothing), f32 the block's rows below Sq."""
        writers = (0, 64) if self.bf16 else (0,)
        out = []
        for off in writers:
            lo = q0 + off
            out.append((lo, np.where(lo < self.sq, np.minimum(lo + 64, self.sq), lo)))
        return out


def flash_attention_work_geometry(b: int, sq: int, sk: int, h: int, kvh: int, d: int,
                                  dtype: torch.dtype, sms: int, *,
                                  causal: bool = True) -> FlashWorkGeometry:
    """The launch ``flash_attention_launch`` makes for q (B, Sq, H, D) and
    k/v (B, Sk, kvH, D) on a card of ``sms`` SMs: ``work_geometry`` of
    csrc/flash_attention.cu, line for line.  Raises where the source
    refuses the shape."""
    if dtype not in _DTYPE_CODE or d not in HEAD_DIMS or min(b, sq, sk, h, kvh) <= 0 or h % kvh:
        raise ValueError(f"the kernel refuses {(b, sq, sk, h, kvh, d)} in {dtype}")
    bf16 = dtype == torch.bfloat16
    if bf16:
        n_work = b * h * -(-sq // TILE_M)
        if n_work > MAX_ITEMS:
            raise ValueError(f"{n_work} work items exceed the kernel's int index")
        grid = (min(n_work, sms), 1)
        threads, smem = THREADS, hopper_geometry(d)["smem_bytes"]
    else:
        if b * h > MAX_GRID_Y:
            raise ValueError(f"B*H = {b * h} exceeds the grid's y limit {MAX_GRID_Y}")
        grid = (-(-sq // F32_BLOCK_M), b * h)
        n_work = grid[0] * grid[1]
        threads = F32_THREADS
        smem = ((F32_BLOCK_M + 2 * F32_BLOCK_N) * (d + 1) + F32_BLOCK_M * (F32_BLOCK_N + 1)) * 4
    return FlashWorkGeometry(b=b, sq=sq, sk=sk, h=h, kvh=kvh, d=d, causal=causal, bf16=bf16,
                             grid_x=grid[0], grid_y=grid[1], items=n_work, threads=threads,
                             smem=smem, sms=sms)


def work_geometry_query(lib: ctypes.CDLL, b: int, sq: int, sk: int, h: int, kvh: int, d: int,
                        dtype: torch.dtype) -> dict[str, int]:
    """What ``flash_attention_work_geometry_query`` of a built library
    reports for a launch on the current card; raises if it refuses."""
    fn = lib.flash_attention_work_geometry_query
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(WORK_FIELDS))()
    err = fn(b, sq, sk, h, kvh, d, _DTYPE_CODE[dtype], ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"flash_attention_work_geometry_query failed: cudaError {err}")
    return dict(zip(WORK_FIELDS, out))


def rows_aligned(t: torch.Tensor) -> bool:
    """TMA reads a (B, S, heads, D) tensor whose base and byte strides are
    multiples of 16; the kernel's tensor maps take the strides as they are.
    A fake tensor has no address: its base is its storage offset (storages
    are allocated aligned)."""
    base = t.storage_offset() * t.element_size() if is_fake(t) else t.data_ptr()
    return base % 16 == 0 and all(s * t.element_size() % 16 == 0 for s in t.stride()[:3])


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


def launch(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """One launch of ``flash_attention_launch`` (``fn``, from a build of the
    source) on CUDA tensors that ``_check`` has passed; raises if it fails.
    ``out``, when given, is a (B, Sq, H, D) view of q's dtype with any
    strides ``_check`` admits for q (the kernel takes the output's strides
    as arguments); the kernel writes its rows and nothing else."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if out is None:
        out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    elif (out.shape != q.shape or out.dtype != q.dtype or out.device != q.device
          or out.stride(3) != 1 or not rows_aligned(out)):
        raise ValueError(f"out must be a {tuple(q.shape)} {q.dtype} view on {q.device} with "
                         f"16-byte aligned rows, got {tuple(out.shape)} strides {out.stride()}")
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, sq, sk, h, kvh, d, *strides,
                 int(causal), _DTYPE_CODE[q.dtype], 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    return out


def flops(b: int, sq: int, sk: int, h: int, d: int, causal: bool) -> int:
    """4·d FLOP per (row, visible column) pair: QK^T and PV, 2·d each; a
    causal row i sees columns 0..min(i, sk - 1)."""
    if not causal:
        return 4 * b * h * d * sq * sk
    m = min(sq, sk)
    return 4 * b * h * d * (m * (m + 1) // 2 + (sq - m) * sk)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(), device_types="cuda")
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    return launch(_launch_fn(), q, k, v, causal)


@_flash_op.register_fake
def _flash_fake(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool) -> torch.Tensor:
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flop_formula(q_shape, k_shape, v_shape, causal, *_, **__) -> int:
    b, sq, h, d = q_shape
    return flops(b, sq, k_shape[1], h, d, causal)


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
    out = torch.ops.repro_torch.flash_attention(q, k, v, causal)
    if not is_fake(q):
        flash_attention.launches += 1
    return out


flash_attention.launches = 0  # kernel launches; the CPU path does not count
