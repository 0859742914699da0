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
the kernel or raises.  The launch is the custom op ``repro_torch::gf_matmul``
(it writes ``out`` in place), so a dispatch mode sees the product as one op
and a fake tensor takes its fake kernel, which launches nothing: the traced
layer (``repro_torch.check.traced``) captures the program the card runs.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.core.gf_torch import gf_matmul_table

from . import build

_ALIGN = 16  # the kernel's vector path: cp.async and 16-byte stores

# The kernel's constants (csrc/gf_matmul.cu, above ``struct Geometry``).
WARPS = 16
MAX_ROWS_PER_WARP = 9  # a row warp's output rows in one pass
ROWS_PER_PASS = WARPS * MAX_ROWS_PER_WARP
LIST_STRIDE = 2 * (1 + MAX_ROWS_PER_WARP)  # bytes of one work list
SLICE_BYTES = 1024  # a column warp's slice: 32 lanes x 32 bytes
HALF = SLICE_BYTES // 2  # a lane's second 16 bytes start here
STAGES = 2
STAGE_BYTES = 64 * 1024
MAX_SMEM = 232_448  # bytes of shared memory one block can use on Hopper
MAX_GRID_Y = 65_535
# the fields ``gf_matmul_geometry_query`` returns, in order
QUERY_FIELDS = ("wr", "wc", "tile_bytes", "rows_per_pass", "passes", "chunk_rows", "chunks",
                "ring_bytes", "acc_bytes", "list_bytes", "tiles", "grid_x", "per_sm", "smem",
                "sms")


@dataclasses.dataclass(frozen=True)
class GfGeometry:
    """One launch of the kernel: its ``Geometry``, grid and shared memory,
    and the work walk its blocks run, for the checker
    (``repro_torch.check.lowered.cuda``) to sweep without a card.

    Block ``(bx, g)`` of the ``(grid_x, G)`` grid takes items ``bx, bx +
    grid_x, ..`` (the source's ``Cursor``); item ``i`` is pass ``i % passes``
    of column tile ``i // passes``.  In an item, row warp ``w`` of column
    warp ``c`` owns output rows ``warp_rows(pass, w)`` and the tile's slice
    ``c``; the K input rows arrive in ``k_chunks()``; bytes at or past B are
    masked (zero-filled on load, not stored).
    """

    g: int
    r: int
    k: int
    b: int
    wr: int
    wc: int
    tile_bytes: int
    rows_per_pass: int
    passes: int
    chunk_rows: int
    chunks: int
    ring_bytes: int
    acc_bytes: int
    list_bytes: int
    tiles: int
    grid_x: int
    per_sm: int
    smem: int
    sms: int

    def query_fields(self) -> dict[str, int]:
        return {name: getattr(self, name) for name in QUERY_FIELDS}

    @property
    def items(self) -> int:
        return self.tiles * self.passes

    def block_items(self) -> tuple[np.ndarray, np.ndarray]:
        """(block x, item) of every item visit of one batch row, in each
        block's order: block bx runs its ``(items - 1 - bx) // grid_x + 1``
        items ``bx + s * grid_x``."""
        bx = np.arange(self.grid_x, dtype=np.int64)
        mine = np.where(bx < self.items, (self.items - 1 - bx) // max(self.grid_x, 1) + 1, 0)
        blocks = np.repeat(bx, mine)
        step = np.arange(len(blocks), dtype=np.int64) - np.repeat(np.cumsum(mine) - mine, mine)
        return blocks, blocks + step * self.grid_x

    def place(self, item: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(column tile, pass) of each item."""
        return item // self.passes, item % self.passes

    def warp_rows(self, p, w):
        """Output rows [lo, lo + n) of row warp ``w`` in pass ``p``."""
        pass_rows = np.minimum(self.rows_per_pass, self.r - p * self.rows_per_pass)
        lo = p * self.rows_per_pass + w * pass_rows // self.wr
        return lo, p * self.rows_per_pass + (w + 1) * pass_rows // self.wr - lo

    def column_slice(self, tile, c):
        """Columns [c0, c1) column warp ``c`` stores of ``tile``: its 1 KB
        slice, cut at B by the tail mask (empty where c0 >= B)."""
        c0 = tile * self.tile_bytes + c * SLICE_BYTES
        return c0, np.maximum(np.minimum(c0 + SLICE_BYTES, self.b), c0)

    def k_chunks(self) -> list[tuple[int, int]]:
        """(first input row, rows) of each ring stage of an item."""
        return [(j0, min(self.chunk_rows, self.k - j0))
                for j0 in range(0, self.chunks * self.chunk_rows, self.chunk_rows)]


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def gf_matmul_geometry(g: int, r: int, k: int, b: int, *, sms: int,
                       per_sm: int = 1) -> GfGeometry:
    """The launch ``gf_matmul_launch`` makes for a (G, R, K, B) product on a
    card of ``sms`` SMs that admits ``per_sm`` blocks of its shared memory
    (the two facts the source reads from the device): ``make_geometry``
    and ``plan_launch`` of csrc/gf_matmul.cu, line for line.  Raises where
    the source refuses the shape."""
    if min(g, r, k, b) <= 0 or g > MAX_GRID_Y:
        raise ValueError(f"the kernel refuses (G, R, K, B) = {(g, r, k, b)}")

    def tile(wr: int) -> int:
        return (WARPS // wr) * SLICE_BYTES

    def fits(rpp: int, wr: int, passes: int) -> bool:
        least = rpp * tile(wr) + passes * k * wr * LIST_STRIDE + STAGES * tile(wr)
        return _ceil(rpp, wr) <= MAX_ROWS_PER_WARP and least <= MAX_SMEM

    passes = _ceil(r, ROWS_PER_PASS)
    while True:
        rpp = _ceil(r, passes)
        wr = 1
        while wr <= WARPS and not fits(rpp, wr, passes):
            wr *= 2
        if wr <= WARPS:
            break
        if passes >= r:
            raise ValueError(f"no geometry fits (G, R, K, B) = {(g, r, k, b)}")
        passes += 1
    while wr < WARPS and _ceil(b, tile(wr)) * g < sms:
        wr *= 2
        if not fits(rpp, wr, passes):
            wr //= 2
            break
    tile_bytes = tile(wr)
    acc_bytes = rpp * tile_bytes
    list_bytes = passes * k * wr * LIST_STRIDE
    stage = min((MAX_SMEM - acc_bytes - list_bytes) // STAGES, STAGE_BYTES)
    chunk_rows = min(stage // tile_bytes, k)
    ring_bytes = STAGES * chunk_rows * tile_bytes
    tiles = _ceil(b, tile_bytes)
    want = max(sms * per_sm // g, 1)
    return GfGeometry(
        g=g, r=r, k=k, b=b, wr=wr, wc=WARPS // wr, tile_bytes=tile_bytes,
        rows_per_pass=rpp, passes=passes, chunk_rows=chunk_rows,
        chunks=_ceil(k, chunk_rows), ring_bytes=ring_bytes, acc_bytes=acc_bytes,
        list_bytes=list_bytes, tiles=tiles, grid_x=min(tiles * passes, want), per_sm=per_sm,
        smem=ring_bytes + acc_bytes + list_bytes, sms=sms)


def geometry_query(lib: ctypes.CDLL, g: int, r: int, k: int, b: int) -> dict[str, int]:
    """What ``gf_matmul_geometry_query`` of a built library reports for a
    (G, R, K, B) product on the current card; raises if it refuses."""
    fn = lib.gf_matmul_geometry_query
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(QUERY_FIELDS))()
    err = fn(g, r, k, b, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"gf_matmul_geometry_query{(g, r, k, b)} failed: cudaError {err}")
    return dict(zip(QUERY_FIELDS, out))


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


@torch.library.custom_op("repro_torch::gf_matmul", mutates_args=("out",), device_types="cuda")
def _gf_op(m: torch.Tensor, x: torch.Tensor, out: torch.Tensor) -> None:
    launch(_launch_fn(), m, x, out)


@_gf_op.register_fake
def _gf_fake(m: torch.Tensor, x: torch.Tensor, out: torch.Tensor) -> None:
    return None


def gf_matmul_batched(
    m: torch.Tensor, x: torch.Tensor, out: torch.Tensor | None = None
) -> torch.Tensor:
    """G independent GF(256) products: m (G,R,K) x x (G,K,B) -> (G,R,B) uint8.

    ``out``, when given, is written in place (it may be a contiguous view
    into a larger buffer, e.g. a stripe's parity rows).  A CUDA tensor takes
    the custom op ``repro_torch::gf_matmul``; a fake one launches nothing and
    is not counted.
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
    torch.ops.repro_torch.gf_matmul(m, x, out)
    if not is_fake(x):
        gf_matmul_batched.launches += 1
    return out


gf_matmul_batched.launches = 0  # kernel launches; the CPU path does not count
