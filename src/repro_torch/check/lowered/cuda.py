"""The CUDA kernels' launch geometry swept in interval arithmetic, and GF
dtype safety of the Python GF paths.

The counterpart of ``repro.check.lowered.pallas``, rewritten for a
persistent grid.  A Pallas ``BlockSpec`` grid writes each output block
once by construction; the port's kernels do not have that guarantee: their
blocks walk work items (``bx, bx + grid_x, ..``) and compute their own
offsets, so a skipped item leaves ``torch.empty`` garbage and a doubled one
races.  The artifacts are the launch models the launchers' host code is
held to (``kernels/gf_matmul.py::gf_matmul_geometry``,
``kernels/flash_attention.py::flash_attention_work_geometry``; on the card
``chip_smoke.py`` holds each equal to the built kernel's own query):

* ``lowered.cuda.oob`` — for every block, item and warp, every read and
  write stays in bounds: GF rows of m, x and y and the work lists inside
  ``(G, R, K)``, ``(G, K, B)``, ``(G, R, B)`` and the shared memory, each
  item's column tile starting inside B (the ``c < B`` mask covers a ragged
  edge, not a whole tile); flash Q/K/V tile origins, the kv head and the
  stored rows inside ``(B, S, H|kvH, D)`` (the TMA clips a tile's tail);
  the grid within CUDA's limits (y <= 65,535); the dynamic shared memory
  <= 232,448 bytes.
* ``lowered.cuda.out-alias`` — every output element is written by exactly
  one (block, item, warp): a GF ``(g, row, byte)`` of y, a flash ``(b,
  row, h)`` row of the output.  Swept over (item, row range, column range)
  rectangles, not byte by byte: a DRC(9,6,3) encode at 64 MiB blocks is a
  few tens of thousands of rectangles.
* ``lowered.cuda.gf-dtype`` — the reference's uint8-taint AST pass with
  torch's spellings, over the Python GF paths (``core/gf_torch.py``,
  ``kernels/ops.py``, ``kernels/gf_matmul.py``): ``+``/``-``/``*`` on
  uint8 wraps mod 256 where GF(2^8) addition is ``^``, a product
  accumulates in uint8, and a uint8 tensor used as an index is read as a
  boolean mask.  The CUDA source itself is held byte-equal to the plain
  version on the card.
"""
from __future__ import annotations

import ast
import math
from typing import Any, Iterable

import numpy as np

from ..ast_rules import u8_hazards
from ..report import FAIL, Finding, LoweredRecord
from .base import CUDA_FAMILY, rule

R_CU_OOB = "lowered.cuda.oob"
R_CU_ALIAS = "lowered.cuda.out-alias"
R_CU_DTYPE = "lowered.cuda.gf-dtype"

SMS = 132  # an H100 SXM's streaming multiprocessors: the sweep's card
MAX_GRID_X = 2**31 - 1


def _is_gf(geom: Any) -> bool:
    return hasattr(geom, "tile_bytes")


def _name(geom: Any) -> str:
    if _is_gf(geom):
        return f"gf_matmul{(geom.g, geom.r, geom.k, geom.b)}"
    dtype = "bf16" if geom.bf16 else "f32"
    causal = "causal" if geom.causal else "full"
    return (f"flash_attention({geom.b},{geom.sq},{geom.sk},{geom.h},{geom.kvh},{geom.d},"
            f"{causal},{dtype})")


def _first(mask: np.ndarray) -> int | None:
    idx = np.flatnonzero(mask)
    return int(idx[0]) if idx.size else None


# --------------------------------------------------------------------------
# The walk as rectangles
# --------------------------------------------------------------------------


def gf_writes(geom: Any) -> dict[str, np.ndarray]:
    """One rectangle per (item visit, row warp, column warp) of one batch
    row: output rows [r0, r1) x bytes [c0, c1), cut at B by the tail mask."""
    _, item = geom.block_items()
    tile, p = geom.place(item)
    w = np.arange(geom.wr)
    c = np.arange(geom.wc)
    lo, n = geom.warp_rows(p[:, None], w[None, :])  # (visits, wr)
    c0, c1 = geom.column_slice(tile[:, None], c[None, :])  # (visits, wc)
    shape = (len(item), geom.wr, geom.wc)
    return {
        "r0": np.broadcast_to(lo[:, :, None], shape).ravel(),
        "r1": np.broadcast_to((lo + n)[:, :, None], shape).ravel(),
        "c0": np.broadcast_to(c0[:, None, :], shape).ravel(),
        "c1": np.broadcast_to(c1[:, None, :], shape).ravel(),
    }


def flash_writes(geom: Any) -> dict[str, np.ndarray]:
    """One interval per (item visit, writer): rows [r0, r1) of the output's
    (b, h) column of rows."""
    _, item = geom.block_items()
    at = geom.place(item)
    parts = geom.store_rows(at["q0"])
    key = at["b"] * geom.h + at["h"]
    return {
        "key": np.concatenate([key] * len(parts)),
        "r0": np.concatenate([lo for lo, _ in parts]),
        "r1": np.concatenate([hi for _, hi in parts]),
    }


def _cover_defect(key: np.ndarray, lo: np.ndarray, hi: np.ndarray, n_keys: int,
                  extent: int) -> dict[str, Any] | None:
    """The first defect of intervals [lo, hi) (one key each) as a tiling of
    [0, extent) for every key in range(n_keys): a position written twice or
    never, or None where each position of each key is written once."""
    keep = (hi > lo) & (key >= 0) & (key < n_keys)
    key, lo, hi = key[keep], np.clip(lo[keep], 0, extent), np.clip(hi[keep], 0, extent)
    order = np.lexsort((lo, key))
    key, lo, hi = key[order], lo[order], hi[order]
    present = np.zeros(n_keys, dtype=bool)
    present[key] = True
    if not present.all():
        return {"key": int(np.flatnonzero(~present)[0]), "at": 0, "written": 0}
    first = np.ones(len(key), dtype=bool)
    first[1:] = key[1:] != key[:-1]
    want = np.where(first, 0, np.concatenate(([0], hi[:-1])))
    bad = _first(lo != want)
    if bad is not None:
        if lo[bad] < want[bad]:
            return {"key": int(key[bad]), "at": int(lo[bad]), "written": 2}
        return {"key": int(key[bad]), "at": int(want[bad]), "written": 0}
    last = np.ones(len(key), dtype=bool)
    last[:-1] = key[1:] != key[:-1]
    bad = _first(last & (hi != extent))
    if bad is not None:
        return {"key": int(key[bad]), "at": int(hi[bad]), "written": 0}
    return None


# --------------------------------------------------------------------------
# lowered.cuda.oob
# --------------------------------------------------------------------------


def _gf_oob(geom: Any) -> list[Finding]:
    from repro_torch.kernels import gf_matmul as gk

    name = _name(geom)
    out: list[Finding] = []

    def fail(msg: str, **witness: Any) -> None:
        out.append(Finding(R_CU_OOB, FAIL, f"{name}: {msg}", witness))

    if not 1 <= geom.grid_x <= MAX_GRID_X or not 1 <= geom.g <= gk.MAX_GRID_Y:
        fail(f"grid ({geom.grid_x}, {geom.g}) outside CUDA's limits "
             f"(x <= {MAX_GRID_X}, y <= {gk.MAX_GRID_Y})", grid=[geom.grid_x, geom.g])
    used = geom.ring_bytes + geom.acc_bytes + geom.list_bytes
    if not used <= geom.smem <= gk.MAX_SMEM:
        fail(f"shared memory: ring + accumulators + lists = {used} B in a block of "
             f"{geom.smem} B (at most {gk.MAX_SMEM})", used=used, smem=geom.smem)
    if (geom.wr * geom.wc != gk.WARPS or geom.wc * gk.SLICE_BYTES != geom.tile_bytes
            or gk.STAGES * geom.chunk_rows * geom.tile_bytes > geom.ring_bytes):
        fail(f"{geom.wr} row x {geom.wc} column warps, tile {geom.tile_bytes} B and ring "
             f"{geom.ring_bytes} B do not fit the block's {gk.WARPS} warps and their rings",
             wr=geom.wr, wc=geom.wc, tile_bytes=geom.tile_bytes, ring_bytes=geom.ring_bytes)
    for j0, rows in geom.k_chunks():
        if rows < 1 or j0 < 0 or j0 + rows > geom.k:
            fail(f"input rows [{j0}, {j0 + rows}) of a ring stage outside [0, {geom.k})",
                 j0=j0, rows=rows, k=geom.k)
            break
    p, w = np.meshgrid(np.arange(geom.passes), np.arange(geom.wr), indexing="ij")
    lo, n = geom.warp_rows(p, w)
    local = lo - p * geom.rows_per_pass
    bad = (n < 0) | (lo < 0) | (lo + n > geom.r) | (n > gk.MAX_ROWS_PER_WARP) | (
        local < 0) | (local + n > geom.rows_per_pass)
    i = _first(bad.ravel())
    if i is not None:
        pp, ww = int(p.ravel()[i]), int(w.ravel()[i])
        fail(f"row warp {ww} of pass {pp} owns rows [{int(lo.ravel()[i])}, "
             f"{int((lo + n).ravel()[i])}): outside [0, {geom.r}), its accumulators "
             f"({geom.rows_per_pass} rows) or its work list ({gk.MAX_ROWS_PER_WARP} entries)",
             pass_=pp, warp=ww, lo=int(lo.ravel()[i]), n=int(n.ravel()[i]))
    if geom.passes * geom.k * geom.wr * gk.LIST_STRIDE > geom.list_bytes:
        fail("work lists overrun their shared memory", list_bytes=geom.list_bytes)
    blocks, item = geom.block_items()
    tile, pas = geom.place(item)
    i = _first((item < 0) | (item >= geom.items) | (pas < 0) | (pas >= geom.passes)
               | (tile < 0) | (tile * geom.tile_bytes >= geom.b))
    if i is not None:
        fail(f"block {int(blocks[i])} walks item {int(item[i])}: pass {int(pas[i])} of tile "
             f"{int(tile[i])}, whose columns start at {int(tile[i]) * geom.tile_bytes} — "
             f"outside [0, {geom.b}) (the tail mask covers a ragged edge, not a tile)",
             block=int(blocks[i]), item=int(item[i]), tile=int(tile[i]), pass_=int(pas[i]))
    return out


def _flash_oob(geom: Any) -> list[Finding]:
    from repro_torch.kernels import flash_attention as fa

    name = _name(geom)
    out: list[Finding] = []

    def fail(msg: str, **witness: Any) -> None:
        out.append(Finding(R_CU_OOB, FAIL, f"{name}: {msg}", witness))

    if (not 1 <= geom.grid_x <= MAX_GRID_X or not 1 <= geom.grid_y <= fa.MAX_GRID_Y
            or geom.items > fa.MAX_ITEMS):
        fail(f"grid ({geom.grid_x}, {geom.grid_y}) of {geom.items} items outside CUDA's "
             f"limits (y <= {fa.MAX_GRID_Y})", grid=[geom.grid_x, geom.grid_y])
    if geom.smem > fa.SMEM_LIMIT:
        fail(f"{geom.smem} B of dynamic shared memory (at most {fa.SMEM_LIMIT})",
             smem=geom.smem)
    blocks, item = geom.block_items()
    at = geom.place(item)
    checks = (
        ("batch", at["b"], geom.b), ("head", at["h"], geom.h),
        ("kv head", at["kh"], geom.kvh), ("Q tile origin", at["q0"], geom.sq),
        # kv tiles are loaded last first: origins (n_tiles - 1 - t) * tile_n
        ("last kv tile origin", (at["n_tiles"] - 1) * geom.tile_n, geom.sk),
    )
    for what, val, extent in checks:
        i = _first((val < 0) | (val >= extent))
        if i is not None:
            fail(f"block {int(blocks[i])}'s item {int(item[i])} reads {what} {int(val[i])} "
                 f"outside [0, {extent})", block=int(blocks[i]), item=int(item[i]),
                 operand=what, value=int(val[i]), extent=extent)
    i = _first(at["n_tiles"] < 1)
    if i is not None:
        fail(f"item {int(item[i])} visits no kv tile", item=int(item[i]))
    for lo, hi in geom.store_rows(at["q0"]):
        i = _first((hi > lo) & ((lo < 0) | (lo >= geom.sq)))
        if i is not None:
            fail(f"item {int(item[i])} stores rows from {int(lo[i])}, outside [0, {geom.sq})",
                 item=int(item[i]), row=int(lo[i]))
    return out


@rule(R_CU_OOB, CUDA_FAMILY)
def check_cuda_oob(geom: Any) -> list[Finding]:
    """Every access of every block, item and warp is in bounds."""
    return _gf_oob(geom) if _is_gf(geom) else _flash_oob(geom)


# --------------------------------------------------------------------------
# lowered.cuda.out-alias
# --------------------------------------------------------------------------


@rule(R_CU_ALIAS, CUDA_FAMILY)
def check_cuda_out_alias(geom: Any) -> list[Finding]:
    """Every output element is written by exactly one (block, item, warp)."""
    if _is_gf(geom):
        rect = gf_writes(geom)
        # one interval of bytes per (rectangle, row): at most 9 rows each
        rows = rect["r1"] - rect["r0"]
        keep = rows > 0
        rep = np.where(keep, rows, 0)
        key = np.repeat(rect["r0"], rep) + (
            np.arange(rep.sum()) - np.repeat(np.cumsum(rep) - rep, rep))
        defect = _cover_defect(key, np.repeat(rect["c0"], rep), np.repeat(rect["c1"], rep),
                               geom.r, geom.b)
        where = "row {key}, byte {at}"
    else:
        ivl = flash_writes(geom)
        defect = _cover_defect(ivl["key"], ivl["r0"], ivl["r1"], geom.b * geom.h, geom.sq)
        where = "(b, h) = divmod({key}, H), row {at}"
    if defect is None:
        return []
    how = "twice" if defect["written"] else "by no (block, item, warp)"
    return [Finding(
        R_CU_ALIAS, FAIL,
        f"{_name(geom)}: output {where.format(**defect)} is written {how} — "
        + ("a write-write race" if defect["written"] else "torch.empty garbage survives"),
        defect,
    )]


GEOMETRY_RULES = (check_cuda_oob, check_cuda_out_alias)


def analyze_geometry(geom: Any) -> list[Finding]:
    findings: list[Finding] = []
    for fn in GEOMETRY_RULES:
        findings.extend(fn(geom))
    return findings


# --------------------------------------------------------------------------
# lowered.cuda.gf-dtype
# --------------------------------------------------------------------------

_HAZARD_TEXT = {
    "wrap": "on a uint8 operand wraps mod 256 silently — GF(2^8) addition is "
            "XOR (`^`), and widening must be explicit",
    "matmul": "on a uint8 operand accumulates in uint8",
    "index": "indexes by a uint8 tensor, which torch reads as a boolean mask — "
             "index with `.long()`",
}


@rule(R_CU_DTYPE, CUDA_FAMILY)
def check_gf_dtype(path: str, source: str) -> list[Finding]:
    """uint8-taint pass over one Python GF source."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding(R_CU_DTYPE, FAIL, f"{path}: does not parse: {e}", {"path": path})]
    findings: list[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for kind, sub in u8_hazards(node):
                line = getattr(sub, "lineno", 0)
                findings.append(Finding(
                    R_CU_DTYPE, FAIL,
                    f"{path}:{line} ({node.name}): {type(sub).__name__} "
                    f"{_HAZARD_TEXT[kind]}",
                    {"path": path, "line": line, "fn": node.name, "hazard": kind},
                ))
    return findings


# --------------------------------------------------------------------------
# Sweep
# --------------------------------------------------------------------------

BLOCK_BYTES = 64 * 2**20  # the paper's HDFS block: chip_smoke.py's payload size
CODES = (("DRC", 9, 6, 3), ("DRC", 9, 5, 3), ("RS", 9, 6, 3), ("MSR", 9, 6, 3))
# beside the main path's products: a batched ragged one, an unaligned B,
# and an R above one pass's 144 rows
EXTRA_GF_SHAPES = ((9, 5, 7, 333), (1, 6, 12, 65_541), (1, 200, 8, 5_008))
# chip_smoke.py's attention shapes: StarCoder2-3B's prefill at 4 x 4096 and
# the ragged 2 x 1500; whisper-small's encoder (2 x 1500 frames), decoder
# self-attention and cross-attention at 448 text positions, and one decode
# step's cross-attention at batch 8 (family_flash_shapes); then one
# Sq % 128 != 0 shape in bf16 and one in f32 (tests/test_torch_gpu.py)
PREFILL, RAGGED = (4, 4096), (2, 1500)
FAMILY_BATCH, ENGINE_BATCH, WHISPER_TEXT = 2, 8, 448
EXTRA_FLASH_SHAPES = (("bf16", (2, 333, 517, 8, 2, 64, True)),
                      ("f32", (2, 77, 130, 6, 3, 32, False)))

GF_SOURCES = ("repro_torch.core.gf_torch", "repro_torch.kernels.ops",
              "repro_torch.kernels.gf_matmul")


def _sub_bytes(alpha: int) -> int:
    return math.ceil(BLOCK_BYTES / alpha / 128) * 128


def gf_sweep_shapes() -> list[tuple[str, tuple[int, int, int, int]]]:
    """(label, (G, R, K, B)): the four parity encodes at 64 MiB blocks,
    DRC(9,6,3)'s batched NodeEncode, RelayerEncode and decode of one repair
    at full width, and ``EXTRA_GF_SHAPES``."""
    from repro_torch.core.codes import make_code
    from repro_torch.dist.collectives import plan_to_spmd

    out = []
    for fam, n, k, r in CODES:
        code = make_code(fam, n, k, r)
        sub = _sub_bytes(code.alpha)
        out.append((f"{code!r} encode", (1, (n - k) * code.alpha, k * code.alpha, sub)))
        if (fam, n, k, r) != CODES[0]:
            continue
        spec = plan_to_spmd(code, code.repair_plan(0))
        out.append((f"{code!r} node_encode", (code.n, spec.nu, code.alpha, sub)))
        out.append((f"{code!r} relayer_encode",
                    (len(spec.rel_idx), spec.ru, spec.relayer_mats.shape[2], sub)))
        out.append((f"{code!r} decode", (1, *spec.decode.shape, sub)))
    out += [(f"extra {s}", s) for s in EXTRA_GF_SHAPES]
    return out


def flash_sweep_shapes() -> list[tuple[str, str, tuple]]:
    """(label, dtype, (b, sq, sk, h, kvh, d, causal))."""
    from repro_torch.configs import get_config

    sc = get_config("starcoder2-3b")
    wh = get_config("whisper-small")
    hs = (sc.n_heads, sc.n_kv_heads, sc.head_dim)
    hw = (wh.n_heads, wh.n_kv_heads, wh.head_dim)
    f, t = wh.encoder_seq, WHISPER_TEXT
    return [
        ("starcoder2-3b prefill", "bf16", (*PREFILL, PREFILL[1], *hs, True)),
        ("starcoder2-3b ragged prefill", "bf16", (*RAGGED, RAGGED[1], *hs, True)),
        ("whisper-small encoder", "bf16", (FAMILY_BATCH, f, f, *hw, False)),
        ("whisper-small decoder self", "bf16", (FAMILY_BATCH, t, t, *hw, True)),
        ("whisper-small cross prefill", "bf16", (FAMILY_BATCH, t, f, *hw, False)),
        ("whisper-small cross decode", "bf16", (ENGINE_BATCH, 1, f, *hw, False)),
        *[(f"ragged {dtype}", dtype, shape) for dtype, shape in EXTRA_FLASH_SHAPES],
    ]


def sweep_geometries(sms: int = SMS, per_sm: int = 1) -> list[tuple[str, Any]]:
    """(label, geometry) of every swept launch on a card of ``sms`` SMs."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_work_geometry
    from repro_torch.kernels.gf_matmul import gf_matmul_geometry

    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    out = [(label, gf_matmul_geometry(*shape, sms=sms, per_sm=per_sm))
           for label, shape in gf_sweep_shapes()]
    for label, dtype, (b, sq, sk, h, kvh, d, causal) in flash_sweep_shapes():
        out.append((label, flash_attention_work_geometry(b, sq, sk, h, kvh, d, dtypes[dtype],
                                                         sms, causal=causal)))
    return out


def gf_source_paths() -> tuple[str, ...]:
    """Absolute paths of the Python GF sources (CWD-independent)."""
    import importlib.util

    paths = []
    for mod in GF_SOURCES:
        spec = importlib.util.find_spec(mod)
        if spec is None or spec.origin is None:
            raise RuntimeError(f"cannot locate GF module {mod}")
        paths.append(spec.origin)
    return tuple(paths)


def verify_kernel_geometry(label: str, geom: Any, *,
                           family: str = CUDA_FAMILY) -> LoweredRecord:
    grid = [geom.grid_x, geom.g if _is_gf(geom) else geom.grid_y]
    return LoweredRecord(
        label=label, family=family, artifact=f"{_name(geom)} grid={tuple(grid)}",
        findings=analyze_geometry(geom),
        info={"grid": grid, "items": int(geom.items), "smem": int(geom.smem)},
    )


def verify_gf_source(path: str, source: str | None = None, *,
                     family: str = CUDA_FAMILY) -> LoweredRecord:
    if source is None:
        with open(path) as f:
            source = f.read()
    short = "/".join(path.replace("\\", "/").split("/")[-3:])
    return LoweredRecord(
        label=short, family=family, artifact=f"source:{short}",
        findings=check_gf_dtype(path, source), info={"bytes": len(source)},
    )


# --------------------------------------------------------------------------
# Mutations
# --------------------------------------------------------------------------

CUDA_MUTATIONS: dict[str, str] = {
    "cuda_oob_tile": R_CU_OOB,
    "cuda_oob_kv_head": R_CU_OOB,
    "cuda_alias_out": R_CU_ALIAS,
    "gf_xor_as_add": R_CU_DTYPE,
    "gf_uint8_index": R_CU_DTYPE,
}

# (mutation, source module, text, replacement)
_SOURCE_EDITS = {
    "gf_xor_as_add": ("repro_torch.core.gf_torch", "        out ^= t\n",
                      "        out += t\n"),
    "gf_uint8_index": ("repro_torch.core.gf_torch", "[:, x[j].long()]", "[:, x[j]]"),
}


def _mutant(geom: Any, **methods: Any) -> Any:
    """A copy of ``geom`` whose walk has ``methods`` swapped in."""
    import dataclasses

    cls = type(f"Mutant{type(geom).__name__}", (type(geom),), methods)
    return cls(**{f.name: getattr(geom, f.name) for f in dataclasses.fields(geom)})


def mutate_cuda(gf_geom: Any, flash_geom: Any, sources: dict[str, str],
                mutation: str) -> tuple[Any, Any, dict[str, str]]:
    """(gf geometry, flash geometry, sources) with one defect injected."""
    import dataclasses

    if mutation == "cuda_oob_tile":
        # the walk runs one column tile past the end of B
        return dataclasses.replace(gf_geom, tiles=gf_geom.tiles + 1), flash_geom, sources
    if mutation == "cuda_oob_kv_head":
        base = type(flash_geom).place

        def place(self, item):  # kh off by one
            at = base(self, item)
            return {**at, "kh": at["kh"] + 1}

        return gf_geom, _mutant(flash_geom, place=place), sources
    if mutation == "cuda_alias_out":
        base = type(gf_geom).place

        def place(self, item):  # item 1 lands on item 0's (tile, pass)
            tile, p = base(self, item)
            tile0, p0 = base(self, np.zeros_like(item))
            return np.where(item == 1, tile0, tile), np.where(item == 1, p0, p)

        if gf_geom.items < 2:
            raise ValueError("the GF geometry has fewer than two items")
        return _mutant(gf_geom, place=place), flash_geom, sources
    if mutation in _SOURCE_EDITS:
        module, old, new = _SOURCE_EDITS[mutation]
        path = dict(zip(GF_SOURCES, gf_source_paths()))[module]
        if sources[path].count(old) != 1:
            raise ValueError(f"mutation target {old!r} not once in {path}")
        return gf_geom, flash_geom, {**sources, path: sources[path].replace(old, new)}
    raise ValueError(f"unknown cuda mutation {mutation!r}")


def cuda_findings(gf_geom: Any, flash_geom: Any, sources: dict[str, str]) -> list[Finding]:
    """Findings of the whole cuda family over one set of artifacts."""
    findings = analyze_geometry(gf_geom) + analyze_geometry(flash_geom)
    for path, source in sources.items():
        findings += check_gf_dtype(path, source)
    return findings


def read_sources(paths: Iterable[str]) -> dict[str, str]:
    out = {}
    for path in paths:
        with open(path) as f:
            out[path] = f.read()
    return out


__all__ = [
    "R_CU_OOB", "R_CU_ALIAS", "R_CU_DTYPE", "CUDA_MUTATIONS", "analyze_geometry",
    "check_gf_dtype", "cuda_findings", "flash_sweep_shapes", "flash_writes",
    "gf_source_paths", "gf_sweep_shapes", "gf_writes", "mutate_cuda", "read_sources",
    "sweep_geometries", "verify_gf_source", "verify_kernel_geometry",
]
