"""Ablation of the GF(2^8) kernel's design on the card.

    PYTHONPATH=src python -m repro_torch.kernels.gf_ablation [--rounds 6] [--reps 10]

Builds these variants, each into its own library with the same C entry point
``gf_matmul_launch``:

* ``swar``: the port's first kernel, ``csrc/gf_matmul_swar.cu`` (one LOP3
  per coefficient bit and 4-byte word against splat(c * 2^i) words, every
  coefficient, zeros included), which only this script builds;
* ``no_ring``: the bitsliced kernel of ``csrc/gf_matmul.cu`` with every
  warp loading its payload straight from device memory: no shared-memory
  ring, no cp.async, no group barriers;
* ``predicated``: the multiples chosen by masks (``acc ^= mult & -bit``,
  32 LOP3 per nonzero nibble) instead of a warp-uniform indirect branch;
* ``final``: ``csrc/gf_matmul.cu`` as it is.

``no_ring`` and ``predicated`` are copies of the source with the other
body put in by text replacement (an edit that no longer matches raises); the
source itself has one path.  Every variant is held byte-exact
against ``gf_matmul_table`` at small ragged, unaligned and batched shapes and
at the timed shapes, then all are timed in turns with CUDA events at these
(``main_path_shapes``): at 64 MiB blocks the parity encodes of DRC(9,6,3),
DRC(9,5,3), RS(9,6,3) and MSR(9,6,3), and DRC(9,6,3)'s batched NodeEncode,
RelayerEncode and decode; and that decode at 64 KiB wide, a product small
enough that a launch's fixed costs (host calls, the prologue) show;
``--rounds`` rounds of ``--reps`` launches.  Prints one JSON line per round,
then the median and first round of each, and the card's name and power
limit.  ``--diagnostics`` adds two timed-only variants with wrong results:
``no_load`` (the payload never copied) and ``no_compute`` (every work list
skipped), which split the time between the copies and the arithmetic.
``--sass DIR`` also writes ``cuobjdump -sass`` of the final kernel
there and prints its inner loop's instruction count per (row, coefficient,
byte) at the DRC(9,6,3) encode (``sass_count``).
It needs a card and ``nvcc``; it imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

from repro_torch.core.codes import make_code
from repro_torch.core.gf_torch import gf_matmul_table
from repro_torch.dist.collectives import plan_to_spmd

from . import build
from .gf_matmul import bind, launch

# Each lane loads its two 16 bytes of input row j0 + jj straight from device
# memory and transposes them itself.
_DIRECT_LOAD = """\
      const uint8_t* src = xg + static_cast<long long>(j0 + jj) * B;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t* w = &mult[0][4 * h];
        const long long c = col0 + lane_off + h * kHalf;
        if (!aligned) {
          load16(src, c, B, w);
        } else if (c < B) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + c));
          w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
        } else {
          w[0] = w[1] = w[2] = w[3] = 0u;
        }
      }
      transpose8(mult[0]);
"""
_RING_LOAD = """\
      const uint8_t* planes = stage + jj * kSliceBytes + lane * 16;
      const uint4 a = *reinterpret_cast<const uint4*>(planes);
      const uint4 b = *reinterpret_cast<const uint4*>(planes + kHalf);
      mult[0][0] = a.x; mult[0][1] = a.y; mult[0][2] = a.z; mult[0][3] = a.w;
      mult[0][4] = b.x; mult[0][5] = b.y; mult[0][6] = b.z; mult[0][7] = b.w;
      if (!shared_planes) transpose8(mult[0]);
"""
# The multiples chosen by masks: this select_nibble is defined first and the
# source's branch version is renamed out of the way.
_MASK_SELECT = """\
__device__ __forceinline__ void select_nibble(uint32_t acc[8], const uint32_t m[4][8],
                                              uint32_t n) {
  if (n == 0) return;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t mask = 0u - ((n >> b) & 1u);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] ^= m[b][i] & mask;
  }
}

"""
EDITS = {  # step -> [(old text, new text), ..]
    "ring": [  # no ring: no copies, no group barriers, direct loads
        ("#pragma unroll\n  for (int s = 0; s < kStages - 1; ++s) {\n    issue(s);\n"
         "    cp_async_commit();\n  }\n", ""),
        ("    cp_async_wait<kStages - 2>();  // this thread's copies of chunk q landed\n",
         "    if (false) {\n"),
        ("    cp_async_commit();\n    if (cons.pass", "    cp_async_commit();\n    }\n"
         "    if (cons.pass"),
        (_RING_LOAD, _DIRECT_LOAD),
    ],
    "branch": [
        ("__device__ __forceinline__ void select_nibble(",
         _MASK_SELECT + "__device__ __forceinline__ void select_nibble_by_branch("),
    ],
    # diagnostics: wrong results, timed only
    "load": [("    if (q < steps) {\n      const int j0 = prod.chunk",
              "    if (false) {\n      const int j0 = prod.chunk")],
    "compute": [("      if (count == 0) continue;", "      continue;")],
}
VARIANTS = {"swar": None, "no_ring": ["ring"], "predicated": ["branch"], "final": []}
# --diagnostics: the payload never copied (compute on stale shared memory),
# or every work list skipped (copies, transposition-free stores of zeros)
DIAGNOSTICS = {"no_load": ["load"], "no_compute": ["compute"]}
BLOCK_BYTES = 64 * 2**20
SMALL_BYTES = 64 * 2**10  # the width of the launch-overhead product
CODES = [("DRC", 9, 6, 3), ("DRC", 9, 5, 3), ("RS", 9, 6, 3), ("MSR", 9, 6, 3)]
CHECK_SHAPES = [  # g, r, k, b
    (1, 1, 1, 1), (1, 3, 6, 17), (1, 9, 18, 333), (1, 81, 162, 4099), (9, 5, 7, 333),
    (1, 100, 3, 2048), (2, 13, 1, 1000),
]


def variant_sources(diagnostics: bool = False) -> dict[str, str]:
    """The source text of each variant, by name."""
    src = build.SOURCES["gf_matmul"].read_text()
    out = {}
    for name, steps in {**VARIANTS, **(DIAGNOSTICS if diagnostics else {})}.items():
        if steps is None:
            out[name] = (build.CSRC / "gf_matmul_swar.cu").read_text()
            continue
        out[name] = apply_edits(src, [pair for step in steps for pair in EDITS[step]], name)
    return out


def apply_edits(text: str, pairs: list[tuple[str, str]], name: str) -> str:
    """``text`` with each (old, new) replaced in turn; each old text must
    occur exactly once."""
    for old, new in pairs:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the source has {text.count(old)} of {old!r}")
        text = text.replace(old, new)
    return text


def build_variants(sources: dict[str, str]) -> tuple[dict[str, object], dict[str, str]]:
    """Each variant built into build/kernels/ (one nvcc each, all at once):
    name -> its bound ``gf_matmul_launch``, and name -> library path."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, text in sources.items():
        digest = hashlib.sha256(text.encode()).hexdigest()[:16]
        paths[name] = build.BUILD_DIR / f"gf_ablation_{name}-{digest}.cu"
        paths[name].write_text(text)
    libs = build.compile_sources(paths)
    return ({name: bind(ctypes.CDLL(str(libs[name]))) for name in sources},
            {name: str(libs[name]) for name in sources})


def main_path_shapes(gen: torch.Generator) -> list[tuple[str, torch.Tensor, torch.Tensor]]:
    """The timed products: (label, m, x).  At 64 MiB blocks: the four parity
    encodes, and DRC(9,6,3)'s NodeEncode, RelayerEncode and decode of node 0;
    then that decode at 64 KiB, where a launch's fixed costs show."""
    out = []
    for fam, n, k, r in CODES:
        code = make_code(fam, n, k, r)
        sub = math.ceil(BLOCK_BYTES / code.alpha / 128) * 128
        ka = code.k * code.alpha
        m = torch.from_numpy(np.ascontiguousarray(code.generator[ka:])).cuda()[None]
        x = torch.randint(0, 256, (1, ka, sub), dtype=torch.uint8, device="cuda", generator=gen)
        out.append((f"{code!r} encode", m, x))
    code = make_code("DRC", 9, 6, 3)
    sub = math.ceil(BLOCK_BYTES / code.alpha / 128) * 128
    spec = plan_to_spmd(code, code.repair_plan(0))
    def rand(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=gen)

    m = torch.from_numpy(spec.node_mats).cuda()
    out.append((f"{code!r} node_encode", m, rand(code.n, code.alpha, sub)))
    rel = spec.rel_idx.astype(np.int64)
    m = torch.from_numpy(np.ascontiguousarray(spec.relayer_mats[rel])).cuda()
    out.append((f"{code!r} relayer_encode", m, rand(len(rel), m.shape[2], sub)))
    m = torch.from_numpy(spec.decode).cuda()[None]
    out.append((f"{code!r} decode", m, rand(1, m.shape[2], sub)))
    out.append((f"{code!r} decode 64 KiB", m, rand(1, m.shape[2], SMALL_BYTES)))
    return out


def check_variant(name: str, fn, m: torch.Tensor, x: torch.Tensor, want: torch.Tensor,
                  label: str, out: torch.Tensor | None = None) -> None:
    got = launch(fn, m, x, torch.empty_like(want) if out is None else out)
    torch.cuda.synchronize()
    bad = int((got != want).sum())
    if bad:
        raise RuntimeError(f"{name} at {label}: {bad} bytes differ")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of one call of ``fn`` over ``reps`` calls (warm)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def dump_sass(lib: str, out_dir: str) -> str:
    """``cuobjdump -sass`` of a built library into ``out_dir``; the path."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "gf_matmul.sass")
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    with open(path, "w") as f:
        f.write(text)
    return path


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def _sass_instructions(text: str) -> list[tuple[int, str]]:
    """(address, instruction) of the bitsliced kernel in ``cuobjdump -sass``."""
    start = text.index("gf_bitsliced_kernel")
    end = text.find("Function :", start)
    body = text[start:end if end >= 0 else len(text)]
    return [(int(a, 16), ins) for a, ins in _SASS_LINE.findall(body)]


def _branch_target(ins: str) -> int | None:
    hit = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", ins)
    return int(hit.group(1), 16) if hit else None


def sass_count(text: str, m: np.ndarray) -> dict:
    """Integer instructions of the kernel's inner loop, read from its SASS,
    per (output row, coefficient, payload byte) of the product ``m`` (R, K)
    held in one row warp, as the DRC(9,6,3) encode is:

    * ``per_input_row``: from the load of a work list's head to the first
      entry (transposition, doublings, tests), once per (input row, lane
      group of 32 bytes) whose list is not empty;
    * ``per_coefficient``: the entry loop without its case code (list load,
      accumulator load and store, the two indirect branches, loop control);
    * ``case``: each nibble's straight-line code, found after the branch.

    Raises if the SASS does not have that shape."""
    ins = _sass_instructions(text)
    addr = [a for a, _ in ins]
    brx = [i for i, (_, t) in enumerate(ins) if t.startswith("BRX")]
    if len(brx) != 2:
        raise RuntimeError(f"expected 2 BRX in the kernel, found {len(brx)}")
    lds16 = [i for i, (_, t) in enumerate(ins) if t.startswith("LDS.U16")]
    entry = max(i for i in lds16 if i < brx[0])
    head = max(i for i in lds16 if i < entry)
    cases, regions = [], 0
    for b in brx:
        join = next(_branch_target(t) for _, t in ins[b + 1:] if _branch_target(t) is not None)
        stop = addr.index(join)
        regions += stop - b - 1
        block, sizes = 0, []
        for _, t in ins[b + 1:stop]:
            block += 1
            if _branch_target(t) is not None:
                sizes.append(block)
                block = 0
        if block:
            sizes.append(block)
        cases.append(sizes)
    back = next(i for i in range(addr.index(join), len(ins))
                if (_branch_target(ins[i][1]) or 1 << 62) <= addr[entry])
    per_input_row = entry - head
    per_coefficient = back - entry + 1 - regions
    case = {n: size for n, size in zip(range(1, 16), cases[0])}
    if cases[0] != cases[1] or len(case) != 15:
        raise RuntimeError(f"unexpected case blocks {cases}")
    case[0] = 0
    r, k = m.shape
    total = 0
    for j in range(k):
        col = m[:, j]
        if col.any():
            total += per_input_row
        for c in col[col != 0]:
            total += per_coefficient + case[int(c) & 15] + case[int(c) >> 4]
    return {"per_input_row": per_input_row, "per_coefficient": per_coefficient,
            "case": [case[n] for n in range(16)], "instructions_per_32_bytes": total,
            "per_row_coefficient_byte": total / (r * k * 32)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--sass", default=None, help="write the final kernel's SASS here")
    ap.add_argument("--diagnostics", action="store_true",
                    help="also time the kernel without its copies and without its work lists")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gf_ablation: no CUDA device", file=sys.stderr)
        return 1
    fns, libs = build_variants(variant_sources(args.diagnostics))
    if args.sass:
        path = dump_sass(libs["final"], args.sass)
        code = make_code(*CODES[0])
        with open(path) as f:
            counts = sass_count(f.read(), code.generator[code.k * code.alpha:])
        print(json.dumps({"sass": path, "drc963_encode": counts}))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def rand(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=gen)

    checked = {name: fn for name, fn in fns.items() if name not in DIAGNOSTICS}
    for g, r, k, b in CHECK_SHAPES:
        m, x = rand(g, r, k), rand(g, k, b)
        want = torch.stack([gf_matmul_table(m[i], x[i]) for i in range(g)])
        for name, fn in checked.items():
            check_variant(name, fn, m, x, want, f"{(g, r, k, b)}")
    # unaligned: x and out one byte into their buffers
    m, xbuf = rand(1, 9, 18), rand(1 * 18 * 4096 + 1)
    x = xbuf[1:].view(1, 18, 4096)
    want = gf_matmul_table(m[0], x[0])[None]
    for name, fn in checked.items():
        obuf = torch.zeros(9 * 4096 + 1, dtype=torch.uint8, device="cuda")
        check_variant(name, fn, m, x, want, "unaligned views", obuf[1:].view(1, 9, 4096))
        if int(obuf[0]) != 0:
            raise RuntimeError(f"{name}: wrote before an unaligned view")
    shapes = main_path_shapes(gen)
    for label, m, x in shapes:
        want = torch.stack([gf_matmul_table(m[i], x[i]) for i in range(m.shape[0])])
        for name, fn in checked.items():
            check_variant(name, fn, m, x, want, label)
        del want
    print(json.dumps({"checked": list(checked), "shapes": CHECK_SHAPES + [s[0] for s in shapes]}))

    outs = {label: torch.empty((m.shape[0], m.shape[1], x.shape[2]), dtype=torch.uint8,
                               device="cuda") for label, m, x in shapes}
    times = {label: {name: [] for name in fns} for label, _, _ in shapes}
    for rnd in range(args.rounds):
        for label, m, x in shapes:
            for name, fn in fns.items():
                times[label][name].append(
                    cuda_ms(lambda fn=fn, m=m, x=x, o=outs[label]: launch(fn, m, x, o), args.reps))
        print(json.dumps({"round": rnd, "ms": {lab: {n: t[-1] for n, t in row.items()}
                                                for lab, row in times.items()}}))
    summary = {}
    for label, m, x in shapes:
        row = times[label]
        summary[label] = {"shape": [m.shape[0], m.shape[1], m.shape[2], x.shape[2]],
                          "median_ms": {n: float(np.median(t)) for n, t in row.items()},
                          "first_round_ms": {n: t[0] for n, t in row.items()}}
    print(json.dumps({"rounds": args.rounds, "reps": args.reps, "shapes": summary}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
