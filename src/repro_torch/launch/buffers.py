"""Largest-buffer forensics for a dry-run cell: the counterpart of
``repro.launch.buffers``.

Runs the cell's fake step (``launch.dryrun``) with the :class:`Meter`
keeping, at the step's peak, every live tensor storage rank 0's ops made,
and prints the biggest, grouped by (dtype and shape, producing op): the
first stop when a cell's peak exceeds the 80 GB budget.

  PYTHONPATH=src python -m repro_torch.launch.buffers --arch grok-1-314b \\
      --shape train_4k --rules fsdp_sp --microbatches 4
"""
from __future__ import annotations

import argparse
from collections import Counter

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.models.config import SHAPES


def top_buffers(peak_buffers: list[tuple[str, str, int]], min_bytes: int = 2**27,
                top: int = 20) -> list[dict]:
    """``Meter.peak_buffers`` (dtype and shape, op, bytes) of at least
    ``min_bytes``, grouped and sorted by their total bytes."""
    agg: Counter = Counter()
    for shape, op, nbytes in peak_buffers:
        if nbytes >= min_bytes:
            agg[(shape, op, nbytes)] += 1
    rows = sorted(agg.items(), key=lambda kv: -kv[0][2] * kv[1])[:top]
    return [{"shape": s, "op": op, "gib": round(b / 2**30, 3), "count": c,
             "total_gib": round(b * c / 2**30, 2), "bytes": b} for (s, op, b), c in rows]


def cell_buffers(arch: str, shape_name: str, *, multi_pod: bool = False,
                 rules_mode: str = "tp_sp", microbatches: int = 1,
                 accum_dtype: str = "float32", device: str = "cuda", min_bytes: int = 2**27,
                 top: int = 20, config=None, shape=None, mesh_shape=None) -> dict:
    """The cell's peak and its largest live buffers there."""
    cfg = config or get_config(arch)
    tcfg = dryrun.train_config(cfg, microbatches=microbatches, accum_dtype=accum_dtype)
    got = dryrun.measure_cell(cfg, shape or SHAPES[shape_name], multi_pod=multi_pod,
                              rules_mode=rules_mode, tcfg=tcfg, device=device, buffers=True,
                              mesh_shape=mesh_shape)
    return {"argument_bytes": got["argument_bytes"], "peak_bytes": got["peak_bytes"],
            "buffers": top_buffers(got["meter"].peak_buffers, min_bytes, top)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--rules", default="tp_sp")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--accum-dtype", default="float32")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--min-bytes", type=int, default=2**27)
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)
    got = cell_buffers(args.arch, args.shape, multi_pod=args.mesh == "multi",
                       rules_mode=args.rules, microbatches=args.microbatches,
                       accum_dtype=args.accum_dtype, device=args.device,
                       min_bytes=args.min_bytes, top=args.top)
    print(f"[buffers] argument {got['argument_bytes']} bytes, peak {got['peak_bytes']} bytes")
    for row in got["buffers"]:
        print(row)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
