"""The emulated mesh's design choices, timed on the card.

    PYTHONPATH=src python -m repro_torch.dist.spmd_ablation [--block-mib 64]

NodeEncode computes only the coded rows of each node's matrix; a unit-vector
row is the payload row it selects, read in place by RelayerEncode and the
decode input, and a zero row is held by none.  Each relayer encodes its own
payload and the units of its pod it reads, which ``make_spmd_repair`` holds
in two places (the payload tensor and the unit buffer), and the collector
decodes the ``target_idx`` units gathered from both.  Variants, each a swap
of one function of ``repro_torch.dist.collectives``:

* ``shipped``: NodeEncode pruned to the coded rows (``_classify_units``);
  RelayerEncode as one product per place it reads, each in place, the
  products XORed (``_relayer_encode``); the decode input gathered by one
  copy per run of consecutive units (``_gather_rows``);
* ``full_node_encode``: every NodeEncode row computed, zero and unit-vector
  rows too, in one launch over all n nodes;
* ``gather``: each relayer's input copied once into one buffer, one
  batched launch;
* ``index_select``: the decode input gathered by ``torch.index_select``.

For DRC(9,6,3), DRC(9,5,3) and RS(9,6,3), failed nodes 0 and 4 (a first and
a middle rack), at the paper's 64 MiB block,
each is held byte-equal to the stripe (with ``out`` holding garbage), then
the repair body (the spec built beforehand) and the whole ``spmd_repair``
call are timed in turns with CUDA events, ``--rounds`` rounds of ``--reps``
calls: the median ms and the min-max spread per variant.  One JSON line per
case.

The script exists to reproduce the measurement that chose ``shipped``: the
other variants live only here, swapped in for the length of a run, and the
executor has no option that selects them.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys

import numpy as np
import torch

from repro_torch.core.codes import make_code
from repro_torch.dist import collectives
from repro_torch.kernels import build
from repro_torch.kernels.gf_ablation import cuda_ms


def classify_all_computed(node_mats: np.ndarray) -> np.ndarray:
    """Every NodeEncode row computed, zero and unit-vector rows too: one
    launch of every node's whole matrix."""
    return np.full(node_mats.shape[:2], collectives._COMPUTED)


def relayer_encode_gather(src, pieces: list, z: torch.Tensor) -> None:
    """RelayerEncode with each relayer's input gathered once into one buffer
    (zero-padded to the longest), then one batched launch."""
    k = max(sum(rows for _, rows, _ in mine) for mine in pieces)
    inp = torch.zeros((len(pieces), k, z.shape[2]), dtype=torch.uint8, device=z.device)
    mats = np.zeros((len(pieces), z.shape[1], k), np.uint8)
    for i, mine in enumerate(pieces):
        col = 0
        for first, rows, m in mine:
            inp[i, col:col + rows].copy_(src[first:first + rows])
            mats[i, :, col:col + rows] = m
            col += rows
    collectives.ops.gf_matmul_batched(mats, inp, out=z)


def gather_rows_index_select(src, runs: list[tuple[int, int, int]],
                             dst: torch.Tensor) -> None:
    """The decode input gathered by ``index_select``, one call per tensor
    it reads."""
    parts = src.parts if isinstance(src, collectives._Rows) else [(0, src)]
    for start, part in parts:
        pairs = [(d + t, s + t - start) for d, s, length in runs for t in range(length)
                 if start <= s < start + part.shape[0]]
        if pairs:
            rows, picks = (torch.tensor(v, device=dst.device) for v in zip(*pairs))
            dst.index_copy_(0, rows, torch.index_select(part, 0, picks))


VARIANTS = {
    "shipped": {},
    "full_node_encode": {"_classify_units": classify_all_computed},
    "gather": {"_relayer_encode": relayer_encode_gather},
    "index_select": {"_gather_rows": gather_rows_index_select},
}


@contextlib.contextmanager
def variant(name: str):
    """Run ``make_spmd_repair`` with the named variant's functions."""
    swaps = VARIANTS[name]
    shipped = {attr: getattr(collectives, attr) for attr in swaps}
    for attr, fn in swaps.items():
        setattr(collectives, attr, fn)
    try:
        yield
    finally:
        for attr, fn in shipped.items():
            setattr(collectives, attr, fn)


def run_case(spec: tuple, failed: int, block_mib: int, rounds: int, reps: int) -> dict:
    code = make_code(*spec)
    sub = math.ceil(block_mib * 2**20 / code.alpha / 128) * 128
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    data = torch.randint(0, 256, (code.k * code.alpha, sub), dtype=torch.uint8,
                         device="cuda", generator=gen)
    payloads = torch.stack(code.encode(data))
    del data
    sp = collectives.plan_to_spmd(code, code.repair_plan(failed))
    row = sp.target_pod * sp.w
    out = torch.empty_like(payloads)
    for name in VARIANTS:
        with variant(name):
            out.fill_(0xA5)
            collectives.make_spmd_repair(sp)(payloads, out=out)
            torch.cuda.synchronize()
            if not torch.equal(out[row], payloads[failed]) or out[:row].any() or out[row + 1:].any():
                raise RuntimeError(f"{code!r} {name}: the repair differs")
    times: dict[str, list[float]] = {}
    for _ in range(rounds):
        for name in VARIANTS:
            with variant(name):
                body = collectives.make_spmd_repair(sp)
                times.setdefault(f"{name} body", []).append(
                    cuda_ms(lambda: body(payloads, out=out), reps))
                times.setdefault(f"{name} spmd_repair", []).append(
                    cuda_ms(lambda: collectives.spmd_repair(code, failed, payloads), reps))
    return {"code": repr(code), "failed": failed, "sub": sub, "relayers": len(sp.rel_idx),
            **{label: {"ms": float(np.median(ts)), "ms_spread": [min(ts), max(ts)]}
               for label, ts in times.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--block-mib", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("spmd_ablation: no CUDA device", file=sys.stderr)
        return 1
    build.build_all(["gf_matmul"])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    for spec in (("DRC", 9, 6, 3), ("DRC", 9, 5, 3), ("RS", 9, 6, 3)):
        for failed in (0, 4):
            print(json.dumps(run_case(spec, failed, args.block_mib, args.rounds, args.reps)))
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
