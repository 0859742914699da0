"""The emulated mesh's design choices, timed on the card.

    PYTHONPATH=src python -m repro_torch.dist.spmd_ablation [--block-mib 64]

Each relayer encodes ``[own payload ++ its pod's NodeEncode pool]``, which
``make_spmd_repair`` holds in two places (the payload tensor and the unit
buffer), and the collector decodes the ``target_idx`` units gathered from
the unit buffer.  Variants, each a swap of one function of
``repro_torch.dist.collectives``:

* ``shipped``: RelayerEncode split into its own-payload and pool columns,
  two launches per relayer reading both in place, the products XORed
  (``_relayer_encode``); the decode input gathered by one copy per run of
  consecutive units (``_gather_rows``);
* ``gather``: each relayer's input copied once into one buffer, one
  batched launch;
* ``index_select``: the decode input gathered by ``torch.index_select``.

For DRC(9,6,3), DRC(9,5,3) and RS(9,6,3), failed node 0, at the paper's
64 MiB block,
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


def relayer_encode_gather(x: torch.Tensor, y_pods: torch.Tensor, rel: np.ndarray,
                          mats: np.ndarray, z: torch.Tensor) -> None:
    """RelayerEncode with each relayer's input gathered once into one buffer,
    then one batched launch."""
    alpha, w = x.shape[1], x.shape[0] // y_pods.shape[0]
    inp = torch.empty((len(rel), alpha + y_pods.shape[1], x.shape[2]),
                      dtype=torch.uint8, device=x.device)
    for i, node in enumerate(rel.tolist()):
        inp[i, :alpha].copy_(x[node])
        inp[i, alpha:].copy_(y_pods[node // w])
    collectives.ops.gf_matmul_batched(mats, inp, out=z)


def gather_rows_index_select(src: torch.Tensor, runs: list[tuple[int, int, int]],
                             dst: torch.Tensor) -> None:
    """The decode input gathered by ``index_select`` over the runs' rows."""
    rows = [s + t for _, s, length in runs for t in range(length)]
    torch.index_select(src, 0, torch.tensor(rows, device=src.device), out=dst)


VARIANTS = {
    "shipped": {},
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


def run_case(spec: tuple, block_mib: int, rounds: int, reps: int) -> dict:
    code = make_code(*spec)
    sub = math.ceil(block_mib * 2**20 / code.alpha / 128) * 128
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    data = torch.randint(0, 256, (code.k * code.alpha, sub), dtype=torch.uint8,
                         device="cuda", generator=gen)
    payloads = torch.stack(code.encode(data))
    del data
    sp = collectives.plan_to_spmd(code, code.repair_plan(0))
    row = sp.target_pod * sp.w
    out = torch.empty_like(payloads)
    for name in VARIANTS:
        with variant(name):
            out.fill_(0xA5)
            collectives.make_spmd_repair(sp)(payloads, out=out)
            torch.cuda.synchronize()
            if not torch.equal(out[row], payloads[0]) or out[:row].any() or out[row + 1:].any():
                raise RuntimeError(f"{code!r} {name}: the repair differs")
    times: dict[str, list[float]] = {}
    for _ in range(rounds):
        for name in VARIANTS:
            with variant(name):
                body = collectives.make_spmd_repair(sp)
                times.setdefault(f"{name} body", []).append(
                    cuda_ms(lambda: body(payloads, out=out), reps))
                times.setdefault(f"{name} spmd_repair", []).append(
                    cuda_ms(lambda: collectives.spmd_repair(code, 0, payloads), reps))
    return {"code": repr(code), "failed": 0, "sub": sub, "relayers": len(sp.rel_idx),
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
        print(json.dumps(run_case(spec, args.block_mib, args.rounds, args.reps)))
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
