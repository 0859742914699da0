"""Quickstart: the paper's repair layering in five minutes.

The port's counterpart of ``examples/quickstart.py``:

1. Encode a stripe with DRC(9,6,3) (hierarchical placement, 3 racks).
2. Kill a node; repair it with the layered plan and inspect the
   inner-rack vs cross-rack traffic (Eq. (3): 2 blocks for (9,6,3)).
3. Compare against RS and MSR on the same stripe.
4. Erasure-code a (tiny) training state and restore it with one shard
   missing: the framework-integration path.

Every GF(2^8) product runs on the card (the CPU with ``--device cpu``).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

``main(argv)`` returns what it checked.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.codes import make_code
from repro_torch.train.checkpoint import encode_state, restore_state

SUB_BYTES = 1 << 16  # bytes per subblock: 64 KiB, the reference demo's


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    rng = np.random.default_rng(0)
    print("== 1. DRC(9,6,3): encode a stripe ==")
    code = make_code("DRC", 9, 6, 3)
    data = rng.integers(0, 256, size=(code.k * code.alpha, SUB_BYTES), dtype=np.uint8)
    payloads = dict(enumerate(code.encode(torch.from_numpy(data).to(device))))
    print(f"  {code}: {code.n} blocks x {data.shape[1] * code.alpha / 2**10:.0f} KiB "
          f"over {code.r} racks ({code.placement.nodes_per_rack}/rack)")

    print("== 2. repair node 0 (degraded read) ==")
    plan = code.repair_plan(0)
    repaired = plan.execute({i: p for i, p in payloads.items() if i != 0})
    if not torch.equal(repaired, payloads[0]):
        raise AssertionError("the layered repair of node 0 is not byte-equal")
    t = plan.traffic_blocks()
    print(f"  exact repair OK; cross-rack={t['cross_rack_blocks']:.2f} blocks "
          f"(Eq.3 minimum), inner-rack={t['inner_rack_blocks']:.2f} blocks")
    print(f"  relayers: {plan.relayers} "
          f"(each ships {list(t['per_relayer_cross'].values())[0]:.2f} blocks)")

    print("== 3. the same repair under RS / MSR ==")
    cross = {str(code): t["cross_rack_blocks"]}
    for fam in ("RS", "MSR"):
        c = make_code(fam, 9, 6, 3)
        cross[str(c)] = c.repair_plan(0).traffic_blocks()["cross_rack_blocks"]
        print(f"  {c}: cross-rack={cross[str(c)]:.2f} blocks")

    print("== 4. erasure-coded training state ==")
    gen = torch.Generator(device=device).manual_seed(0)
    state = {"w": torch.randn((256, 256), generator=gen, device=device)}
    ckpt = encode_state(state, family="DRC", n=9, k=6, r=3, device=device)
    got, report = restore_state(ckpt, state, available=set(range(1, 9)))
    if not torch.equal(got["w"], state["w"]):
        raise AssertionError("the restored state is not byte-equal")
    print(f"  restored with node 0 missing: mode={report.mode}, "
          f"cross-rack={report.cross_rack_blocks:.2f} blocks")
    print("quickstart OK")
    return {"device": str(device), "sub_bytes": SUB_BYTES, "traffic": t, "cross_rack": cross,
            "restore_mode": report.mode, "restore_cross_rack": report.cross_rack_blocks}


if __name__ == "__main__":
    main()
