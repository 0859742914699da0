"""Repair layering walk-through (paper §2.2 Fig. 1 + §3.2 Fig. 2).

The port's counterpart of ``examples/repair_layering_demo.py``.  Reproduces
the motivating example: repairing one block of a (6,3) stripe under (a) MSR
flat placement, (b) MSR hierarchical placement, (c) DRC, showing the
cross-rack bandwidth dropping 5B/3 -> 4B/3 -> B; prints the per-stage DoubleR
workflow (NodeEncode / RelayerEncode / Decode) of the DRC plan and the
simulated recovery numbers of §6.

Finally runs the whole thing again under a ``repro_torch.obs`` tracer:
executes each plan on real payload bytes on the card (DRC family 1, DRC
family 2, RS; the CPU with ``--device cpu``), holds the traced inner- and
cross-rack byte counters equal to the plan's symbolic bandwidth accounting,
checks that the simulator's stage spans match the ``StageTimes`` schema, and
writes a Chrome-trace JSON (chrome://tracing) and its ``.summary.json``.

  PYTHONPATH=src python -m repro_torch.examples.repair_layering \\
      [--trace-out repair_layering_trace.json] [--device cpu]

``main(argv)`` returns what it checked.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.codes import make_code
from repro_torch.core.repair import TARGET
from repro_torch.storage import ClusterSim, StageTimes

# one code per repair-plan shape the paper deploys: DRC family 1 (§4.2),
# DRC family 2 (§4.3, repair-by-transfer), RS
TRACED_CODES = [("DRC", 9, 6, 3), ("DRC", 9, 5, 3), ("RS", 9, 5, 3)]
SUB_BYTES = 4096  # bytes per subblock unit in the real-byte execution


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def traced_section(trace_out: str, device: torch.device) -> dict:
    """Execute and simulate under a tracer; cross-check; write the trace.
    Returns each code's traced and symbolic bytes and the summary's path."""
    rng = np.random.default_rng(0)
    sim = ClusterSim()
    rows = {}
    with obs.tracing("repair_layering_demo") as tr:
        for fam, n, k, r in TRACED_CODES:
            code = make_code(fam, n, k, r)
            plan = code.repair_plan(0)
            data = rng.integers(0, 256, size=(code.k * code.alpha, SUB_BYTES), dtype=np.uint8)
            nodes = code.encode(torch.from_numpy(data).to(device))
            before = {scope: tr.counter_value(f"repair.bytes.{scope}_rack")
                      for scope in ("inner", "cross")}
            rebuilt = plan.execute({i: nodes[i] for i in plan.participants()})
            _check(torch.equal(rebuilt, nodes[0]), f"{code!r} repair wrong")
            # traced bytes must equal the plan's symbolic accounting
            symbolic = plan.traffic_blocks()
            block_bytes = code.alpha * SUB_BYTES
            row = {}
            for scope in ("inner", "cross"):
                traced = tr.counter_value(f"repair.bytes.{scope}_rack") - before[scope]
                expect = symbolic[f"{scope}_rack_blocks"] * block_bytes
                _check(abs(traced - expect) < 0.5,
                       f"{code!r} {scope}: traced {traced} != symbolic {expect}")
                row[f"{scope}_rack_bytes"] = traced
            # the simulated stage decomposition rides the same trace
            sim.stage_times(code, plan, 64.0, gateway_gbps=1.0)
            rows[str(code)] = {**row, "cross_rack_blocks": symbolic["cross_rack_blocks"]}
            print(f"  {code!r}: rebuilt OK; traced cross-rack "
                  f"{row['cross_rack_bytes'] / 1024:.1f} KiB == symbolic "
                  f"{symbolic['cross_rack_blocks']:.3f} blocks")
        # every stage_times call must have emitted the full StageTimes schema
        schema = set(StageTimes(0, 0, 0, 0, 0, 0, 0).as_dict())
        stage_spans = tr.spans_in_cat("stage")
        got = {s.name for s in stage_spans}
        _check(got == schema == set(obs.STAGE_NAMES), f"stage spans {got} != {schema}")
        _check(len(stage_spans) == len(schema) * len(TRACED_CODES),
               f"{len(stage_spans)} stage spans")
    summary_out = trace_out.replace(".json", ".summary.json")
    obs.write_chrome_trace(tr, trace_out)
    obs.write_summary(tr, summary_out)
    print(f"  stage spans match StageTimes schema: {sorted(schema)}")
    print(f"  wrote {trace_out} (load in chrome://tracing)")
    return {"codes": rows, "trace": trace_out, "summary": summary_out}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace-out", default="repair_layering_trace.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print("== paper §3.2 motivating example (B = 1 block) ==")
    motivating = {}
    for fam, n, k, r in [("MSR", 6, 3, 6), ("MSR", 6, 3, 3), ("DRC", 6, 3, 3)]:
        code = make_code(fam, n, k, r)
        t = code.repair_plan(0).traffic_blocks()
        tag = f"{fam}({n},{k},{r})"
        motivating[tag] = t["cross_rack_blocks"]
        print(f"  {tag:12s} cross-rack bandwidth = {t['cross_rack_blocks']:.3f} B")

    print("\n== DoubleR workflow for DRC(9,6,3), failed node N1 ==")
    code = make_code("DRC", 9, 6, 3)
    plan = code.repair_plan(0)
    pl = plan.placement
    for s in plan.node_sends:
        dst = "target" if s.dst == TARGET else f"relayer N{s.dst + 1}"
        kind = "raw subblocks" if np.all(
            (s.matrix.sum(1) == 1) & (s.matrix.max(1) == 1)
        ) else "encoded subblocks (NodeEncode)"
        print(f"  N{s.src + 1} (rack {pl.rack_of(s.src)}) -> {dst}: "
              f"{s.units} x B/{plan.alpha} {kind}")
    for s in plan.relayer_sends:
        print(f"  N{s.src + 1} (rack {pl.rack_of(s.src)}) == RelayerEncode ==> "
              f"target: {s.units} x B/{plan.alpha} re-encoded subblocks [cross-rack]")
    print(f"  target: Decode({plan.decode.shape[1]} units) -> block N1")

    print("\n== §6 testbed simulation (64 MiB blocks, 1 Gb/s gateway) ==")
    sim = ClusterSim()
    simulated = {}
    for fam, n, k, r in [("RS", 9, 5, 3), ("DRC", 9, 5, 3)]:
        c = make_code(fam, n, k, r)
        tput = sim.node_recovery_throughput(c, gateway_gbps=1.0)
        dr = sim.degraded_read_time(c, gateway_gbps=1.0)
        simulated[str(c)] = {"recovery_mib_s": tput, "degraded_read_s": dr}
        print(f"  {fam}({n},{k},{r}): recovery {tput:6.1f} MiB/s, "
              f"degraded read {dr:.2f} s")

    print("\n== stage-level trace (repro_torch.obs) ==")
    traced = traced_section(args.trace_out, torch.device(args.device))
    print("demo OK")
    return {"device": args.device, "motivating": motivating, "simulated": simulated, **traced}


if __name__ == "__main__":
    main()
