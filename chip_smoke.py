#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port's repair data path on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, then
drives the main path through the entry points a user calls, at the paper's
64 MiB HDFS block size (one stripe of each code is 9 x 64 MiB = 576 MiB):

1. kernel vs plain: the GF(2^8) kernel against ``gf_matmul_table`` on the
   card, byte-exact, over the reference's test shapes, ragged widths and
   every product shape of the main path at full width; timed with CUDA
   events;
2. encode: systematic in-place encode of one stripe per code;
3. repair: layered repair of nodes 0 and n-1 per code, through both
   ``RepairPlan.execute`` and ``spmd_repair``, byte-exact, with the traced
   byte counters held to ``traffic_blocks() * alpha * sub`` and DRC's
   cross-rack blocks to Eq. (3);
4. node recovery: ``spmd_node_recovery`` of node 0 over 8 stripes of
   DRC(9,6,3) (4.5 GiB of payload), rotating relayers;
5. checkpoint: ``CheckpointManager`` saves a ~256 MiB f32 + bf16 state with
   DRC(9,6,3), one node file is deleted, and the load must repair it.

The kernel's launches are counted over phases 2-5 only.  Any mismatch or
exception exits non-zero.  The last three lines of standard output are the
kernels JSON line, the card's name and power limit, and the result line.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.core.code_base import drc_min_cross_rack_blocks  # noqa: E402
from repro_torch.core.codes import make_code  # noqa: E402
from repro_torch.core.gf_torch import gf_matmul_table  # noqa: E402
from repro_torch.dist.collectives import (  # noqa: E402
    plan_to_spmd,
    spmd_node_recovery,
    spmd_repair,
)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.gf_matmul import gf_matmul_batched  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager, make_encode_step  # noqa: E402

SEED = 0
BLOCK_BYTES = 64 * 2**20  # the paper's HDFS block (examples/repair_layering_demo.py)
CODES = [("DRC", 9, 6, 3), ("DRC", 9, 5, 3), ("RS", 9, 6, 3), ("MSR", 9, 6, 3)]
# tests/test_kernels.py SHAPES, plus the ragged widths of the reference tests
SHAPES = [
    (1, 1, 128), (2, 3, 128), (3, 6, 256), (4, 12, 384), (9, 18, 512),
    (8, 27, 1024), (16, 64, 2048), (27, 162, 512), (3, 6, 17), (3, 6, 333),
]
RECOVERY_STRIPES = 8
DEVICE = "cuda"
# NVIDIA H100 SXM data sheet (dense): HBM rate and int8 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def sub_bytes(alpha: int) -> int:
    return math.ceil(BLOCK_BYTES / alpha / 128) * 128


def rand_bytes(shape: tuple[int, ...], gen: torch.Generator) -> torch.Tensor:
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=DEVICE, generator=gen)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of one call of ``fn`` over ``reps`` calls (warm)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(r: int, k: int, b: int, g: int = 1) -> tuple[float, str]:
    """Least time for a (G, R, K, B) product: each input read once and the
    output written once, against the bitplane form's int8 operations."""
    moved = g * ((r + k) * b + r * k)
    ops = g * 2 * (8 * r) * (8 * k) * b
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


class KernelCheck:
    """Byte-exact comparisons of the kernel with its plain version."""

    def __init__(self) -> None:
        self.compared = 0
        self.mismatched = 0
        self.max_abs_err = 0

    def compare(self, m: torch.Tensor, x: torch.Tensor, label: str) -> torch.Tensor:
        y = gf_matmul_batched(m, x)
        torch.cuda.synchronize()
        for i in range(m.shape[0]):
            want = gf_matmul_table(m[i], x[i])
            diff = (y[i].int() - want.int()).abs()
            bad = int((diff != 0).sum())
            self.mismatched += bad
            self.max_abs_err = max(self.max_abs_err, int(diff.max()) if diff.numel() else 0)
            self.compared += want.numel()
            check(bad == 0, f"kernel vs plain at {label}[{i}]: {bad} bytes differ")
        return y


def phase_kernel(gen: torch.Generator) -> dict:
    kc = KernelCheck()
    for r, k, b in SHAPES:
        kc.compare(rand_bytes((1, r, k), gen), rand_bytes((1, k, b), gen), f"{r}x{k}x{b}")
    kc.compare(rand_bytes((9, 5, 7), gen), rand_bytes((9, 7, 333), gen), "batched ragged")
    timings = []
    for fam, n, k, r in CODES:
        code = make_code(fam, n, k, r)
        sub = sub_bytes(code.alpha)
        ka = code.k * code.alpha
        # the full-width parity encode
        m = torch.from_numpy(np.ascontiguousarray(code.generator[ka:])).to(DEVICE)[None]
        x = rand_bytes((1, ka, sub), gen)
        kc.compare(m, x, f"{code!r} encode")
        out = torch.empty((1, m.shape[1], sub), dtype=torch.uint8, device=DEVICE)
        ms = cuda_ms(lambda: gf_matmul_batched(m, x, out), reps=10)
        plain_ms = cuda_ms(lambda: gf_matmul_table(m[0], x[0]), reps=2)
        b_ms, b_by = bound(m.shape[1], ka, sub)
        timings.append({"code": repr(code), "shape": [1, m.shape[1], ka, sub],
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by})
        del x, out
        # the emulated mesh's batched products of one repair, at full width
        spec = plan_to_spmd(code, code.repair_plan(0))
        nm = torch.from_numpy(spec.node_mats).to(DEVICE)
        xs = rand_bytes((code.n, code.alpha, sub), gen)
        kc.compare(nm, xs, f"{code!r} node_encode")
        ms = cuda_ms(lambda: gf_matmul_batched(nm, xs), reps=3)
        b_ms, b_by = bound(spec.nu, code.alpha, sub, g=code.n)
        timings.append({"code": repr(code), "shape": [code.n, spec.nu, code.alpha, sub],
                        "ms": ms, "bound_ms": b_ms, "bound_by": b_by})
        del xs
        if spec.ru:
            rel = spec.rel_idx.astype(np.int64)
            rm = torch.from_numpy(np.ascontiguousarray(spec.relayer_mats[rel])).to(DEVICE)
            kc.compare(rm, rand_bytes((len(rel), rm.shape[2], sub), gen),
                       f"{code!r} relayer_encode")
        dm = torch.from_numpy(spec.decode).to(DEVICE)[None]
        kc.compare(dm, rand_bytes((1, dm.shape[2], sub), gen), f"{code!r} decode")
        torch.cuda.empty_cache()
    return {"check": kc, "timings": timings}


def phase_encode(gen: torch.Generator) -> dict:
    stripes, out = {}, {}
    for fam, n, k, r in CODES:
        code = make_code(fam, n, k, r)
        sub = sub_bytes(code.alpha)
        ka = code.k * code.alpha
        data = rand_bytes((ka, sub), gen)
        stripe = torch.empty((code.n * code.alpha, sub), dtype=torch.uint8, device=DEVICE)
        stripe[:ka].copy_(data)
        step = make_encode_step(code, sub, DEVICE)
        step(stripe)
        torch.cuda.synchronize()
        check(torch.equal(stripe[:ka], data), f"{code!r}: encode touched the data rows")
        parity = gf_matmul_table(code.generator[ka:], data)
        check(torch.equal(stripe[ka:], parity), f"{code!r}: parity differs from the plain version")
        ms = cuda_ms(lambda: step(stripe), reps=3)
        stripes[(fam, n, k, r)] = stripe.view(code.n, code.alpha, sub)
        out[repr(code)] = {"ms": ms, "stripe_bytes": stripe.numel(), "sub": sub}
        del data, parity
    return {"stripes": stripes, "results": out}


def _check_traffic(tr: obs.Tracer, plan, code, sub: int, label: str) -> dict:
    t = plan.traffic_blocks()
    got = {}
    for scope in ("inner", "cross"):
        want = round(t[f"{scope}_rack_blocks"] * code.alpha) * sub
        got[scope] = tr.counter_value(f"repair.bytes.{scope}_rack")
        check(got[scope] == want, f"{label}: {scope}-rack bytes {got[scope]} != {want}")
    if code.name.startswith("DRC"):
        eq3 = drc_min_cross_rack_blocks(code.n, code.k, code.r)
        check(abs(t["cross_rack_blocks"] - eq3) < 1e-9,
              f"{label}: cross-rack blocks {t['cross_rack_blocks']} != Eq. (3) {eq3}")
    return {"inner_bytes": got["inner"], "cross_bytes": got["cross"],
            "cross_rack_blocks": t["cross_rack_blocks"]}


def phase_repair(stripes: dict) -> dict:
    out = {}
    for (fam, n, k, r), payloads in stripes.items():
        code = make_code(fam, n, k, r)
        sub = payloads.shape[2]
        for failed in (0, n - 1):
            label = f"{code!r} node {failed}"
            plan = code.repair_plan(failed)
            helpers = {i: payloads[i] for i in plan.participants()}
            with obs.tracing("plan") as tr:
                rebuilt = plan.execute(helpers)
            check(torch.equal(rebuilt, payloads[failed]), f"{label}: plan repair differs")
            row = _check_traffic(tr, plan, code, sub, f"{label} plan")
            row["plan_ms"] = cuda_ms(lambda: plan.execute(helpers), reps=1)
            with obs.tracing("spmd") as tr:
                rec, spec = spmd_repair(code, failed, payloads)
            got = rec[spec.target_pod * spec.w]
            check(torch.equal(got, payloads[failed]), f"{label}: spmd repair differs")
            _check_traffic(tr, plan, code, sub, f"{label} spmd")
            del rec, got
            row["spmd_ms"] = cuda_ms(lambda: spmd_repair(code, failed, payloads), reps=1)
            out[label] = row
            torch.cuda.empty_cache()
    return out


def phase_recovery(gen: torch.Generator) -> dict:
    code = make_code("DRC", 9, 6, 3)
    sub = sub_bytes(code.alpha)
    ka = code.k * code.alpha
    step = make_encode_step(code, sub, DEVICE)
    stripes = torch.empty((RECOVERY_STRIPES, code.n * code.alpha, sub),
                          dtype=torch.uint8, device=DEVICE)
    for s in range(RECOVERY_STRIPES):
        stripes[s, :ka] = rand_bytes((ka, sub), gen)
        step(stripes[s])
    payloads = stripes.view(RECOVERY_STRIPES, code.n, code.alpha, sub)
    with obs.tracing("recovery") as tr:
        out, specs = spmd_node_recovery(code, 0, payloads)
    for s, spec in enumerate(specs):
        check(torch.equal(out[s, spec.target_pod * spec.w], payloads[s, 0]),
              f"node recovery stripe {s} differs")
    rel_sets = {tuple(sp.rel_idx.tolist()) for sp in specs}
    check(len(rel_sets) > 1, f"relayers did not rotate: {rel_sets}")
    plan_cross = sum(round(code.repair_plan(0, rotation=s).traffic_blocks()["cross_rack_blocks"]
                           * code.alpha) * sub for s in range(RECOVERY_STRIPES))
    check(tr.counter_value("repair.bytes.cross_rack") == plan_cross,
          "node recovery cross-rack bytes differ from the plans'")
    del out
    ms = cuda_ms(lambda: spmd_node_recovery(code, 0, payloads), reps=1)
    return {"stripes": RECOVERY_STRIPES, "payload_bytes": payloads.numel(),
            "relayer_sets": len(rel_sets), "ms": ms,
            "cross_bytes": tr.counter_value("repair.bytes.cross_rack")}


def make_state(gen: torch.Generator) -> dict:
    """~256 MiB: 8 layers of an f32 weight and two bf16 moments, + a step."""
    state = {"step": torch.tensor([7], dtype=torch.int32, device=DEVICE), "layers": {}}
    for i in range(8):
        state["layers"][f"{i:02d}"] = {
            "w": torch.randn((2048, 2048), generator=gen, device=DEVICE),
            "m": torch.randn((2048, 2048), generator=gen, device=DEVICE).bfloat16(),
            "v": torch.rand((2048, 2048), generator=gen, device=DEVICE).bfloat16(),
        }
    return state


def _leaves(state: dict) -> list[torch.Tensor]:
    if isinstance(state, torch.Tensor):
        return [state]
    return [leaf for key in sorted(state) for leaf in _leaves(state[key])]


def phase_checkpoint(gen: torch.Generator) -> dict:
    state = make_state(gen)
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(state))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, family="DRC", n=9, k=6, r=3, device=DEVICE)
        mgr.save(1, state)
        os.remove(os.path.join(d, "step_00000001", "node_1.bin"))
        got, step, report = mgr.load(state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(step == 1 and report.mode == "repair", f"checkpoint load: step {step}, {report}")
    for a, b in zip(_leaves(got), _leaves(state)):
        check(a.dtype == b.dtype and a.shape == b.shape, "checkpoint leaf shape/dtype")
        check(torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)),
              "checkpoint state is not bit-equal")
    return {"state_bytes": nbytes, "mode": report.mode,
            "cross_rack_blocks": report.cross_rack_blocks, "host_s": dt}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    for name, log in build.build_logs.items():
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", log)]
        spills = [int(w) for w in re.findall(r"(\d+) bytes spill stores", log)]
        print(f"[build {name}] {len(regs)} kernels, registers max {max(regs, default=0)}, "
              f"spill stores max {max(spills, default=0)} bytes")
    print(f"[build] {build_s:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    phases = {}
    t = time.perf_counter()
    k1 = phase_kernel(gen)
    phases["kernel"] = {"timings": k1["timings"], "host_s": time.perf_counter() - t}
    kc = k1["check"]
    print(f"[1 kernel] {kc.compared} bytes compared, {kc.mismatched} differ")
    for row in k1["timings"]:
        print(f"[1 kernel] {json.dumps(row)}")

    gf_matmul_batched.launches = 0  # count the main path's launches only
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    enc = phase_encode(gen)
    phases["encode"] = {"codes": enc["results"], "host_s": time.perf_counter() - t}
    print(f"[2 encode] {json.dumps(enc['results'])}")
    t = time.perf_counter()
    rep = phase_repair(enc["stripes"])
    phases["repair"] = {"cases": rep, "host_s": time.perf_counter() - t}
    for label, row in rep.items():
        print(f"[3 repair] {label}: {json.dumps(row)}")
    del enc
    torch.cuda.empty_cache()
    t = time.perf_counter()
    rec = phase_recovery(gen)
    phases["recovery"] = {**rec, "host_s": time.perf_counter() - t}
    print(f"[4 recovery] {json.dumps(rec)}")
    torch.cuda.empty_cache()
    ck = phase_checkpoint(gen)
    phases["checkpoint"] = ck
    print(f"[5 checkpoint] {json.dumps(ck)}")
    launches = gf_matmul_batched.launches
    check(launches > 0, "the main path launched the GF kernel no time")
    print(f"[peak] {torch.cuda.max_memory_allocated()} bytes allocated")

    head = k1["timings"][0]  # DRC(9,6,3) full-width parity encode
    kernels = {"kernels": [{
        "name": "gf_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gf_matmul.cu",
        "replaces": "src/repro/kernels/gf_matmul.py:110",
        "launches": launches,
        "max_abs_err": kc.max_abs_err,
        "mismatched_bytes": kc.mismatched,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,
        "shape": head["shape"],
    }]}
    print(json.dumps({"phases_host_s": {k: v["host_s"] for k, v in phases.items()},
                      "build_s": build_s, "total_s": time.perf_counter() - t0}))
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
