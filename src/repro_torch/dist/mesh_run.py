"""Run the process-group repair executor in r*w local processes.

One process per device of the ``(pod, node)`` mesh, all on this host, over a
``gloo`` process group that meets through a file (``dist.spawn.spawn_ranks``:
no port is chosen, so concurrent runs do not collide).  Payloads live on ``device``, the card
unless the caller asks for the CPU: on a card, the executor stages them
through the host around each ``gloo`` call.

    import tempfile
    from repro_torch.dist.mesh_run import Case, run
    rows = run([Case(("DRC", 9, 6, 3), failed=0, sub=4096)],
               workdir=tempfile.mkdtemp(), device="cpu")

Every case of one call has the same n (the world size); cases may differ in
their (r, w) mesh, and every rank takes part in every mesh.  Each rank
draws the stripe's data on ``device`` from the case's seed
(:func:`case_data`), encodes it with the port, takes its shard and runs ``spmd_repair`` (or
``spmd_node_recovery`` for ``stripes > 0``) under ``obs.tracing``.  Each
rank writes its results to ``workdir/rank<r>.json``; :func:`run` merges them
per case:

* ``equal``: the collector's output equals the stripe's failed payload,
  byte for byte (every stripe, for node recovery);
* ``others_zero``: every other rank returned zeros;
* ``pod_sent_bytes``: bytes passed to ``torch.distributed.send`` from one
  pod to another, summed over ranks (the worker wraps ``send``);
* ``counters``: the traced ``repair.bytes.*`` and ``repair.units_cross``
  values summed over ranks;
* ``gf_calls``: per rank, the traced ``kernel.gf_matmul.calls`` by path
  (``cuda`` or ``ref``); ``launches``: the GF kernel's launches, summed
  over ranks (0 on the CPU);
* ``ms``: the slowest rank's wall time from a barrier to its result
  (synchronised on a card).

With ``save=True`` the collector writes its output to ``workdir/case<i>.npy``.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.core.codes import make_code
from repro_torch.dist.collectives import spmd_node_recovery, spmd_repair
from repro_torch.dist.spawn import spawn_ranks
from repro_torch.kernels.gf_matmul import gf_matmul_batched
from repro_torch.launch.mesh import make_repair_mesh


@dataclasses.dataclass(frozen=True)
class Case:
    code: tuple[str, int, int, int]
    failed: int
    sub: int
    seed: int = 0
    stripes: int = 0  # 0: one stripe through spmd_repair; S: spmd_node_recovery


def case_data(case: Case, device: str = "cuda") -> torch.Tensor:
    """The case's data, (max(1, S), k*alpha, sub) uint8 on ``device``, drawn
    from a generator on that device seeded with the case's seed (so every
    rank of a run draws the same bytes)."""
    code = make_code(*case.code)
    gen = torch.Generator(device=device)
    gen.manual_seed(case.seed)
    return torch.randint(0, 256, (max(1, case.stripes), code.k * code.alpha, case.sub),
                         dtype=torch.uint8, device=device, generator=gen)


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()  # check: ignore[host-sync] a rank's timer ends on the card


def _run_case(case: Case, mesh: Any, rank: int, device: str, sent: dict) -> tuple[dict, Any]:
    code = make_code(*case.code)
    data = case_data(case, device)
    stripes = torch.stack([
        torch.stack(code.encode(data[s])) for s in range(data.shape[0])
    ])  # (S', n, alpha, sub)
    del data
    fn = spmd_node_recovery if case.stripes else spmd_repair
    shard = stripes[:, rank:rank + 1].contiguous() if case.stripes else stripes[0, rank:rank + 1]
    launches = gf_matmul_batched.launches
    sent["pod"] = 0
    dist.barrier()
    t0 = time.perf_counter()
    with obs.tracing("mesh") as tr:
        out, specs = fn(code, case.failed, shard, mesh=mesh)
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    specs = specs if case.stripes else [specs]
    outs = out if case.stripes else out[None]
    spec = specs[0]
    collector = (rank // spec.w, rank % spec.w) == (spec.target_pod, 0)
    if collector:
        equal = all(torch.equal(outs[s, 0], stripes[s, case.failed]) for s in range(len(specs)))
    else:
        equal = None
    counters = {name: tr.counter_value(name) for name in (
        "repair.bytes.inner_rack", "repair.bytes.cross_rack", "repair.bytes.host_staged")}
    counters["repair.units_cross"] = {
        str(q): tr.counter_value("repair.units_cross", pod=str(q)) for q in range(spec.r)}
    row = {
        "rank": rank, "collector": collector, "equal": equal,
        "zero": None if collector else not bool(outs.any()),
        "pod_sent_bytes": sent["pod"], "counters": counters,
        "gf_calls": {path: tr.counter_value("kernel.gf_matmul.calls", path=path)
                     for path in ("cuda", "ref")},
        "relayer_sets": sorted({tuple(sp.rel_idx.tolist()) for sp in specs}),
        "ms": ms,
        "launches": gf_matmul_batched.launches - launches,
    }
    return row, (outs[:, 0].cpu().numpy() if collector else None)


def _rank_rows(rank: int, world: int, device: str, workdir: str, cases: list[Case],
               save: bool) -> list[dict]:
    sent = {"pod": 0, "w": 1}  # bytes sent to another pod; this mesh's w
    send = dist.send

    def counting_send(tensor: torch.Tensor, dst: int | None = None, *args, **kwargs):
        if dst // sent["w"] != rank // sent["w"]:
            sent["pod"] += tensor.numel() * tensor.element_size()
        return send(tensor, dst, *args, **kwargs)

    dist.send = counting_send
    try:
        meshes: dict[tuple[int, int], Any] = {}
        rows = []
        for i, case in enumerate(cases):
            fam, n, k, r = case.code
            w = n // r
            mesh = meshes.get((r, w))
            if mesh is None:
                mesh = meshes[(r, w)] = make_repair_mesh(r, w, device_type="cpu")
            sent["w"] = w
            row, collected = _run_case(case, mesh, rank, device, sent)
            if save and collected is not None:
                np.save(os.path.join(workdir, f"case{i}.npy"), collected)
            rows.append(row)
            if device == "cuda":
                torch.cuda.empty_cache()
        return rows
    finally:
        dist.send = send


def run(cases: list[Case], *, workdir: str, device: str = "cuda",
        save: bool = False) -> list[dict]:
    """Run ``cases`` in n processes (n of the first case, the same for all)
    and return one merged result per case."""
    worlds = {make_code(*c.code).n for c in cases}
    if len(worlds) != 1:
        raise ValueError(f"cases of one run need one world size, got {sorted(worlds)}")
    world = worlds.pop()
    per_rank = spawn_ranks(_rank_rows, world, workdir, (list(cases), save), device=device,
                           timeout_s=600)
    merged = []
    for i, case in enumerate(cases):
        rows = [per_rank[rank][i] for rank in range(world)]
        (coll,) = [row for row in rows if row["collector"]]
        counters = {name: sum(row["counters"][name] for row in rows) for name in (
            "repair.bytes.inner_rack", "repair.bytes.cross_rack", "repair.bytes.host_staged")}
        counters["repair.units_cross"] = {
            q: sum(row["counters"]["repair.units_cross"][q] for row in rows)
            for q in coll["counters"]["repair.units_cross"]}
        merged.append({
            "case": dataclasses.asdict(case), "world": world,
            "collector_rank": coll["rank"], "equal": coll["equal"],
            "others_zero": all(row["zero"] for row in rows if not row["collector"]),
            "pod_sent_bytes": sum(row["pod_sent_bytes"] for row in rows),
            "counters": counters,
            "gf_calls": [row["gf_calls"] for row in rows],
            "relayer_sets": coll["relayer_sets"],
            "launches": sum(row["launches"] for row in rows),
            "ms": max(row["ms"] for row in rows),
        })
    return merged
