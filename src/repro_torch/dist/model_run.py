"""Run the sharded prefill forward in one local process per mesh device.

One process per device of a ``(data, model)`` mesh, all on this host, over a
``gloo`` process group that meets through a file (``dist.spawn.spawn_ranks``:
no port is chosen, so concurrent runs do not collide).  Tensors live on
``device``, the card unless the caller asks for the CPU; every rank of a card
run shares the one card, and runs inside ``mesh_collectives.host_staging()``.

    import tempfile
    from repro_torch.dist.model_run import Case, run
    rows = run([Case("dbrx-132b", smoke=True, param_dtype="float32", batch=4, seq=32)],
               workdir=tempfile.mkdtemp(), device="cpu")

Each rank, for each case in turn:

* builds the case's model: seeded (``backbone.init_model`` with a generator
  on ``device`` seeded with ``seed``, the same weights a single process
  draws) or loaded from ``params`` (an ``.npz`` of numpy arrays under the
  port's parameter names).  On a card the ranks build it in rounds, as many
  whole models at once as half the card holds, each keeping only its own
  blocks (``weights.shard_model``) before the next round starts.
  Consecutive cases with the same model reuse it;
* runs ``make_prefill_step(cfg, mesh=, rules=make_rules(mode))`` on the
  case's tokens (:func:`case_tokens`, the same on every rank), from a
  barrier to its synchronised end, under ``obs.tracing`` and a
  :class:`CollectiveCounter`;
* with ``all_positions``, runs ``backbone.forward`` under the mesh once more
  for every position's logits and the MoE's ``aux``.

Each rank writes ``workdir/rank<r>.json``; rank 0 also writes the gathered
logits, ``case<i>.npy`` (B, padded_vocab) in f32 (and ``case<i>_all.npy``).
:func:`run` returns per case the logits, ``aux``, and per rank: the
collectives by kind (every redistribution included) and those the MoE
layer runs itself (``moe_collectives``), the
(token, choice) pairs routed and dropped, the flash kernel's launches, the
bytes staged through the host, peak memory, the time, and the time the
rank spent building the model (``build_s``, 0 where it was reused).  The first flash
call's local shards (``attention.record_flash_inputs``) are also run through
the kernel and its plain version (``flash_max_abs_err``; these launches are
not counted).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import obs
from repro_torch.configs import get_config, get_smoke
from repro_torch.dist.mesh_collectives import host_staging
from repro_torch.dist.sharding import axis_rules, make_rules, use_mesh
from repro_torch.dist.spawn import spawn_ranks
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.launch.mesh import make_model_mesh
from repro_torch.models import attention, backbone
from repro_torch.models.config import ArchConfig
from repro_torch.models.weights import params_from_arrays, shard_model
from repro_torch.serve.serve_step import make_prefill_step

KINDS = ("all_gather", "all_reduce", "reduce_scatter", "all_to_all")


@dataclasses.dataclass(frozen=True)
class Case:
    arch: str
    mode: str = "tp"  # the sharding rules (dist.sharding.MODES)
    mesh: tuple[int, int] = (2, 4)  # (data, model)
    batch: int = 2
    seq: int = 4096
    layers: int | None = None  # depth cut; None: the config's own
    capacity_factor: float | None = None  # None: the config's own
    moe_sharding: str | None = None  # None: the config's own
    smoke: bool = False
    param_dtype: str | None = None  # None: the config's own
    seed: int = 0
    params: str | None = None  # .npz by parameter name; None: seeded from ``seed``
    all_positions: bool = False
    use_flash: bool | None = None  # None: the kernel on a card; True: its plain version on the CPU


def case_config(case: Case) -> ArchConfig:
    """The case's architecture with its cuts and overrides applied."""
    cfg = (get_smoke if case.smoke else get_config)(case.arch)
    if case.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=case.layers)
    if case.param_dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=case.param_dtype)
    if cfg.moe is not None:
        moe = cfg.moe
        if case.capacity_factor is not None:
            moe = dataclasses.replace(moe, capacity_factor=case.capacity_factor)
        if case.moe_sharding is not None:
            moe = dataclasses.replace(moe, sharding=case.moe_sharding)
        cfg = dataclasses.replace(cfg, moe=moe)
    return cfg


def case_tokens(case: Case) -> np.ndarray:
    """The case's prompts, (batch, seq) int32, from numpy's generator seeded
    with ``seed`` (so any process, of either package, draws the same)."""
    cfg = case_config(case)
    rng = np.random.default_rng(case.seed)
    return rng.integers(0, cfg.vocab, size=(case.batch, case.seq), dtype=np.int32)


def seeded_model(case: Case, device: str):
    """The case's seeded model, whole, on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(case.seed)
    return backbone.init_model(case_config(case), generator=gen, device=device)


def _model_key(case: Case) -> tuple:
    return (case.arch, case.mode, case.mesh, case.layers, case.moe_sharding, case.smoke,
            case.param_dtype, case.seed, case.params)


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _build(case: Case, mesh: Any, rank: int, world: int, device: str):
    """The case's model laid out over ``mesh``.  On a card the ranks build
    it in rounds, as many at once as half the card holds whole models, each
    keeping only its blocks before the next round starts."""
    cfg = case_config(case)
    at_once = world
    if device == "cuda":
        whole = sum(p.numel() * p.element_size()
                    for p in backbone.Backbone(cfg, device="meta").parameters())
        at_once = max(1, int(0.5 * torch.cuda.get_device_properties(0).total_memory // whole))
    model = None
    for first in range(0, world, at_once):
        if first <= rank < first + at_once:
            if case.params is None:
                full = seeded_model(case, device)
            else:
                with np.load(case.params) as f:
                    full = params_from_arrays(cfg, dict(f), device=device)
            model = shard_model(full, mesh, make_rules(case.mode))
            del full
            _sync(device)
            if device == "cuda":
                torch.cuda.empty_cache()
        if at_once < world:
            dist.barrier()
    return model


def _kind(op: Any) -> str:
    """A collective op's kind: ``c10d_functional.all_gather_into_tensor`` and
    ``c10d.allgather_`` are both ``all_gather``."""
    name = getattr(op, "__name__", str(op)).split(".")[0].replace("_", "")
    for kind in KINDS:
        if kind.replace("_", "") in name:
            return kind
    return str(op)


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives that run under it, by kind: the functional
    collectives (``torch.ops._c10d_functional``, which DTensor's
    redistributions and ``mesh_collectives`` call), DTensor's
    ``shard_dim_alltoall`` and the ``c10d`` ops.  ``CommDebugMode`` counts
    the same ops, but its module tracker names a module only through its
    parent's forward call, which the port's functional forward never makes,
    and then fails."""

    def __init__(self) -> None:
        super().__init__()
        self.counts: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor lowers it to ops on local tensors first
        out = func(*args, **(kwargs or {}))
        if getattr(func, "namespace", None) in ("_c10d_functional", "c10d", "_dtensor"):
            kind = _kind(func)
            if kind in KINDS:
                self.counts[kind] = self.counts.get(kind, 0) + 1
        return out


def _run_case(i: int, case: Case, model, mesh: Any, rank: int, device: str,
              workdir: str) -> dict:
    cfg = case_config(case)
    rules = make_rules(case.mode)
    tokens = torch.from_numpy(case_tokens(case))
    step = make_prefill_step(cfg, device=device, mesh=mesh, rules=rules,
                             use_flash=case.use_flash)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    launches = flash_attention.launches
    dist.barrier()
    t0 = time.perf_counter()
    with (obs.tracing("model_run") as tr, CollectiveCounter() as comm,
          attention.record_flash_inputs() as captured):
        logits = step(model, {"tokens": tokens})
        _sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    launches = flash_attention.launches - launches
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
    full = logits.full_tensor().float().cpu().numpy()
    row = {
        "rank": rank, "ms": ms, "peak_bytes": peak, "flash_launches": launches,
        "host_staged_bytes": int(tr.counter_value("mesh.bytes.host_staged")),
        "collectives": comm.counts,
        "moe_collectives": {kind: int(tr.counter_value("mesh.collectives", kind=kind))
                            for kind in KINDS},
        "pairs_routed": int(tr.counter_value("moe.pairs.routed")),
        "pairs_dropped": int(tr.counter_value("moe.pairs.dropped")),
        "aux": None, "flash_max_abs_err": None,
    }
    if rank == 0:
        np.save(os.path.join(workdir, f"case{i}.npy"), full)
    if case.all_positions:
        with torch.no_grad(), use_mesh(mesh), axis_rules(rules):
            every, aux = backbone.forward(model, cfg, {"tokens": tokens.to(device)},
                                          use_flash=case.use_flash)
            every = every.full_tensor().float().cpu().numpy()
        row["aux"] = float(aux)
        if rank == 0:
            np.save(os.path.join(workdir, f"case{i}_all.npy"), every)
    if captured:
        before = flash_attention.launches
        got = flash_attention(captured["q"], captured["k"], captured["v"],
                              causal=captured["causal"])
        flash_attention.launches = before  # a check, not the main path
        want = flash_attention_ref(captured["q"], captured["k"], captured["v"],
                                   causal=captured["causal"])
        row["flash_max_abs_err"] = float((got.float() - want.float()).abs().max())
        row["flash_shape"] = {key: list(captured[key].shape) for key in ("q", "k")}
    return row


def _rank_rows(rank: int, world: int, device: str, workdir: str,
               cases: list[Case]) -> list[dict]:
    # gloo cannot all-gather card tensors: stage that one collective
    staging = host_staging() if device == "cuda" else contextlib.nullcontext()
    with staging:
        rows, model, key, meshes = [], None, None, {}
        for i, case in enumerate(cases):
            mesh = meshes.get(case.mesh)
            if mesh is None:
                mesh = meshes[case.mesh] = make_model_mesh(case.mesh, device_type=device)
            build_s = 0.0
            if _model_key(case) != key:
                model = None
                if device == "cuda":
                    torch.cuda.empty_cache()
                t0 = time.perf_counter()
                model, key = _build(case, mesh, rank, world, device), _model_key(case)
                build_s = time.perf_counter() - t0
            rows.append({**_run_case(i, case, model, mesh, rank, device, workdir),
                         "build_s": build_s})
    return rows


def run(cases: list[Case], *, workdir: str, device: str = "cuda") -> list[dict]:
    """Run ``cases`` in one process per mesh device (every case's mesh must
    have the same size) and return one merged result per case."""
    worlds = {case.mesh[0] * case.mesh[1] for case in cases}
    if len(worlds) != 1:
        raise ValueError(f"cases of one run need one world size, got {sorted(worlds)}")
    world = worlds.pop()
    per_rank = spawn_ranks(_rank_rows, world, workdir, (list(cases),), device=device)
    merged = []
    for i, case in enumerate(cases):
        rows = [per_rank[rank][i] for rank in range(world)]
        out = {
            "case": dataclasses.asdict(case), "world": world,
            "logits": np.load(os.path.join(workdir, f"case{i}.npy")),
            "ranks": rows,
            "ms": max(row["ms"] for row in rows),
            "flash_launches": sum(row["flash_launches"] for row in rows),
            "aux": rows[0]["aux"],
        }
        if case.all_positions:
            out["logits_all"] = np.load(os.path.join(workdir, f"case{i}_all.npy"))
        merged.append(out)
    return merged
