"""Run one function in one local process per rank of a ``gloo`` group.

The spawner that ``dist.mesh_run`` (the repair executor) and
``dist.model_run`` (the sharded forward) share:

    rows = spawn_ranks(body, world, workdir, (cases,), device="cpu")

starts ``world`` processes (``spawn``).  Each joins a ``gloo`` process group
that meets through the file ``workdir/pg_init`` (no port is chosen, so
concurrent runs do not collide), runs on one intra-op thread (the ranks
share this host's cores) and, on a card, on device 0 (every rank shares the
one card).  It calls ``body(rank, world, device, workdir, *args)`` and
writes the JSON-able list it returns to ``workdir/rank<r>.json``.
:func:`spawn_ranks` returns those lists in rank order.
"""
from __future__ import annotations

import datetime
import json
import os
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, world: int, init_file: str, body: Callable, device: str,
               workdir: str, args: tuple, timeout_s: float) -> None:
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        torch.set_num_threads(1)
        if device == "cuda":
            torch.cuda.set_device(0)
        rows = body(rank, world, device, workdir, *args)
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump(rows, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(body: Callable[..., list], world: int, workdir: str, args: tuple = (), *,
                device: str = "cuda", timeout_s: float = 900,
                env: dict[str, str] | None = None) -> list[list[Any]]:
    """Run ``body`` (a module-level function, so that ``spawn`` can pickle
    it) on ``world`` ranks and return each rank's rows, in rank order.
    ``timeout_s`` bounds each collective of the group; ``env`` is added to
    the ranks' environment (this process's holds it only while they run)."""
    os.makedirs(workdir, exist_ok=True)
    init_file = os.path.join(workdir, "pg_init")
    if os.path.exists(init_file):
        os.remove(init_file)
    env = dict(env or {})
    saved = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    try:
        mp.start_processes(_rank_main,
                           args=(world, init_file, body, device, workdir, tuple(args), timeout_s),
                           nprocs=world, join=True, start_method="spawn")
    finally:
        for key, val in saved.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val
    per_rank = []
    for rank in range(world):
        with open(os.path.join(workdir, f"rank{rank}.json")) as f:
            per_rank.append(json.load(f))
    return per_rank
