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

A rank that dies is reported in full.  Each rank writes the Python stack
of every thread to ``workdir/rank<r>.fault`` when it takes SIGSEGV,
SIGBUS, SIGFPE, SIGILL or SIGABRT (``faulthandler``); if a rank dies by a
signal or by an exception, :func:`spawn_ranks` raises one
:class:`RuntimeError` that names the rank, the signal, exit code or
exception, the body and the world size, with the tail of that rank's
``.fault`` file and every rank's exit status.  Nothing is retried.
"""
from __future__ import annotations

import datetime
import faulthandler
import json
import os
import signal
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

FAULT_TAIL_LINES = 40


def fault_path(workdir: str, rank: int) -> str:
    """Where rank ``rank`` records the stacks of a fatal signal."""
    return os.path.join(workdir, f"rank{rank}.fault")


def _rank_main(rank: int, world: int, init_file: str, body: Callable, device: str,
               workdir: str, args: tuple, timeout_s: float) -> None:
    # never closed: the descriptor must outlive everything the rank runs,
    # interpreter exit included
    fault_fd = os.open(fault_path(workdir, rank), os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    faulthandler.enable(file=fault_fd, all_threads=True)
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


def _exit_status(exitcode: int) -> str:
    if exitcode < 0:
        try:
            return f"died by {signal.Signals(-exitcode).name}"
        except ValueError:
            return f"died by signal {-exitcode}"
    return f"exited with code {exitcode}"


def _tail(path: str, lines: int = FAULT_TAIL_LINES) -> list[str]:
    try:
        with open(path, errors="replace") as f:
            return f.read().splitlines()[-lines:]
    except OSError:
        return []


def _dead_rank_error(err: mp.ProcessRaisedException | mp.ProcessExitedException,
                     context: mp.ProcessContext, body: Callable, world: int,
                     workdir: str) -> RuntimeError:
    """One error for a failed spawn.  The rank named is the first whose
    ``.fault`` file holds a fatal signal's stacks (its peers may have
    failed after it, on the connections it dropped), else the one
    ``torch.multiprocessing`` reported first."""
    faulted = [r for r in range(world) if _tail(fault_path(workdir, r))]
    rank = faulted[0] if faulted else err.error_index
    what = _exit_status(context.processes[rank].exitcode)
    if isinstance(err, mp.ProcessRaisedException) and rank == err.error_index:
        what = f"raised {err.msg.strip().splitlines()[-1].strip()}"
    parts = [f"rank {rank} of a world of {world} running {body.__module__}.{body.__qualname__} "
             f"{what}",
             "ranks: " + ", ".join(f"{r} {_exit_status(p.exitcode)}"
                                   for r, p in enumerate(context.processes))]
    fault = _tail(fault_path(workdir, rank))
    if fault:
        parts.append(f"last {len(fault)} lines of {fault_path(workdir, rank)}:")
        parts.extend(fault)
    if isinstance(err, mp.ProcessRaisedException):
        parts.append(f"rank {err.error_index}'s traceback:{err.msg.rstrip()}")
    return RuntimeError("\n".join(parts))


def spawn_ranks(body: Callable[..., list], world: int, workdir: str, args: tuple = (), *,
                device: str = "cuda", timeout_s: float = 900,
                env: dict[str, str] | None = None) -> list[list[Any]]:
    """Run ``body`` (a module-level function, so that ``spawn`` can pickle
    it) on ``world`` ranks and return each rank's rows, in rank order.
    ``timeout_s`` bounds each collective of the group; ``env`` is added to
    the ranks' environment (this process's holds it only while they start).
    A rank that dies raises :class:`RuntimeError` (see the module
    docstring), and the other ranks are stopped."""
    os.makedirs(workdir, exist_ok=True)
    init_file = os.path.join(workdir, "pg_init")
    for path in [init_file] + [fault_path(workdir, r) for r in range(world)]:
        if os.path.exists(path):
            os.remove(path)
    env = dict(env or {})
    saved = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    try:
        context = mp.start_processes(
            _rank_main, args=(world, init_file, body, device, workdir, tuple(args), timeout_s),
            nprocs=world, join=False, start_method="spawn")
    finally:
        for key, val in saved.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val
    try:
        while not context.join():
            pass
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as err:
        raise _dead_rank_error(err, context, body, world, workdir) from err
    per_rank = []
    for rank in range(world):
        with open(os.path.join(workdir, f"rank{rank}.json")) as f:
            per_rank.append(json.load(f))
    return per_rank
