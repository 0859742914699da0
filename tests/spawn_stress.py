"""Stress of the spawner (``dist.spawn.spawn_ranks``) on the CPU: not a test
module, a script that looks for a rank dying by a signal.

``--spawns N`` runs N spawns of ``--world`` ``gloo`` ranks in turn, their
bodies alternating between one that returns at once (the closing barrier and
``destroy_process_group`` alone) and one that runs DTensor collectives over
a (2, world/2) mesh and leaves; ``--pytest N`` runs the tier-1 command
(``-n 6 --dist loadfile``) N times over the test files that spawn ranks, or
over ``--files``.  Each spawn or run prints one line; a dead rank's report
(its signal and the stack from its ``.fault`` file) is printed whole.

  PYTHONPATH=src python tests/spawn_stress.py --spawns 100
  PYTHONPATH=src python tests/spawn_stress.py --pytest 10
"""
import argparse
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWNING_FILES = [f"tests/test_torch_{name}.py" for name in (
    "mesh_decode", "mesh_families", "mesh_families_train", "mesh_model", "mesh_pod",
    "mesh_train", "dist", "ckpt_sharded")]
DEAD_RANK = re.compile(r"died by SIG|terminated with signal|Fatal Python error")


def returns_at_once(rank, world, device, workdir):
    return [rank]


def dtensor_collectives(rank, world, device, workdir):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = init_device_mesh("cpu", (2, world // 2), mesh_dim_names=("data", "model"))
    x = distribute_tensor(torch.randn(64, 64), mesh, [Shard(0), Shard(1)])
    y = (x @ x.T).redistribute(mesh, [Replicate(), Replicate()])
    z = x.redistribute(mesh, [Replicate(), Shard(0)])
    return [float(y.to_local().sum()), list(z.to_local().shape)]


def spawns(n: int, world: int) -> int:
    from repro_torch.dist.spawn import spawn_ranks

    dead = 0
    for i in range(n):
        body = (returns_at_once, dtensor_collectives)[i % 2]
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            try:
                spawn_ranks(body, world, d, device="cpu", timeout_s=300)
                print(f"spawn {i} {body.__name__} ok {time.perf_counter() - t0:.1f} s", flush=True)
            except RuntimeError as err:
                dead += 1
                print(f"spawn {i} {body.__name__} FAILED:\n{err}", flush=True)
    return dead


def pytest_runs(n: int, files: list[str]) -> int:
    env = {**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu",
           "ALLOW_MULTIPLE_LIBTPU_LOAD": "1"}
    cmd = [sys.executable, "-m", "pytest", "-q", "--continue-on-collection-errors", "-p",
           "no:cacheprovider", "-p", "xdist", "-n", "6", "--dist", "loadfile", "-p",
           "no:randomly", *files]
    dead = 0
    for i in range(n):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                              timeout=1470)
        out = proc.stdout + proc.stderr
        lines = out.strip().splitlines()
        hits = [line for line in out.splitlines() if DEAD_RANK.search(line)]
        dead += bool(hits)
        print(f"run {i} rc={proc.returncode} {time.perf_counter() - t0:.0f} s "
              f"[{lines[-1] if lines else ''}] dead-rank lines {len(hits)}", flush=True)
        if hits:
            print(out, flush=True)
    return dead


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spawns", type=int, default=0)
    ap.add_argument("--world", type=int, default=8)
    ap.add_argument("--pytest", type=int, default=0)
    ap.add_argument("--files", nargs="*", default=SPAWNING_FILES)
    args = ap.parse_args(argv)
    dead = spawns(args.spawns, args.world) + pytest_runs(args.pytest, args.files)
    print(f"{args.spawns} spawns, {args.pytest} test runs, {dead} with a dead rank")
    return 1 if dead else 0


if __name__ == "__main__":
    raise SystemExit(main())
