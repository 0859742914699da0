"""Run every (arch x shape x mesh) dry-run cell as a subprocess: the
counterpart of ``repro.launch.orchestrate_dryrun``.

Each cell gets its own process (its own ``fake`` process group of 256 or 512
ranks), so a pathological cell cannot poison the rest; ``--jobs`` runs that
many at once.  The per-cell ``OVERRIDES`` and ``cell_rules`` are the
reference's, unchanged.  Artifacts land in ``artifacts_torch/dryrun`` by default; never in ``artifacts/``,
which the reference's ``tests/test_artifacts.py`` reads.

  PYTHONPATH=src python -m repro_torch.launch.orchestrate_dryrun \\
      --out artifacts_torch/dryrun [--mesh single multi] [--arch ...] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from repro_torch.configs import ARCHS
from repro_torch.models.config import SHAPES

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

# per-cell overrides: sharding rules / microbatching / accumulation dtype
# (the reference's, chosen for its 16 GiB chips: fsdp for 35B+ weights,
# sequence-parallel residuals for train_4k, bf16 grad accumulation for the
# 100B+ MoEs)
BIG = ("dbrx_132b", "grok_1_314b", "command_r_35b")
OVERRIDES: dict[tuple[str, str], list[str]] = {}
for _a in BIG:
    OVERRIDES[(_a, "train_4k")] = [
        "--rules", "fsdp_sp", "--microbatches", "8", "--accum-dtype", "bfloat16",
    ]
    OVERRIDES[(_a, "prefill_32k")] = ["--rules", "fsdp_sp"]
    OVERRIDES[(_a, "decode_32k")] = ["--rules", "fsdp"]
# FSDP weight gathers recur per microbatch; command-r fits at mb=2
OVERRIDES[("command_r_35b", "train_4k")] = [
    "--rules", "fsdp_sp", "--microbatches", "2", "--accum-dtype", "bfloat16",
]
# MoE decode serves from resident 2-D-sharded expert weights
OVERRIDES[("dbrx_132b", "decode_32k")] = ["--rules", "tp2d"]
OVERRIDES[("grok_1_314b", "decode_32k")] = ["--rules", "tp2d"]
OVERRIDES[("zamba2_1p2b", "train_4k")] = ["--rules", "tp_sp", "--microbatches", "2"]


def cell_rules(arch: str, shape: str) -> str:
    ov = OVERRIDES.get((arch, shape))
    if ov:
        return ov[ov.index("--rules") + 1]
    return "tp_sp" if shape == "train_4k" else "tp"


def cell_cmd(arch: str, shape: str, mesh: str, out: str, device: str = "cuda") -> list[str]:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh, "--out", out, "--device", device]
    cmd += OVERRIDES.get(
        (arch, shape), ["--rules", "tp_sp" if shape == "train_4k" else "tp"]
    )
    return cmd


def _run(arch: str, shape: str, mesh: str, args) -> dict:
    """One cell in its own process; its output and errors kept on failure."""
    tag = f"{arch}__{shape}__{mesh}"
    t0 = time.time()
    try:
        proc = subprocess.run(
            cell_cmd(arch, shape, mesh, args.out, args.device),
            capture_output=True, text=True, timeout=args.timeout,
            env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}, cwd=REPO)
        ok, out, err = proc.returncode == 0, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as e:
        ok, out, err = False, str(e.stdout or ""), f"timed out after {args.timeout} s"
    dt = time.time() - t0
    lines = out.strip().splitlines()
    summary = lines[0] if lines else err.strip().splitlines()[-1:]
    print(f"[{'ok' if ok else 'FAIL'}] {tag} ({dt:.0f}s) {summary}", flush=True)
    if not ok:
        with open(os.path.join(args.out, f"{tag}.err"), "w") as f:
            f.write(out + "\n---\n" + err)
    return {"tag": tag, "ok": ok, "seconds": round(dt, 1)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="artifacts_torch/dryrun")
    ap.add_argument("--mesh", nargs="+", default=["single", "multi"])
    ap.add_argument("--arch", nargs="+", default=ARCHS)
    ap.add_argument("--shape", nargs="+", default=list(SHAPES))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--jobs", type=int, default=1, help="cells run at once")
    args = ap.parse_args(argv)
    if os.path.normpath(args.out).split(os.sep)[0] == "artifacts":
        raise SystemExit("artifacts/ holds the reference's dry run: write elsewhere")
    os.makedirs(args.out, exist_ok=True)

    cells = []
    for arch in args.arch:
        for shape in args.shape:
            for mesh in args.mesh:
                rules = cell_rules(arch, shape)
                path = os.path.join(args.out, f"{arch}__{shape}__{mesh}__{rules}.json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip] {arch}__{shape}__{mesh} (exists)")
                    continue
                cells.append((arch, shape, mesh))
    with ThreadPoolExecutor(max_workers=args.jobs) as pool:
        results = list(pool.map(lambda cell: _run(*cell, args), cells))
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(results, f, indent=1)
    fails = [r for r in results if not r["ok"]]
    print(f"\n{len(results) - len(fails)}/{len(results)} cells ok")
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
