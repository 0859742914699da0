"""Run one cell of the benchmark on the card and print its result line.

    python3 perfbench/run.py --workload drc_9_6_3.node_recovery --seed 7 \
        --seconds 10 --trace 0

Run from the root of a checkout.  ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics and the device's busy and idle
time.  The numbers compared with the reference are printed, each beside its
limit, as the last lines on standard error and under ``checks``, last in the
result line; the result line is the last line on standard output.  Without
as many CUDA cards as the cell asks for, or with JAX or the JAX package
loaded once the window has closed, the run prints no result and exits with a
code other than 0.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _path in (ROOT / "src", ROOT):
    if str(_path) not in sys.path:
        sys.path.insert(0, str(_path))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules (``sys.modules`` unless given) whose top-level name,
    before the first dot, is JAX's or the JAX package's, compared whole:
    ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({name for name in names if name.split(".", 1)[0] in FORBIDDEN})


def parse(argv: list[str] | None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse(argv)
    from perfbench import spec

    cell = spec.cell(spec.load_benchmark(ROOT), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA card(s); found {found}",
              file=sys.stderr)
        return 2
    from perfbench import harness

    result, checks, split = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START, root=ROOT)
    found = forbidden_modules()
    if found:
        print(f"perfbench: JAX or the JAX package was loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    result["card"] = card()
    result["setup_split_s"] = split
    result["checks"] = {c.name: c.as_dict() for c in checks}
    print("perfbench: set-up " + ", ".join(f"{k} {v:.3f} s" for k, v in split.items()),
          file=sys.stderr)
    for c in checks:
        print(c.line(), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def card() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


if __name__ == "__main__":
    # Python's bytecode cache, like the kernels' build, lives at a fixed
    # path in the checkout, so only a cell's first run there compiles the
    # modules it imports
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False
    sys.exit(main())
