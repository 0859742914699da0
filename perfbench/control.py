"""The control of the comparison: a cell run with the plain reference in the
program's place, computed over GF(2^8) with the AES polynomial 0x11B instead
of the configuration's 0x11D.  The port's arithmetic is exact and states no
precision, so the control breaks a guarantee the configurations state: bytes
compatible with ISA-L's field.  Its result must come out not correct.

    python3 perfbench/control.py --workload drc_9_6_3.node_recovery \
        --seeds 11 12 13 --seconds 2 [--program]

Each seed is one run in this process; ``--program`` runs the program itself
on the same seeds too, for the readings of sound runs.  One JSON line per
run: the seed, which side ran, ``correct`` and the numbers compared.  The
benchmark's own runs never run it.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _path in (ROOT / "src", ROOT):
    if str(_path) not in sys.path:
        sys.path.insert(0, str(_path))

CONTROL_POLY = 0x11B


def control_field():
    from perfbench.reference.gf256 import field

    return field(CONTROL_POLY)


def run(workload: str, seed: int, seconds: float, *, program: bool, device: str = "cuda",
        overrides: dict | None = None, root: Path = ROOT) -> dict:
    from perfbench import harness

    t = time.perf_counter()
    result, checks, _ = harness.run_cell(
        workload, seed, seconds, False, device=device, overrides=overrides,
        control=None if program else control_field(), root=root)
    return {"workload": workload, "seed": seed, "side": "program" if program else "control",
            "correct": result["correct"], "attempted": result["attempted"],
            "seconds": time.perf_counter() - t,
            "checks": {c.name: c.as_dict() for c in checks}}


def main(argv: list[str] | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--program", action="store_true")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        for program in ([True, False] if args.program else [False]):
            print(json.dumps(run(args.workload, seed, args.seconds, program=program)),
                  flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
