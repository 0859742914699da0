"""Find the highest rate an open-loop cell sustains: one set-up, then a short
open loop at each rate, printing each rate's latency percentiles, generator
lag and how far the last reads finished behind their due times.

    python3 perfbench/sweep.py --workload drc_9_6_3.degraded_read --seed 5 \
        --seconds 3 --rates 400 600 800 1000 1200

A rate is sustained while the p95 stays near the service time and the
backlog at the close does not grow with the window.  The cell's mix then
fixes a rate at about four fifths of the highest sustained one.
"""
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _path in (ROOT / "src", ROOT):
    if str(_path) not in sys.path:
        sys.path.insert(0, str(_path))


def _pct(values: list[float], q: float) -> float:
    values = sorted(values)
    return values[math.ceil(q * len(values)) - 1]


def main(argv: list[str] | None = None) -> int:
    import argparse

    import torch

    from perfbench import harness, spec, traffic

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA card", file=sys.stderr)
        return 2
    bench = spec.load_benchmark(ROOT)
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(bench, cell["config"], ROOT)
    mix = dict(spec.mix(cell["traffic"]))
    dev = torch.device("cuda")
    drv = spec.driver(mix["entry"]).Driver(cfg, mix, args.seed, dev)
    drv.warm(traffic.all_ops(cfg, mix, args.seed))
    drv.arm()
    torch.cuda.synchronize()
    for rate in args.rates:
        mix["rate_per_s"] = rate
        stream = harness._Peek(traffic.schedule(cfg, mix, args.seed))
        stats = harness.open_loop(drv, stream, args.seconds, dev)
        lat = [x for x in stats.latency_s if math.isfinite(x)]
        print(json.dumps({
            "rate_per_s": rate, "reads": stats.attempted, "failed": stats.failed,
            "p50_ms": _pct(lat, 0.50) * 1e3, "p95_ms": _pct(lat, 0.95) * 1e3,
            "p99_ms": _pct(lat, 0.99) * 1e3, "last_ms": lat[-1] * 1e3 if lat else None,
            "lag_p95_ms": _pct(stats.lag_s, 0.95) * 1e3,
            "host_ms": sum(stats.host_s) / len(stats.host_s) * 1e3,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
