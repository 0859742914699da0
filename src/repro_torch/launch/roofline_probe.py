"""Probe-and-extrapolate roofline of a full-depth cell: the counterpart of
``repro.launch.roofline_probe``.

The dry run (``launch.dryrun``) counts every op a step runs, so its counts
of a full-depth step are exact; but a fake step of 40–64 layers at full
width costs minutes of host time.  A step's counts are affine in the depth
of each layer stack, so a few shallow fake steps give the full-depth counts
exactly:

* a uniform stack (dense, MoE, vlm): depths 1 and 2,
  ``cost(L) = (2 - L)·A + (L - 1)·B``;
* zamba2's two block kinds: ``P(u)``, u Mamba2 layers and one call of the
  shared block (``shared_attn_every=0``), at u = 1, 2, and ``Q(2)``, two
  layers each followed by the shared block (``shared_attn_every=1``):
  ``cost = (2 - n)·P(1) + (n - s)·P(2) + (s - 1)·Q(2)`` for n layers and s
  calls of the shared block;
* whisper's encoder and decoder: ``(E, D)`` at (1, 1), (2, 1), (1, 2):
  ``cost = (3 - E - D)·A + (E - 1)·B + (D - 1)·C``;
* xlstm, whose mLSTM and sLSTM blocks alternate by index: the full step.

Each probe runs at the cell's own microbatch count.  The reference also
probes two microbatch counts and carries the counts to the cell's along a
line, because XLA counts a loop body once whatever its trip count; here
every microbatch is counted, and the counts are not affine in the microbatch
count: DTensor picks its redistributions by the tensors' sizes, so the plan
changes as a microbatch shrinks (StarCoder2-3B smoke under fsdp on a (2, 4)
mesh, 64 rows: 1.7 kB more all-reduce from 2 to 4 microbatches, 6.3 MB
more from 4 to 8).  Applied alike to the FLOPs, the HBM bytes and each
collective kind's bytes; the roofline terms then use the H100 data sheet's
rates (``launch.mesh``).

  PYTHONPATH=src python -m repro_torch.launch.roofline_probe --arch starcoder2-3b \\
      --shape train_4k --mesh multi --out artifacts_torch/roofline
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from fractions import Fraction

from repro_torch.configs import ARCHS, applicable_shapes, get_config
from repro_torch.dist.model_run import KINDS
from repro_torch.launch import dryrun
from repro_torch.launch.orchestrate_dryrun import OVERRIDES, cell_rules
from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig


def _vector(meter) -> dict[str, int]:
    vec = {"flops": meter.flops, "bytes": meter.hbm_bytes}
    for kind in KINDS:
        vec[f"coll_{kind}"] = meter.coll_bytes.get(kind, 0)
    return vec


def probe_cost(cfg: ArchConfig, shape: ShapeConfig, rules_mode: str, mb: int, *,
               multi_pod: bool, device: str, mesh_shape: tuple | None = None) -> dict:
    """The counts of one fake step of ``cfg`` (a dry run's)."""
    tcfg = dryrun.train_config(cfg, microbatches=mb)
    got = dryrun.measure_cell(cfg, shape, multi_pod=multi_pod, rules_mode=rules_mode,
                              tcfg=tcfg, device=device, mesh_shape=mesh_shape)
    return _vector(got["meter"])


def _weighted(terms: list[tuple[Fraction, dict]]) -> dict:
    out: dict = {}
    for w, vec in terms:
        for key, val in vec.items():
            out[key] = out.get(key, 0) + w * val
    return out


def probe_plan(cfg: ArchConfig) -> list[tuple[Fraction, ArchConfig]]:
    """The probe configs and the weights that sum their counts to the full
    depth's (see the module docstring)."""
    rep = dataclasses.replace
    if cfg.family == "ssm":
        return [(Fraction(1), cfg)]
    if cfg.family == "hybrid":
        n = cfg.n_layers
        s = n // (cfg.shared_attn_every or n)
        pure = lambda u: rep(cfg, n_layers=u, shared_attn_every=0)  # noqa: E731
        return [(Fraction(2 - n), pure(1)), (Fraction(n - s), pure(2)),
                (Fraction(s - 1), rep(cfg, n_layers=2, shared_attn_every=1))]
    if cfg.family == "audio":
        e, d = cfg.encoder_layers, cfg.n_layers
        at = lambda ee, dd: rep(cfg, encoder_layers=ee, n_layers=dd)  # noqa: E731
        return [(Fraction(3 - e - d), at(1, 1)), (Fraction(e - 1), at(2, 1)),
                (Fraction(d - 1), at(1, 2))]
    n = cfg.n_layers
    return [(Fraction(2 - n), rep(cfg, n_layers=1)), (Fraction(n - 1), rep(cfg, n_layers=2))]


def true_costs(arch: str, shape_name: str, rules_mode: str, mb: int, *, multi_pod: bool = False,
               device: str = "cuda", config: ArchConfig | None = None,
               shape: ShapeConfig | None = None, mesh_shape: tuple | None = None) -> dict:
    """The full-depth step's counts from shallow probes at ``mb``
    microbatches: ``flops``, ``bytes`` and ``coll_<kind>``, integers where
    the weights give them."""
    cfg = config or get_config(arch)
    shape = shape or SHAPES[shape_name]
    out = _weighted([(w, probe_cost(probe, shape, rules_mode, mb, multi_pod=multi_pod,
                                    device=device, mesh_shape=mesh_shape))
                     for w, probe in probe_plan(cfg) if w])
    return {key: int(val) if val.denominator == 1 else float(val) for key, val in out.items()}


def roofline_terms(cfg: ArchConfig, shape: ShapeConfig, costs: dict, n_devices: int) -> dict:
    """The reference's roofline fields from the counts.  The counts are
    exact at the cell's microbatch count, so no collective needs the
    reference's split into weight-shaped ones (``weight_collective_bytes``
    is None)."""
    coll = sum(v for k, v in costs.items() if k.startswith("coll_"))
    model = dryrun.model_flops_global(cfg, shape, shape.kind) / n_devices
    roof = dryrun.roofline(float(costs["flops"]), float(costs["bytes"]), float(coll), model)
    roof["collective_by_op"] = {k[5:]: v for k, v in costs.items() if k.startswith("coll_")}
    roof["weight_collective_bytes"] = None
    return roof


def cell_microbatches(arch: str, shape_name: str) -> int:
    ov = OVERRIDES.get((arch, shape_name), [])
    return int(ov[ov.index("--microbatches") + 1]) if "--microbatches" in ov else 1


def probe_cell(arch: str, shape_name: str, *, rules_mode: str | None = None,
               mb: int | None = None, multi_pod: bool = False, device: str = "cuda") -> dict:
    """One cell's artifact: the reference's fields (``status``,
    ``roofline``), the rules and microbatches the orchestrator gives it."""
    cfg = get_config(arch)
    rules_mode = rules_mode or cell_rules(arch, shape_name)
    mb = mb or cell_microbatches(arch, shape_name)
    costs = true_costs(arch, shape_name, rules_mode, mb, multi_pod=multi_pod, device=device)
    n = 512 if multi_pod else 256
    return {"arch": arch, "shape": shape_name, "mesh": "multi" if multi_pod else "single",
            "rules": rules_mode, "microbatches": mb, "status": "ok",
            "roofline": roofline_terms(cfg, SHAPES[shape_name], costs, n)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=["all"])
    ap.add_argument("--shape", nargs="+", default=list(SHAPES))
    ap.add_argument("--out", default="artifacts_torch/roofline")
    ap.add_argument("--rules", default=None)
    ap.add_argument("--mb", type=int, default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    archs = ARCHS if args.arch == ["all"] else args.arch
    os.makedirs(args.out, exist_ok=True)
    failed = 0
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in args.shape:
            if shape_name not in applicable_shapes(cfg):
                continue
            try:
                res = probe_cell(arch, shape_name, rules_mode=args.rules, mb=args.mb,
                                 multi_pod=args.mesh == "multi", device=args.device)
            except Exception as e:  # record and continue
                res = {"arch": arch, "shape": shape_name, "status": "error",
                       "error": repr(e)[:200]}
                failed += 1
            with open(os.path.join(args.out, f"{arch}__{shape_name}.json"), "w") as f:
                json.dump(res, f, indent=1)
            if res["status"] == "ok":
                r = res["roofline"]
                print(f"[probe] {arch} x {shape_name} ({res['rules']}): "
                      f"terms(c/m/x)=({r['compute_s']:.4f},{r['memory_s']:.4f},"
                      f"{r['collective_s']:.4f})s bottleneck={r['bottleneck']} "
                      f"useful={r['useful_flops_ratio']:.2f}")
            else:
                print(f"[probe] {arch} x {shape_name}: ERROR {res['error']}")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
