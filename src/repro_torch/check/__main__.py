"""CLI of ``repro_torch.check``: plan sweep + lowered + traced analysis + lint.

Usage (from the repo root, with ``src`` on ``PYTHONPATH``)::

    python -m repro_torch.check                  # full gate: all four layers
    python -m repro_torch.check --json out.json  # also write the report
    python -m repro_torch.check --plans-only
    python -m repro_torch.check --lowered-only   # SPMD/shard/CUDA analyzers
    python -m repro_torch.check --traced-only    # dispatch traces of the entry points
    python -m repro_torch.check --ast-only
    python -m repro_torch.check --strict-warnings  # WARNs also exit nonzero
    python -m repro_torch.check --baseline src/repro_torch/check/lowered_baseline.json
    python -m repro_torch.check --traced-only --baseline src/repro_torch/check/traced_baseline.json
    python -m repro_torch.check --self-test      # mutation test: corrupted
                                                 # artifacts must FAIL with
                                                 # the owning rule id

Exit code 0 iff nothing FAILed; with ``--strict-warnings`` a WARN-only
run exits 1 too.  ``--baseline`` fails the run if a sweep it names
(``min_lowered_records``, ``min_traced_records``) produced fewer records than
the committed floor (a shrinking sweep means a code shape, model config,
kernel launch or entry point silently fell out of coverage).  The lint covers
``src/repro_torch`` and ``chip_smoke.py``.  The port's counterpart of the
reference's ``tools/run_check.py``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from .ast_rules import lint_paths, lint_tree
from .lowered import run_lowered_sweep, self_test_lowered
from .plan import self_test, sweep_report
from .report import FAIL, WARN, CheckReport
from .traced import run_traced_sweep, self_test_traced

PACKAGE = Path(__file__).resolve().parents[1]  # src/repro_torch
REPO_ROOT = PACKAGE.parents[1]
BASELINE = Path(__file__).resolve().parent / "lowered_baseline.json"
TRACED_BASELINE = Path(__file__).resolve().parent / "traced_baseline.json"


def _worst(statuses: list[str]) -> str:
    return FAIL if FAIL in statuses else (WARN if WARN in statuses else "PASS")


def summary(report: CheckReport) -> dict[str, dict[str, int]]:
    """Record counts by layer and family (plans, lowered) or kind (traced)
    and status, e.g. ``{"plan DRC-f1": {"PASS": 35}, ...}``."""
    out: dict[str, dict[str, int]] = {}
    for prefix, recs in (("plan", report.plan_records),
                         ("lowered", report.lowered_records)):
        for rec in recs:
            row = out.setdefault(f"{prefix} {rec.family}", {})
            row[rec.status] = row.get(rec.status, 0) + 1
    for rec in report.traced_records:
        row = out.setdefault(f"traced {rec.kind}", {})
        row[rec.status] = row.get(rec.status, 0) + 1
    for rec in report.lint_records:
        row = out.setdefault("lint", {})
        row[rec.status] = row.get(rec.status, 0) + 1
    return out


def _print_plan_summary(report: CheckReport) -> None:
    by_label: dict[str, list[str]] = {}
    for rec in report.plan_records:
        by_label.setdefault(f"{rec.family:<10} {rec.label}", []).append(rec.status)
    print(f"{'family':<10} {'code':<14} {'plans':>5}  status")
    for label, statuses in sorted(by_label.items()):
        print(f"{label:<25} {len(statuses):>5}  {_worst(statuses)}")


def _print_lowered_summary(report: CheckReport) -> None:
    by_family: dict[str, list[str]] = {}
    for rec in report.lowered_records:
        by_family.setdefault(rec.family, []).append(rec.status)
    print(f"{'lowered family':<16} {'records':>7}  status")
    for family, statuses in sorted(by_family.items()):
        print(f"{family:<16} {len(statuses):>7}  {_worst(statuses)}")


def _print_traced_summary(report: CheckReport) -> None:
    by_kind: dict[str, list[str]] = {}
    for rec in report.traced_records:
        by_kind.setdefault(rec.kind, []).append(rec.status)
    print(f"{'traced kind':<16} {'records':>7}  status")
    for kind, statuses in sorted(by_kind.items()):
        print(f"{kind:<16} {len(statuses):>7}  {_worst(statuses)}")


def _print_failures(report: CheckReport) -> None:
    for rec in (*report.plan_records, *report.lowered_records, *report.traced_records,
                *report.lint_records):
        for f in rec.findings:
            if f.severity in (FAIL, WARN):
                where = getattr(rec, "label", None) or getattr(rec, "path", "")
                failed = getattr(rec, "failed", None)
                loc = f"{where}" + (f" failed={failed}" if failed is not None else "")
                print(f"  {f.severity} {f.rule} [{loc}] {f.message}")


def run_self_test() -> int:
    print("mutation self-test: corrupted plans must FAIL with the owning rule")
    results, lowered, traced = self_test(), self_test_lowered(), self_test_traced()
    ok = True
    for mutation, owner, caught in results:
        print(f"  {mutation:<26} -> {owner:<36} {'caught' if caught else 'MISSED'}")
        ok &= caught
    for layer, rows in (("lowered", lowered), ("traced", traced)):
        print(f"{layer} self-test: corrupted {layer} artifacts must FAIL with "
              "exactly the owning rule")
        for mutation, owner, caught, exclusive in rows:
            mark = "MISSED" if not caught else ("NOT-EXCLUSIVE" if not exclusive else "caught")
            print(f"  {mutation:<26} -> {owner:<36} {mark}")
            ok &= caught and exclusive
    total = len(results) + len(lowered) + len(traced)
    if not ok:
        print("SELF-TEST FAILED: a deliberate defect went undetected "
              "(or was caught by the wrong rule)")
        return 1
    print(f"self-test OK: {total}/{total} mutations caught "
          f"({len(lowered)} lowered-layer and {len(traced)} traced-layer, each by exactly "
          f"its owner)")
    return 0


def check_baseline(report: CheckReport, path: str | Path,
                   layers: tuple[str, ...] = ("lowered", "traced")) -> int:
    """0 iff every sweep of ``layers`` (``lowered``, ``traced``) that the
    file sets a floor for is at least that wide."""
    with open(path) as f:
        floors = json.load(f)
    rc = 0
    for layer in layers:
        key = f"min_{layer}_records"
        if key not in floors:
            continue
        floor = int(floors[key])
        got = len(getattr(report, f"{layer}_records"))
        if got < floor:
            print(f"BASELINE REGRESSION: {layer} sweep produced {got} record(s), "
                  f"committed floor is {floor} ({path}) — coverage silently shrank")
            rc = 1
        else:
            print(f"baseline OK: {got} {layer} record(s) >= floor {floor}")
    return rc


def lint_targets(root: Path = REPO_ROOT) -> list:
    """Lint records of the port's tree and the smoke run."""
    records = lint_tree(root / "src" / "repro_torch")
    smoke = root / "chip_smoke.py"
    return records + (lint_paths([smoke]) if smoke.exists() else [])


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.check",
        description="Static verification of the port: plan sweep + lowered-layer "
                    "and traced-layer analysis + AST lint.",
    )
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the machine-readable report here")
    ap.add_argument("--plans-only", action="store_true", help="run only the plan sweep")
    ap.add_argument("--lowered-only", action="store_true",
                    help="run only the lowered-layer analyzers")
    ap.add_argument("--traced-only", action="store_true",
                    help="run only the traced-layer analyzers")
    ap.add_argument("--ast-only", action="store_true", help="run only the AST lint")
    ap.add_argument("--strict-warnings", action="store_true",
                    help="exit nonzero when any record WARNs, not just FAILs")
    ap.add_argument("--baseline", metavar="PATH", default=None,
                    help="JSON file with min_lowered_records and/or min_traced_records; "
                         "fail if a sweep that ran shrinks below its floor (the port's: "
                         f"{BASELINE.name} and {TRACED_BASELINE.name} beside this module)")
    ap.add_argument("--self-test", action="store_true",
                    help="run the mutation self-tests and exit")
    args = ap.parse_args(argv)

    if args.self_test:
        return run_self_test()
    only = [args.plans_only, args.lowered_only, args.traced_only, args.ast_only]
    if sum(only) > 1:
        ap.error("--plans-only/--lowered-only/--traced-only/--ast-only are exclusive")
    run_all = not any(only)

    report = CheckReport()
    if run_all or args.plans_only:
        print("plan verifier: registry sweep (all families x shapes x failed nodes)")
        report.plan_records = sweep_report().plan_records
        _print_plan_summary(report)
    if run_all or args.lowered_only:
        print("lowered-layer analysis: SPMD schedules, sharding rules, CUDA kernel "
              "launch geometry, GF dtype safety")
        report.lowered_records = run_lowered_sweep()
        _print_lowered_summary(report)
    if run_all or args.traced_only:
        print("traced-layer analysis: dispatch traces of the repair, GF, serve, train and "
              "checkpoint entry points")
        report.traced_records = run_traced_sweep()
        _print_traced_summary(report)
    if run_all or args.ast_only:
        print(f"AST lint: {PACKAGE} and chip_smoke.py")
        report.lint_records = lint_targets()
        flagged = sum(len(r.findings) for r in report.lint_records)
        print(f"  {len(report.lint_records)} files, {flagged} finding(s)")

    counts = report.counts()
    print(f"records: {counts['PASS']} PASS / {counts['WARN']} WARN / {counts['FAIL']} FAIL")
    _print_failures(report)
    if args.json:
        report.write_json(args.json)
        print(f"report -> {args.json}")
    rc = 0 if report.ok else 1
    if args.baseline:
        layers = tuple(layer for layer, ran in (("lowered", run_all or args.lowered_only),
                                                ("traced", run_all or args.traced_only))
                       if ran)
        rc = max(rc, check_baseline(report, args.baseline, layers))
    if rc == 0 and args.strict_warnings and counts[WARN] > 0:
        print(f"--strict-warnings: {counts[WARN]} WARN record(s) gate the run")
        rc = 1
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
