"""Find a cell's parts by name: ``BENCHMARK.json`` at the checkout's root,
a configuration's file as it names it, ``mixes/<traffic>.json``,
``drivers/<entry>.py`` and ``metrics/<metric>.py`` (or its family's
``metrics/<metric up to its first dot>.py``) beside this file.

Nothing here lists them: a new configuration, mix, driver or metric is a new
file and an entry in ``BENCHMARK.json``.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str, what: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"bad {what} name {name!r}")
    return name


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, workload: str) -> dict:
    for entry in bench["workloads"]:
        if entry["name"] == workload:
            return entry
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for entry in bench["configs"]:
        if entry["name"] == name:
            return json.loads((root / entry["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def mix(name: str) -> dict:
    return json.loads((HERE / "mixes" / f"{_checked(name, 'traffic')}.json").read_text())


def driver(entry: str) -> ModuleType:
    if not entry.isidentifier():
        raise ValueError(f"bad entry name {entry!r}")
    return importlib.import_module(f"perfbench.drivers.{entry}")


def metric_reader(name: str) -> ModuleType:
    """The reader module of metric ``name``: ``metrics/<name>.py``, or else
    the family's ``metrics/<name up to its first dot>.py``, which serves
    every cell suffix of one quantity (``device_idle_pct.write``)."""
    here = HERE / "metrics"
    tried = [here / f"{_checked(name, 'metric')}.py", here / f"{name.split('.', 1)[0]}.py"]
    path = next((p for p in tried if p.exists()), None)
    if path is None:
        raise FileNotFoundError(f"no reader for metric {name!r} at {tried[0]} or {tried[1]}")
    modname = "perfbench.metrics._" + re.sub(r"\W", "_", path.stem)
    found = importlib.util.spec_from_file_location(modname, path)
    module = importlib.util.module_from_spec(found)
    found.loader.exec_module(module)
    return module


def metrics_of(bench: dict, workload: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those that
    list it under ``workloads``, and those that list no cells."""
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]
