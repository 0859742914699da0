"""The paper's two repair demos in the port, on the CPU, against the
reference's: ``repro_torch.examples.quickstart`` prints what
``examples/quickstart.py`` prints, and ``repro_torch.examples.repair_layering``
prints what ``examples/repair_layering_demo.py`` prints (but for the tracer's
package name and the trace's path), traces the same ``repair.*`` and
``sim.*`` counters, equal to the plans' ``traffic_blocks() * alpha * sub``, and
writes the same stage-span schema."""
import importlib.util
import json
import os
import sys

import pytest
import torch

from repro_torch import obs
from repro_torch.core.codes import make_code
from repro_torch.examples import quickstart, repair_layering

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_demo(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quickstart_prints_what_the_reference_prints(capsys):
    _reference_demo("quickstart").main()
    want = capsys.readouterr().out
    got = quickstart.main(["--device", "cpu"])
    assert capsys.readouterr().out == want
    plan = make_code("DRC", 9, 6, 3).repair_plan(0)
    assert got["traffic"]["cross_rack_blocks"] == plan.traffic_blocks()["cross_rack_blocks"] == 2.0
    assert got["cross_rack"] == pytest.approx({"DRC(9,6,3)": 2.0, "RS(9,6,3)": 4.0,
                                               "MSR(9,6,3)": 2.0})
    assert got["restore_mode"] == "repair" and got["restore_cross_rack"] == 2.0


def _counters(path):
    return json.load(open(path))["counters"]


def test_repair_layering_matches_the_reference_demo(tmp_path, capsys, monkeypatch):
    ref_trace, port_trace = str(tmp_path / "ref.json"), str(tmp_path / "port.json")
    monkeypatch.setattr(sys, "argv", ["repair_layering_demo.py", "--trace-out", ref_trace])
    _reference_demo("repair_layering_demo").main()
    want = capsys.readouterr().out.splitlines()
    got = repair_layering.main(["--device", "cpu", "--trace-out", port_trace])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(want)
    for a, b in zip(lines, want):
        assert a == b.replace("(repro.obs)", "(repro_torch.obs)").replace(ref_trace, port_trace)
    # the summaries: the port's counters are the reference's, plus the GF
    # entry point's own (kernel.gf_matmul.*, which the reference's numpy
    # executor does not record) and the plans built (repair.plan.builds)
    ref_c, port_c = _counters(ref_trace.replace(".json", ".summary.json")), \
        _counters(got["summary"])
    assert {k: v for k, v in port_c.items()
            if not k.startswith(("kernel.", "repair.plan."))} == ref_c
    assert set(port_c["repair.plan.builds"]) == {"family=DRC", "family=RS"}
    assert set(port_c["kernel.gf_matmul.calls"]) == {"path=ref"}  # the CPU's plain product
    total_cross = 0
    for fam, n, k, r in repair_layering.TRACED_CODES:
        code = make_code(fam, n, k, r)
        t = code.repair_plan(0).traffic_blocks()
        row = got["codes"][str(code)]
        for scope in ("inner", "cross"):
            want_bytes = t[f"{scope}_rack_blocks"] * code.alpha * repair_layering.SUB_BYTES
            assert row[f"{scope}_rack_bytes"] == pytest.approx(want_bytes, abs=0.5)
        total_cross += row["cross_rack_bytes"]
    assert sum(port_c["repair.bytes.cross_rack"].values()) == pytest.approx(total_cross, abs=0.5)
    events = json.load(open(port_trace))["traceEvents"]
    stages = {e["name"] for e in events if e.get("ph") == "X" and e.get("cat") == "stage"}
    assert stages == set(obs.STAGE_NAMES)
    assert got["motivating"] == pytest.approx({"MSR(6,3,6)": 5 / 3, "MSR(6,3,3)": 4 / 3,
                                                "DRC(6,3,3)": 1.0})


@pytest.mark.parametrize("demo", [quickstart, repair_layering],
                         ids=["quickstart", "repair_layering"])
def test_demos_run_on_the_card_by_default(demo, tmp_path, monkeypatch):
    """No device named: the card, and no fall back to the CPU without one."""
    monkeypatch.chdir(tmp_path)  # the layering demo's default trace file
    if torch.cuda.is_available():
        assert demo.main([])["device"] == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            demo.main([])
