"""The port's AST linter (``repro_torch.check.ast_rules``), the GF dtype
pass it shares with the lowered layer, and ``python -m repro_torch.check``.

Each rule fires on a snippet and stays quiet on its clean twin, at a path
inside the rule's scope; pragmas suppress by rule id and a pragma that no
longer suppresses anything is reported; the port's own tree lints clean;
and the CLI gates, meets its baseline and writes the report.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.check import ast_rules
from repro_torch.check.lowered import cuda
from repro_torch.check.report import FAIL, WARN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

# rule -> (path the snippet lives at, snippet that fires, its clean twin)
CASES = {
    "ast.host-sync": ("src/repro_torch/dist/x.py", """
        import torch
        def step(x):
            y = x * 2
            torch.cuda.synchronize()
            return y
        """, """
        import torch
        def step(x):
            return x * 2
        """),
    "ast.host-read": ("src/repro_torch/models/x.py", """
        def route(keep):
            return int(keep.sum())
        """, """
        def route(keep):
            return keep.sum()
        """),
    "ast.uint8-index": ("src/repro_torch/core/x.py", """
        import torch
        def lookup(table, x):
            idx = x.to(torch.uint8)
            return table[idx]
        """, """
        import torch
        def lookup(table, x):
            idx = x.to(torch.uint8)
            return table[idx.long()]
        """),
    "ast.import-time-build": ("src/repro_torch/kernels/x.py", """
        from . import build
        LIB = build.load("gf_matmul")
        """, """
        from . import build
        def lib():
            return build.load("gf_matmul")
        """),
    "ast.span-no-with": ("src/repro_torch/core/x.py", """
        from repro_torch import obs
        def f():
            obs.span("x")
        """, """
        from repro_torch import obs
        def f():
            with obs.span("x"):
                pass
        """),
    "ast.mutable-default": ("src/repro_torch/core/x.py", """
        def f(xs=[]):
            return xs
        """, """
        def f(xs=()):
            return xs
        """),
    "ast.uninstrumented-entrypoint": ("src/repro_torch/serve/x.py", """
        import numpy as np
        class Engine:
            def load(self, path):
                self.w = np.load(path)
        """, """
        import numpy as np
        from repro_torch import obs
        class Engine:
            def load(self, path):
                with obs.span("serve.load"):
                    self.w = np.load(path)
        """),
}


def _rules(src, path):
    return {f.rule for f in ast_rules.lint_source(textwrap.dedent(src), path)}


def test_every_rule_has_a_case():
    assert set(CASES) | {"ast.stale-pragma"} == set(ast_rules.ALL_LINT_RULES)


@pytest.mark.parametrize("rule", list(CASES))
def test_rule_fires_and_its_clean_twin_is_quiet(rule):
    path, bad, good = CASES[rule]
    assert rule in _rules(bad, path)
    assert _rules(good, path) == set()


@pytest.mark.parametrize("rule,exempt", [
    ("ast.host-sync", "src/repro_torch/kernels/gf_ablation.py"),
    ("ast.host-sync", "src/repro_torch/examples/x.py"),
    ("ast.host-sync", "chip_smoke.py"),
    ("ast.host-read", "src/repro_torch/train/checkpoint.py"),
    ("ast.uninstrumented-entrypoint", "src/repro_torch/launch/train.py"),
])
def test_rule_scope_leaves_out_the_exempt_paths(rule, exempt):
    _, bad, _ = CASES[rule]
    assert rule not in _rules(bad, exempt)


@pytest.mark.parametrize("snippet", [
    "import triton\n",
    "from triton import language as tl\n",
    "try:\n    import triton.language as tl\nexcept ImportError:\n    tl = None\n",
    "from repro_torch.kernels import build\nbuild.build_all()\n",
])
def test_import_time_build_catches_every_spelling(snippet):
    assert "ast.import-time-build" in _rules(snippet, "src/repro_torch/kernels/x.py")


def test_a_lazy_triton_import_is_fine():
    src = "def launch():\n    import triton\n    return triton\n"
    assert _rules(src, "src/repro_torch/kernels/x.py") == set()


@pytest.mark.parametrize("snippet", [
    "def f(x):\n    return x.item()\n",
    "def f(x):\n    return x.tolist()\n",
    "def f(x):\n    return x.cpu()\n",
    "def f(x):\n    return x.numpy()\n",
    "import torch\ndef f(a, b):\n    return torch.equal(a, b)\n",
    "def f(x):\n    return float(x.max() - x.min())\n",
])
def test_host_read_catches_every_spelling(snippet):
    assert _rules(snippet, "src/repro_torch/kernels/ops.py") == {"ast.host-read"}


@pytest.mark.parametrize("snippet", [
    # guarded: the function raises unless x is uint8
    "import torch\ndef f(t, x):\n    if x.dtype != torch.uint8:\n        raise TypeError\n"
    "    return t[:, x[0]]\n",
    "import torch\ndef f(t, n):\n    i = torch.arange(n, dtype=torch.uint8)\n    return t[i]\n",
    "def f(t, x):\n    return t[x.byte()]\n",
])
def test_uint8_index_catches_every_source_of_uint8(snippet):
    assert "ast.uint8-index" in _rules(snippet, "src/repro_torch/core/x.py")


def test_a_numpy_uint8_index_is_fine():
    src = "import numpy as np\ndef f(t, a):\n    a = np.asarray(a, dtype=np.uint8)\n    return t[a]\n"
    assert _rules(src, "src/repro_torch/core/gf.py") == set()


def test_host_sync_on_an_event_and_a_stream():
    src = "def f(end, s):\n    end.synchronize()\n    s.synchronize()\n"
    found = ast_rules.lint_source(src, "src/repro_torch/dist/x.py")
    assert [f.rule for f in found] == ["ast.host-sync"] * 2


def test_pragma_suppresses_by_rule_and_stale_pragmas_warn():
    path, bad, _ = CASES["ast.host-sync"]
    src = textwrap.dedent(bad).replace(
        "torch.cuda.synchronize()", "torch.cuda.synchronize()  # check: ignore[host-sync] timing")
    assert _rules(src, path) == set()
    other = src.replace("ignore[host-sync]", "ignore[host-read]")
    assert _rules(other, path) == {"ast.host-sync", "ast.stale-pragma"}
    stale = "def f():\n    return 1  # check: ignore[host-sync]\n"
    found = ast_rules.lint_source(stale, path)
    assert [(f.rule, f.severity) for f in found] == [("ast.stale-pragma", WARN)]
    blanket = "def f():\n    return 1  # check: ignore\n"
    assert _rules(blanket, path) == {"ast.stale-pragma"}


def test_pragma_in_a_docstring_is_inert():
    src = '"""Suppress with # check: ignore[host-sync]."""\n'
    assert ast_rules.lint_source(src, "src/repro_torch/x.py") == []


def test_port_tree_and_smoke_script_lint_clean():
    records = ast_rules.lint_tree(os.path.join(SRC, "repro_torch"))
    records += ast_rules.lint_paths([os.path.join(REPO, "chip_smoke.py")])
    assert len(records) > 90
    fails = [f.message for r in records for f in r.findings if f.severity == FAIL]
    assert fails == []


# --------------------------------------------------------- GF dtype pass
@pytest.mark.parametrize("snippet,hazard", [
    ("import torch\ndef f(x):\n    y = x.to(torch.uint8)\n    return y + 1\n", "wrap"),
    ("import torch\ndef f(n):\n    out = torch.zeros(n, dtype=torch.uint8)\n    out += 3\n"
     "    return out\n", "wrap"),
    ("import torch\ndef f(x):\n    if x.dtype != torch.uint8:\n        raise TypeError\n"
     "    out = torch.zeros_like(x.select(0, 0))\n    for t in x.unbind(0):\n"
     "        out -= t\n    return out\n", "wrap"),
    ("import torch\ndef f(m, x):\n    m = m.to(torch.uint8)\n    return m @ x\n", "matmul"),
    ("import torch\ndef f(m, x):\n    m = m.byte()\n    return torch.matmul(m, x)\n", "matmul"),
    ("import torch\ndef f(t, x):\n    assert x.dtype == torch.uint8\n    return t[x]\n", "index"),
])
def test_gf_dtype_pass_flags_each_hazard(snippet, hazard):
    found = cuda.check_gf_dtype("x.py", snippet)
    assert [f.witness["hazard"] for f in found] == [hazard]
    assert all(f.rule == "lowered.cuda.gf-dtype" and f.severity == FAIL for f in found)


@pytest.mark.parametrize("snippet", [
    "import torch\ndef f(x):\n    y = x.to(torch.uint8)\n    return y ^ 1\n",
    "import torch\ndef f(x):\n    y = x.to(torch.uint8)\n    return y.long() + 1\n",
    "import torch\ndef f(x):\n    y = x.to(torch.uint8).to(torch.int32)\n    return y * 3\n",
    "import torch\ndef f(t, x):\n    if x.dtype != torch.uint8:\n        raise TypeError\n"
    "    return t[:, x[0].long()]\n",
])
def test_gf_dtype_pass_is_quiet_on_clean_twins(snippet):
    assert cuda.check_gf_dtype("x.py", snippet) == []


# ------------------------------------------------------------------ CLI
def _cli(*args):
    env = {**os.environ, "PYTHONPATH": SRC}
    return subprocess.run([sys.executable, "-m", "repro_torch.check", *args],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=300)


def test_cli_gates_meets_its_baseline_and_writes_the_report(tmp_path):
    out = tmp_path / "report.json"
    proc = _cli("--baseline", "src/repro_torch/check/lowered_baseline.json",
                "--json", str(out))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "baseline OK" in proc.stdout
    report = json.loads(out.read_text())
    assert report["version"] == 3 and report["generated_by"] == "repro_torch.check"
    assert len(report["plan_records"]) == 144
    families = [r["family"] for r in report["lowered_records"]]
    assert families.count("spmd-schedule") == 46 and families.count("shard-rules") == 50
    assert families.count("cuda-kernel") >= 12
    assert report["summary"]["FAIL"] == 0
    assert [r["status"] for r in report["traced_records"]] == ["PASS"] * 15
    assert any(r["path"].endswith("chip_smoke.py") for r in report["lint_records"])


def test_cli_self_test_passes():
    proc = _cli("--self-test")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "self-test OK: 30/30" in proc.stdout


def test_baseline_regression_fails(tmp_path, capsys):
    from repro_torch.check.__main__ import check_baseline
    from repro_torch.check.report import CheckReport, LoweredRecord

    floor = tmp_path / "floor.json"
    floor.write_text(json.dumps({"min_lowered_records": 2}))
    report = CheckReport(lowered_records=[LoweredRecord("x", "cuda-kernel", "x")])
    assert check_baseline(report, floor) == 1
    assert "BASELINE REGRESSION" in capsys.readouterr().out
    report.lowered_records *= 2
    assert check_baseline(report, floor) == 0
