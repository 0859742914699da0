"""The runner: it fails without a card instead of falling back to the CPU,
refuses a process that loaded JAX or the JAX package, and on a card prints
one result line that keeps to the contract."""
import json
import subprocess
import sys

import pytest
import torch

from perfbench import run, spec

ARGS = ["--workload", "drc_9_6_3.write", "--seed", str(2**31 + 3), "--seconds", "1"]


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(ARGS) != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "CUDA card" in out.err


def test_too_few_cards_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert run.main(ARGS) != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_compare_whole_top_level_names():
    assert "repro_torch" not in run.FORBIDDEN
    loaded = ["repro_torch", "repro_torch.kernels", "repro_torchlike", "reproduce", "torch",
              "repro", "repro.kernels", "jaxlib", "jax.numpy", "flax.linen", "jaxtyping"]
    assert run.forbidden_modules(loaded) == ["flax.linen", "jax.numpy", "jaxlib", "repro",
                                             "repro.kernels"]
    assert set(run.forbidden_modules()) <= set(sys.modules)


def test_unknown_workload_is_an_error():
    with pytest.raises(KeyError):
        run.main(["--workload", "nope.nope", "--seed", "1", "--seconds", "1"])


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_on_the_card(cuda_card, trace):
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", *ARGS, "--trace", str(trace)],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=600, check=True)
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(result)[-1] == "checks" and result["correct"] is True
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in spec.metrics_of(spec.load_benchmark(), "drc_9_6_3.write", kind)}
    assert set(result["metrics"]) == want
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")
