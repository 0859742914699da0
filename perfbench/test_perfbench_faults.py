"""A run with the timed path broken underneath must come out not correct:
the harness's look for a card is skipped (the CPU runs the program's plain
version) and each fault a cell can have is planted in the program by a
patch, once: a step that returns its state unchanged, half of the batch left
out, the exchange between racks left out, an answer altered where it is
produced.  Each unbroken cell must come out correct."""
import dataclasses

import numpy as np
import pytest
import torch

from perfbench import harness, spec

SEED = 2**31 + 101
CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def _run(cell, small):
    result, checks, _ = harness.run_cell(cell, SEED, 0.3, False, device="cpu", overrides=small)
    return result, {c.name: c for c in checks}


@pytest.mark.parametrize("cell", CELLS)
def test_unbroken_cell_is_correct(cell, small):
    result, checks = _run(cell, small)
    assert result["correct"], [c.line() for c in checks.values() if not c.ok]
    assert result["attempted"] > 0 and result["failed"] == 0


def _wrap_recovery(monkeypatch, after):
    from repro_torch.dist import collectives

    real = collectives.spmd_node_recovery

    def broken(code, failed, payloads, mesh=None):
        out, specs = real(code, failed, payloads, mesh)
        return after(out, payloads), specs

    monkeypatch.setattr(collectives, "spmd_node_recovery", broken)


def _wrap_read(monkeypatch, after):
    from repro_torch.core.repair import RepairPlan

    real = RepairPlan.execute
    monkeypatch.setattr(RepairPlan, "execute",
                        lambda self, payloads: after(real(self, payloads), payloads))


def _wrap_encode(monkeypatch, after):
    from repro_torch.train import checkpoint

    real = checkpoint.make_encode_step

    def make(code, sub, device="cuda"):
        step = real(code, sub, device)
        return lambda coded: after(step, coded, code.k * code.alpha)

    monkeypatch.setattr(checkpoint, "make_encode_step", make)


def _encode_half(step, coded, ka):
    """Only the first half of the parity rows is written."""
    half = ka + (coded.shape[0] - ka) // 2
    coded[ka:half] = step(coded.clone())[ka:half]
    return coded


def _encode_flipped(step, coded, ka):
    step(coded)
    coded[ka].view(-1)[coded.shape[1] // 2] ^= 0x40
    return coded


def _half(t):
    t = t.clone()
    t.view(-1)[t.numel() // 2:] = 0
    return t


def _flip(t):
    t = t.clone()
    t.view(-1)[t.numel() // 3] ^= 0x40
    return t


FAULTS = {
    "drc_9_6_3.node_recovery": {
        "state_unchanged": lambda mp: _wrap_recovery(mp, lambda out, x: x.clone()),
        "half_batch": lambda mp: _wrap_recovery(mp, lambda out, x: _half(out)),
        "answer_altered": lambda mp: _wrap_recovery(mp, lambda out, x: _flip(out)),
    },
    "rs_9_6_3.node_recovery": {
        "state_unchanged": lambda mp: _wrap_recovery(mp, lambda out, x: torch.zeros_like(out)),
        "half_batch": lambda mp: _wrap_recovery(mp, lambda out, x: _half(out)),
        "answer_altered": lambda mp: _wrap_recovery(mp, lambda out, x: _flip(out)),
    },
    "drc_9_6_3.write": {
        "state_unchanged": lambda mp: _wrap_encode(mp, lambda step, coded, ka: coded),
        "half_batch": lambda mp: _wrap_encode(mp, _encode_half),
        "answer_altered": lambda mp: _wrap_encode(mp, _encode_flipped),
    },
    "drc_9_6_3.degraded_read": {
        "state_unchanged": lambda mp: _wrap_read(mp, lambda out, x: x[min(x)].clone()),
        "half_batch": lambda mp: _wrap_read(mp, lambda out, x: _half(out)),
        "answer_altered": lambda mp: _wrap_read(mp, lambda out, x: _flip(out)),
    },
}


def _drop_exchange_spmd(monkeypatch):
    """The cross-rack ship of the emulated mesh delivers nothing: the
    collector decodes zeros in place of every unit it gathers."""
    from repro_torch.dist import collectives

    real = collectives._take_rows
    monkeypatch.setattr(collectives, "_take_rows",
                        lambda src, runs, rows: torch.zeros_like(real(src, runs, rows)))


def _drop_exchange_plan(monkeypatch):
    """Every relayer's cross-rack units arrive as zeros."""
    from repro_torch.core.codes.drc_family1 import DRCFamily1
    from repro_torch.core.repair import Send

    real = DRCFamily1.repair_plan

    def plan(self, failed, rotation=0):
        p = real(self, failed, rotation)
        zeros = [Send(s.src, s.dst, np.zeros_like(s.matrix)) for s in p.relayer_sends]
        return dataclasses.replace(p, relayer_sends=zeros)

    monkeypatch.setattr(DRCFamily1, "repair_plan", plan)


for _cell in ("drc_9_6_3.node_recovery", "rs_9_6_3.node_recovery"):
    FAULTS[_cell]["exchange_dropped"] = _drop_exchange_spmd
FAULTS["drc_9_6_3.degraded_read"]["exchange_dropped"] = _drop_exchange_plan

CASES = [(cell, fault) for cell in CELLS for fault in sorted(FAULTS[cell])]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_makes_the_run_not_correct(cell, fault, small, monkeypatch):
    FAULTS[cell][fault](monkeypatch)
    result, checks = _run(cell, small)
    assert not result["correct"]
    assert any(not c.ok for c in checks.values())
