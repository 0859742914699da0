"""Degraded read: one lost block rebuilt through ``RepairPlan.execute``, the
path a repairing checkpoint load takes (``train/checkpoint.py``).

A read of node ``lost`` in stripe ``s`` looks up the code's plan for the
node (``code.repair_plan``) and runs it on every surviving node's (alpha,
sub) payload of the stripe; it returns the rebuilt (alpha, sub) block.  The
pool's parity is encoded in set-up by ``make_encode_step``.
"""
from __future__ import annotations

import torch

from perfbench import data
from perfbench.checks import Check, Reservoir, wrong_bytes
from perfbench.reference.codes import node_rows, rebuild_from_helpers
from perfbench.reference.expect import true_stripes

from . import common


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: str):
        self.split: dict[str, float] = {}
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        n, a, sub = cfg["n"], cfg["alpha"], cfg["sub_bytes"]
        self.stripes = mix["pool_stripes"]
        self.code, encode = common.port_code(cfg, self.device, self.split)
        self.pool = common.encoded_pool(cfg, self.stripes, seed, self.device, encode, self.split)
        self.payloads = self.pool.view(self.stripes, n, a, sub)
        self.entry = lambda lost, helpers: self.code.repair_plan(lost).execute(helpers)
        self.kept = Reservoir(mix["check_sample"], data.rng(seed, "sample"))
        self.hold = mix["check_sample"] + 1  # the sample and the output being made
        self.helpers: dict[tuple[int, int], dict[int, torch.Tensor]] = {}
        self.credit_bytes = a * sub
        self.blocks_per_op = 1
        self.stripes_per_op = 1

    def warm(self, ops: list[dict]) -> None:
        """Each distinct operation once, holding as many outputs at a time
        as the window will, so the allocator has cached their blocks."""
        held: list = []
        for op in ops:
            held = held[-self.hold:] + [self.issue(op)]

    def arm(self) -> None:
        pass

    def issue(self, op: dict) -> torch.Tensor:
        key = (op["stripe"], op["lost"])
        helpers = self.helpers.get(key)
        if helpers is None:  # the client's views of the survivors, made once
            s, lost = key
            helpers = {i: self.payloads[s, i] for i in range(self.cfg["n"]) if i != lost}
            self.helpers[key] = helpers
        return self.entry(key[1], helpers)

    def keep(self, op: dict, out: torch.Tensor) -> None:
        self.kept.offer((op, out))

    def release(self) -> None:
        self.code = self.entry = None

    def judge(self) -> list[Check]:
        cfg, ka = self.cfg, self.cfg["k"] * self.cfg["alpha"]
        inputs = parity = rebuilt = 0
        kept = self.kept.items
        for s, truth in true_stripes(cfg, self.stripes, self.seed, self.device):
            inputs += wrong_bytes(self.pool[s, :ka], truth[:ka])
            parity += wrong_bytes(self.pool[s, ka:], truth[ka:])
            for op, out in kept:
                if op["stripe"] == s:
                    rebuilt += wrong_bytes(out, truth[node_rows(cfg, op["lost"])])
        return [
            Check("input_bytes_changed", inputs, limit=0),
            Check("setup_parity_bytes_wrong", parity, limit=0),
            Check("rebuilt_bytes_wrong", rebuilt, limit=0),
            Check("reads_compared", len(kept), least=min(self.kept.size, self.kept.offered)),
        ]

    def use_control(self, field) -> None:
        cfg = self.cfg
        self.entry = lambda lost, helpers: rebuild_from_helpers(cfg, field, helpers, lost)
