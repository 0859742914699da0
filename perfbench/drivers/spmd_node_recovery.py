"""Node recovery: ``repro_torch.dist.collectives.spmd_node_recovery`` on the
emulated mesh, one lost node's blocks in every stripe of the pool a call.

The pool is (S, n, alpha, sub) on one card, node-major; its parity is
encoded in set-up by ``repro_torch.train.checkpoint.make_encode_step``.  A
call's output has the pool's shape: in stripe s, row ``rack(lost) * w`` (the
collector, device ``(rack, 0)``) holds the rebuilt block and every other row
is zero.
"""
from __future__ import annotations

import time

import torch

from perfbench import data
from perfbench.checks import Check, Reservoir, nonzero_bytes, wrong_bytes
from perfbench.reference.codes import node_rows, rebuild_from_helpers
from perfbench.reference.expect import true_stripes

from . import common


def collector(cfg: dict, lost: int) -> int:
    w = cfg["n"] // cfg["r"]
    return lost // w * w


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: str):
        self.split: dict[str, float] = {}
        t = time.perf_counter()
        from repro_torch.dist.collectives import spmd_node_recovery
        self.split["imports"] = time.perf_counter() - t
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        n, a, sub = cfg["n"], cfg["alpha"], cfg["sub_bytes"]
        self.stripes = mix["pool_stripes"]
        self.code, encode = common.port_code(cfg, self.device, self.split)
        self.pool = common.encoded_pool(cfg, self.stripes, seed, self.device, encode, self.split)
        self.payloads = self.pool.view(self.stripes, n, a, sub)
        self.entry = lambda lost: spmd_node_recovery(self.code, lost, self.payloads)[0]
        self.kept = Reservoir(mix["check_sample"], data.rng(seed, "sample"))
        self.hold = mix["check_sample"] + 1  # the sample and the output being made
        self.credit_bytes = self.stripes * a * sub
        self.blocks_per_op = self.stripes
        self.stripes_per_op = self.stripes

    def warm(self, ops: list[dict]) -> None:
        """Each distinct operation once, holding as many outputs at a time
        as the window will, so the allocator has cached their blocks."""
        held: list = []
        for op in ops:
            held = held[-self.hold:] + [self.issue(op)]

    def arm(self) -> None:
        pass

    def issue(self, op: dict) -> torch.Tensor:
        return self.entry(op["lost"])

    def keep(self, op: dict, out: torch.Tensor) -> None:
        self.kept.offer((op, out))

    def release(self) -> None:
        self.code = self.entry = None

    def judge(self) -> list[Check]:
        cfg, ka = self.cfg, self.cfg["k"] * self.cfg["alpha"]
        block = cfg["alpha"] * cfg["sub_bytes"]
        shape = tuple(self.payloads.shape)
        inputs = parity = rebuilt = stray = 0
        kept = self.kept.items
        for op, out in kept:
            if tuple(out.shape) != shape:
                rebuilt += self.stripes * block
        for s, truth in true_stripes(cfg, self.stripes, self.seed, self.device):
            inputs += wrong_bytes(self.pool[s, :ka], truth[:ka])
            parity += wrong_bytes(self.pool[s, ka:], truth[ka:])
            for op, out in kept:
                if tuple(out.shape) != shape:
                    continue
                lost = op["lost"]
                c = collector(cfg, lost)
                rebuilt += wrong_bytes(out[s, c], truth[node_rows(cfg, lost)])
                stray += nonzero_bytes(out[s, :c]) + nonzero_bytes(out[s, c + 1:])
        return [
            Check("input_bytes_changed", inputs, limit=0),
            Check("setup_parity_bytes_wrong", parity, limit=0),
            Check("rebuilt_bytes_wrong", rebuilt, limit=0),
            Check("stray_bytes_nonzero", stray, limit=0),
            Check("blocks_compared", len(kept) * self.stripes, least=self.stripes),
        ]

    def use_control(self, field) -> None:
        cfg, n = self.cfg, self.cfg["n"]

        def entry(lost: int) -> torch.Tensor:
            out = torch.zeros_like(self.payloads)
            for s in range(self.stripes):
                helpers = {i: self.payloads[s, i] for i in range(n) if i != lost}
                out[s, collector(cfg, lost)] = rebuild_from_helpers(cfg, field, helpers, lost)
            return out

        self.entry = entry
