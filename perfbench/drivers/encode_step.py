"""Stripe write: ``repro_torch.train.checkpoint.make_encode_step`` over a pool
of stripes, each encoded in place (its parity rows overwritten).

Set-up fills the pool's data rows from the seed; after the warm-up it fills
the parity rows with other seeded bytes just before the window, so every parity byte judged after
the window was written by an encode inside it.
"""
from __future__ import annotations

import torch

from perfbench import data
from perfbench.checks import Check, wrong_bytes
from perfbench.reference.codes import generator
from perfbench.reference.expect import true_stripes

from . import common


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: str):
        self.split: dict[str, float] = {}
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        self.stripes = mix["pool_stripes"]
        self.ka = cfg["k"] * cfg["alpha"]
        self.code, step = common.port_code(cfg, self.device, self.split)
        self.pool = common.encoded_pool(cfg, self.stripes, seed, self.device,
                                        lambda stripe: None, self.split)
        self.entry = step
        self.credit_bytes = self.ka * cfg["sub_bytes"]
        self.blocks_per_op = 0
        self.stripes_per_op = 1
        self.written: set[int] = set()

    def warm(self, ops: list[dict]) -> None:
        for op in ops:
            self.issue(op)

    def arm(self) -> None:
        data.fill_rows([self.pool[s, self.ka:] for s in range(self.stripes)], self.seed, "poison")
        common.sync(self.device)
        self.written.clear()

    def issue(self, op: dict) -> torch.Tensor:
        self.written.add(op["stripe"])
        return self.entry(self.pool[op["stripe"]])

    def keep(self, op: dict, out: torch.Tensor) -> None:
        pass

    def release(self) -> None:
        self.code = self.entry = None

    def judge(self) -> list[Check]:
        inputs = parity = 0
        for s, truth in true_stripes(self.cfg, self.stripes, self.seed, self.device):
            inputs += wrong_bytes(self.pool[s, :self.ka], truth[:self.ka])
            parity += wrong_bytes(self.pool[s, self.ka:], truth[self.ka:])
        return [
            Check("input_bytes_changed", inputs, limit=0),
            Check("parity_bytes_wrong", parity, limit=0),
            Check("stripes_written", len(self.written), least=self.stripes),
        ]

    def use_control(self, field) -> None:
        g, ka = generator(self.cfg, field), self.ka

        def entry(stripe: torch.Tensor) -> torch.Tensor:
            stripe[ka:] = field.apply(g[ka:], stripe[:ka])
            return stripe

        self.entry = entry
