"""The numbers a run compares, each beside its limit, and the seeded sample
of outputs that is kept for the comparison."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Check:
    """One number compared: it passes when ``least <= value <= limit``
    (either side may be open)."""

    name: str
    value: float
    limit: float | None = None
    least: float | None = None

    @property
    def ok(self) -> bool:
        if self.limit is not None and not self.value <= self.limit:
            return False
        return self.least is None or self.value >= self.least

    def as_dict(self) -> dict:
        out: dict = {"value": self.value}
        if self.limit is not None:
            out["limit"] = self.limit
        if self.least is not None:
            out["least"] = self.least
        return out

    def line(self) -> str:
        bounds = []
        if self.least is not None:
            bounds.append(f"least {self.least:g}")
        if self.limit is not None:
            bounds.append(f"limit {self.limit:g}")
        return f"check {self.name} = {self.value:g} ({', '.join(bounds)}): {'ok' if self.ok else 'FAIL'}"


def wrong_bytes(got: torch.Tensor, want: torch.Tensor) -> int:
    """Bytes of ``got`` that differ from ``want`` (same shape)."""
    if tuple(got.shape) != tuple(want.shape):
        return int(want.numel())
    return int((got != want).sum().item())


def nonzero_bytes(t: torch.Tensor) -> int:
    return int(torch.count_nonzero(t).item())


class Reservoir:
    """A uniform sample of at most ``size`` of the items offered, chosen by
    a seeded generator: the outputs kept for the comparison.  An item that
    drops out is released at once, so at most ``size`` are held."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size = size
        self.rng = rng
        self.items: list = []
        self.offered = 0

    def offer(self, item) -> None:
        self.offered += 1
        if len(self.items) < self.size:
            self.items.append(item)
            return
        j = int(self.rng.integers(self.offered))
        if j < self.size:
            self.items[j] = item
