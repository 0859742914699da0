"""Repair-plan engine — the paper's DoubleR workflow (§2.2, §5.2) as data.

A `RepairPlan` is an explicit, executable DAG mirroring DoubleR's three
exported APIs:

* ``NodeEncode``   — each helper node applies a small GF matrix to its own
                     α subblocks and ships the resulting units.
* ``RelayerEncode``— one relayer per non-local rack re-encodes [its own
                     subblocks ++ units received from rack-mates] and ships
                     the result cross-rack to the target.
* ``Decode``       — the target applies the decode matrix to every unit it
                     received (local units ++ relayer units ++ any direct
                     cross-rack units for non-layered codes).

Plans carry exact GF(256) matrices, so they are simultaneously

  (a) executable against real payload bytes (torch tensors on the card,
      through ``repro_torch.kernels.ops.gf_matmul``),
  (b) verifiable symbolically (propagate coefficient vectors; the decode
      matrix must reproduce the failed node's generator rows), and
  (c) the source of truth for bandwidth accounting (inner- vs cross-rack
      bytes, per-relayer balance) used by the analysis/benchmarks.

Unit = one subblock payload of B/α bytes; bandwidth is reported in *blocks*.
"""
from __future__ import annotations

from dataclasses import InitVar, dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch import obs
from repro_torch.check.errors import PlanError
from repro_torch.kernels import ops

from . import gf
from .placement import Placement

TARGET = -1  # pseudo destination id for the reconstruction target


@dataclass(frozen=True)
class Send:
    """One directed transfer of `matrix.shape[0]` units."""

    src: int
    dst: int  # a relayer node id, or TARGET
    matrix: np.ndarray  # (units, input_dim) over GF(256)

    def __post_init__(self) -> None:
        m = self.matrix
        where = f"Send {self.src}->{self.dst}"
        if not isinstance(m, np.ndarray) or m.ndim != 2:
            raise PlanError(
                f"{where}: matrix must be a 2-D ndarray, got "
                f"{type(m).__name__} ndim={getattr(m, 'ndim', None)}",
                rule="plan.dag.send-matrix", src=self.src, dst=self.dst,
            )
        if m.dtype != np.uint8:
            raise PlanError(
                f"{where}: matrix must be uint8 over GF(256), got {m.dtype}",
                rule="plan.dag.send-matrix", src=self.src, dst=self.dst,
                dtype=str(m.dtype),
            )
        if m.shape[1] == 0:
            raise PlanError(
                f"{where}: matrix has no input columns (shape {m.shape}) — "
                f"the sender would combine zero subblocks",
                rule="plan.dag.send-matrix", src=self.src, dst=self.dst,
                shape=m.shape,
            )

    @property
    def units(self) -> int:
        return self.matrix.shape[0]


@dataclass
class RepairPlan:
    """Executable repair of one failed node (paper Fig. 1)."""

    failed: int
    placement: Placement
    alpha: int
    node_sends: list[Send]  # NodeEncode: input_dim == alpha (own subblocks)
    relayer_sends: list[Send]  # RelayerEncode: input = own subblocks ++ received
    decode: np.ndarray  # (alpha, total units at target)
    # provenance of the target's input units, in decode-column order:
    target_order: list[int] = field(default_factory=list)  # src node per unit
    family: InitVar[str] = ""  # the code's name: labels the build counter

    def __post_init__(self, family: str) -> None:
        # every plan is built here, and a plan cache's hit never gets here:
        # the counter is the codes' plan-cache misses
        obs.counter_add("repair.plan.builds", 1, family=family)

    # ------------------------------------------------------------------ util
    def _relayer_input_order(self, relayer: int) -> list[Send]:
        """Units entering a relayer, in canonical order (after its own rows)."""
        return sorted(
            (s for s in self.node_sends if s.dst == relayer), key=lambda s: s.src
        )

    @property
    def relayers(self) -> list[int]:
        return sorted({s.src for s in self.relayer_sends})

    # ------------------------------------------------------------ accounting
    def traffic_blocks(self) -> dict[str, Any]:
        """Inner-/cross-rack repair traffic in units of blocks (B = 1);
        ``per_relayer_cross`` is a nested {relayer: blocks} map."""
        rack = self.placement.rack_of
        target_rack = rack(self.failed)
        inner = 0.0
        cross = 0.0
        per_relayer_cross: dict[int, float] = {}
        for s in self.node_sends:
            dst_rack = target_rack if s.dst == TARGET else rack(s.dst)
            size = s.units / self.alpha
            if rack(s.src) == dst_rack:
                inner += size
            else:
                cross += size
        for s in self.relayer_sends:
            size = s.units / self.alpha
            if rack(s.src) == target_rack:
                inner += size
            else:
                cross += size
                per_relayer_cross[s.src] = per_relayer_cross.get(s.src, 0.0) + size
        return {
            "inner_rack_blocks": inner,
            "cross_rack_blocks": cross,
            "per_relayer_cross": per_relayer_cross,
            "total_blocks": inner + cross,
        }

    def relayer_io_blocks(self, relayer: int) -> tuple[float, float]:
        """(units received from rack-mates, units sent cross-rack), in blocks."""
        recv = sum(s.units for s in self.node_sends if s.dst == relayer) / self.alpha
        sent = sum(s.units for s in self.relayer_sends if s.src == relayer) / self.alpha
        return recv, sent

    # ---------------------------------------------------------- verification
    def coefficient_check(self, node_coeffs: list[np.ndarray]) -> bool:
        """Symbolic correctness: decode @ (target unit coeffs) == G_failed.

        node_coeffs[i]: (alpha, k*alpha) coefficient rows of node i's
        subblocks in terms of the data subsymbols.
        """
        unit_coeffs = self._target_unit_coeffs(node_coeffs)
        got = gf.gf_matmul(self.decode, unit_coeffs)
        return bool(np.array_equal(got, node_coeffs[self.failed]))

    def _target_unit_coeffs(self, node_coeffs: list[np.ndarray]) -> np.ndarray:
        sent_coeffs: dict[tuple[int, int], np.ndarray] = {}
        for s in self.node_sends:
            sent_coeffs[(s.src, s.dst)] = gf.gf_matmul(s.matrix, node_coeffs[s.src])
        rows: list[np.ndarray] = []
        order: list[int] = []
        for s in sorted(
            (x for x in self.node_sends if x.dst == TARGET), key=lambda x: x.src
        ):
            rows.append(sent_coeffs[(s.src, TARGET)])
            order.extend([s.src] * s.units)
        for s in sorted(self.relayer_sends, key=lambda x: x.src):
            inputs = [node_coeffs[s.src]]
            for ns in self._relayer_input_order(s.src):
                inputs.append(sent_coeffs[(ns.src, s.src)])
            rows.append(gf.gf_matmul(s.matrix, np.concatenate(inputs, axis=0)))
            order.extend([s.src] * s.units)
        if order != self.target_order:
            raise PlanError(
                f"target order mismatch: canonical {order} vs recorded "
                f"{self.target_order}",
                rule="plan.dag.target-order",
                canonical=order, recorded=list(self.target_order),
                failed=self.failed,
            )
        return np.concatenate(rows, axis=0)

    # ---------------------------------------------------------- observability
    def _record_send(self, s: Send, sub_bytes: int, stage: str) -> None:
        """Book one transfer into the obs counters.

        Classification (inner vs cross rack) is intentionally the same
        rule as `traffic_blocks`, so traced byte counters cross-check
        exactly against the plan's symbolic bandwidth accounting:
        bytes == blocks * alpha * sub_bytes.
        """
        rack = self.placement.rack_of
        dst_rack = rack(self.failed) if s.dst == TARGET else rack(s.dst)
        scope = "inner" if rack(s.src) == dst_rack else "cross"
        nbytes = s.units * sub_bytes
        obs.counter_add(f"repair.bytes.{scope}_rack", nbytes, stage=stage)
        if stage == "relayer_encode" and scope == "cross":
            obs.counter_add("repair.units_cross", s.units, relayer=str(s.src))

    @staticmethod
    def _record_gf(matrix: np.ndarray, sub_bytes: int, stage: str) -> None:
        """Book one product's GF multiply bytes: its nonzero coefficients,
        each over a subblock."""
        obs.counter_add("repair.gf_mult_bytes",
                        int(np.count_nonzero(matrix)) * sub_bytes, stage=stage)

    # ------------------------------------------------------------- execution
    def execute(self, payloads: dict[int, torch.Tensor]) -> torch.Tensor:
        """Run the plan on real bytes.

        payloads: node id -> (alpha, sub_bytes) uint8 tensor for every
        surviving helper the plan references, all on one device.  Returns
        the reconstructed (alpha, sub_bytes) payload of the failed node, on
        that device; every GF product goes through ``ops.gf_matmul``.

        Under an active `repro_torch.obs` tracer, every NodeEncode /
        RelayerEncode / Decode gets a span and the bytes each transfer
        moves are counted inner- vs cross-rack (see `_record_send`).
        """
        sub_bytes = next(iter(payloads.values())).shape[1]
        traced = obs.enabled()  # the counters' arithmetic runs only when read
        with obs.span("repair.execute", cat="repair", failed=self.failed,
                      alpha=self.alpha, sub_bytes=sub_bytes):
            sent: dict[tuple[int, int], torch.Tensor] = {}
            for s in self.node_sends:
                with obs.span("repair.node_encode", cat="repair", src=s.src,
                              dst=s.dst, units=s.units):
                    sent[(s.src, s.dst)] = ops.gf_matmul(s.matrix, payloads[s.src])
                    if traced:
                        self._record_gf(s.matrix, sub_bytes, "node_encode")
                if traced:
                    self._record_send(s, sub_bytes, "node_encode")
            units: list[torch.Tensor] = []
            for s in sorted(
                (x for x in self.node_sends if x.dst == TARGET), key=lambda x: x.src
            ):
                units.append(sent[(s.src, TARGET)])
            for s in sorted(self.relayer_sends, key=lambda x: x.src):
                with obs.span("repair.relayer_encode", cat="repair",
                              relayer=s.src, units=s.units):
                    inputs = [payloads[s.src]]
                    for ns in self._relayer_input_order(s.src):
                        inputs.append(sent[(ns.src, s.src)])
                    units.append(
                        ops.gf_matmul(s.matrix, torch.cat(inputs, dim=0))
                    )
                    if traced:
                        self._record_gf(s.matrix, sub_bytes, "relayer_encode")
                if traced:
                    self._record_send(s, sub_bytes, "relayer_encode")
            with obs.span("repair.decode", cat="repair",
                          units=self.decode.shape[1]):
                target_in = torch.cat(units, dim=0)
                if traced:
                    self._record_gf(self.decode, sub_bytes, "decode")
                return ops.gf_matmul(self.decode, target_in)

    def participants(self) -> list[int]:
        return sorted(
            {s.src for s in self.node_sends} | {s.src for s in self.relayer_sends}
        )


def build_target_order(plan_sends: list[Send], relayer_sends: list[Send]) -> list[int]:
    order: list[int] = []
    for s in sorted((x for x in plan_sends if x.dst == TARGET), key=lambda x: x.src):
        order.extend([s.src] * s.units)
    for s in sorted(relayer_sends, key=lambda x: x.src):
        order.extend([s.src] * s.units)
    return order
