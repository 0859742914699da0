"""Cost model for the hierarchical-cluster simulator (paper §6.1/§6.2).

Constants are the paper's own testbed measurements:

* disk read 177 MiB/s (hdparm, §6.2),
* effective inner-rack bandwidth 1090 MiB/s (iperf on the 10 GbE),
* gateway efficiency 0.953 (1 Gb/s nominal -> 953 Mb/s effective),
* GF(2^8) coding throughput 600 MiB/s — back-derived from the paper's
  RelayerEncode/Decode rows of Table 3 (252 MiB / 0.443 s ≈ 569,
  192 MiB / 0.32 s = 600; we use 600),
* overlap efficiencies: how much of the non-bottleneck stage time hides
  under the bottleneck stage.  One point each is calibrated on the paper
  (degraded read: DRC(9,5,3)@1 Gb/s = 58.0% below RS; node recovery:
  DRC(9,5,3)@1 Gb/s = 2.81x RS); the remaining six ratio points of
  §6.3/§6.4 act as held-out validation (see tests/test_simulator.py).

This module keeps the paper's numbers so Figs. 6-8 and Table 3 are
reproduced under the paper's own cost model.  It is a copy of
``repro.storage.costmodel``; tests hold the two packages' results equal.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CostModel:
    disk_mib_s: float = 177.0
    inner_mib_s: float = 1090.0
    gateway_eff: float = 0.953
    gf_compute_mib_s: float = 600.0
    node_encode_speedup: float = 1.5  # single-combo NodeEncode runs hotter
    call_overhead_s: float = 1.0e-5  # per-strip per serial API chain (JNI)
    fixed_block_overhead_s: float = 0.08  # block open/commit metadata
    pipeline_stages: int = 6  # disk→enc→inner→relayer→cross→decode
    overlap_degraded: float = 0.80  # calibrated: §6.4 DRC(9,5,3)@1Gb/s
    overlap_recovery: float = 0.955  # calibrated: §6.3 DRC(9,5,3)@1Gb/s
    threads: int = 4

    def gateway_mib_s(self, gbps: float) -> float:
        return gbps * self.gateway_eff * 1e9 / 8 / 2**20
