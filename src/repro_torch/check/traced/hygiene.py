"""Hot-path hygiene: host-transfer freedom and in-place outputs.

The port's counterpart of ``repro.check.traced.hygiene``.

* ``traced.hyg.host-transfer`` — the repair, serve, train and checkpoint
  programs must be pure device programs: a host read of a device value
  (``.item()``, ``bool()``, ``torch.equal``, ``nonzero``: the ops below) or a
  device-to-host copy stalls the hot path on a round trip.  The AST linter
  catches *syntactic* host reads; this rule catches whatever the program
  actually dispatched, through every function boundary.  Host-to-device
  copies (a code's matrix moved to the card) are counted in the record's
  ``info``, not failed.
* ``traced.hyg.donation`` — where the caller hands the program its output
  region (the parity rows of the checkpoint encode's stripe, the repair
  body's ``out=``), the program writes it in place: the region's storage is
  written by an op that computes into it (the GF custom op's ``out``,
  ``zero_``, ``fill_``), and no temporary of the region's size or larger is
  made and copied in.
  The counterpart of the reference's donation: a parity staged in a
  temporary double-allocates the payload, which at checkpoint sizes is the
  difference between in place and out of memory.
"""
from __future__ import annotations

from typing import Any

import torch

from ..report import FAIL, Finding
from .base import HYG_FAMILY, as_witness, rule
from .dtype_flow import CAST_OPS
from .capture import (
    CHECKPOINT,
    HOT_PATH,
    Op,
    TracedProgram,
    capture_call,
    fake_cuda,
    fake_mode,
    parity_region,
)

R_TH_HOST = "traced.hyg.host-transfer"
R_TH_DONATE = "traced.hyg.donation"

# ops that read a device value on the host (base names)
HOST_READ_OPS = frozenset({
    "_local_scalar_dense", "equal", "is_nonzero", "nonzero", "masked_select", "unique",
    "_unique", "_unique2", "unique_consecutive", "unique_dim", "repeat_interleave",
})
# ops that compute into the buffer they write
COMPUTE_INTO_OPS = frozenset({"repro_torch.gf_matmul", "aten.zero", "aten.fill"})


def _crossing(op: Op) -> str | None:
    """``"to_host"`` or ``"to_device"`` where a copy moves bytes between the
    host and a device, else None."""
    if op.base not in CAST_OPS or not op.outputs:
        return None
    dst = op.outputs[0]
    src_on_host = [t.device == "cpu" for t in op.inputs if t.key != dst.key]
    if dst.device == "cpu" and not all(src_on_host):
        return "to_host"
    if dst.device != "cpu" and any(src_on_host):
        return "to_device"
    return None


def host_transfers(program: TracedProgram) -> dict[str, Any]:
    """Device values read on the host and copies between host and device."""
    reads: dict[str, int] = {}
    to_host = to_device = to_device_bytes = 0
    for op in program.ops:
        crossing = _crossing(op)
        if op.base in HOST_READ_OPS and any(t.device != "cpu" for t in op.inputs):
            reads[op.name] = reads.get(op.name, 0) + 1
        elif crossing == "to_host":
            to_host += 1
        elif crossing == "to_device":
            to_device += 1
            to_device_bytes += op.outputs[0].nbytes
    return {"host_reads": reads, "device_to_host": to_host, "host_to_device": to_device,
            "host_to_device_bytes": to_device_bytes}


@rule(R_TH_HOST, HYG_FAMILY)
def check_host_transfer(program: TracedProgram) -> list[Finding]:
    """No host read of a device value and no device-to-host copy."""
    moved = host_transfers(program)
    out = [
        Finding(
            R_TH_HOST, FAIL,
            f"{program.name}: {count} `{name}` read(s) of a device value on the host — "
            f"the hot path must never round-trip through the host",
            as_witness(program=program.name, op=name, count=count),
        )
        for name, count in sorted(moved["host_reads"].items())
    ]
    if moved["device_to_host"]:
        out.append(Finding(
            R_TH_HOST, FAIL,
            f"{program.name}: {moved['device_to_host']} device-to-host copy(ies) — the "
            f"hot path must never round-trip through the host",
            as_witness(program=program.name, device_to_host=moved["device_to_host"]),
        ))
    return out


def _compute_into(op: Op) -> bool:
    return f"{op.namespace}.{op.base}" in COMPUTE_INTO_OPS


@rule(R_TH_DONATE, HYG_FAMILY)
def check_donation(program: TracedProgram) -> list[Finding]:
    """A handed output buffer is computed into, never staged and copied."""
    out: list[Finding] = []
    for buf in program.donated:
        rank = int(buf.key.split(":")[0])
        seen = {t.key for t in program.inputs}
        made: dict[str, int] = {}  # storages the trace made -> bytes of their largest view
        computed = False
        for op in (op for op in program.ops if op.rank == rank):
            seen.update(t.key for t in op.inputs)
            writes = [t for t in op.outputs if t.key == buf.key and not op.view]
            if writes and _compute_into(op):
                computed = True
            elif writes:
                staged = [t for t in op.inputs if made.get(t.key, -1) >= buf.nbytes]
                if staged:
                    out.append(Finding(
                        R_TH_DONATE, FAIL,
                        f"{program.name}: `{op.name}` on rank {rank} copies a temporary of "
                        f"{made[staged[0].key]} bytes into the handed {buf.nbytes}-byte "
                        f"region — the output must be computed in place, not staged",
                        as_witness(program=program.name, op=op.name, rank=rank,
                                   temporary_bytes=made[staged[0].key],
                                   region_bytes=buf.nbytes),
                    ))
            for t in op.outputs:
                if t.key not in seen or t.key in made:
                    made[t.key] = max(made.get(t.key, 0), t.nbytes)
                seen.add(t.key)
        if not computed:
            out.append(Finding(
                R_TH_DONATE, FAIL,
                f"{program.name}: no op computes into the handed buffer {list(buf.shape)} "
                f"on rank {rank} — its output was not produced in place",
                as_witness(program=program.name, rank=rank, buffer=list(buf.shape)),
            ))
    return out


# --------------------------------------------------------------- mutations
HYG_MUTATIONS: dict[str, str] = {
    "hyg_callback": R_TH_HOST,
    "hyg_no_donation": R_TH_DONATE,
}


def callback_mutation_program() -> TracedProgram:
    """A hot-path step that reads its loss on the host."""
    def bad(x: torch.Tensor) -> torch.Tensor:
        loss = (x * x).mean()
        # e.g. a "quick" metrics hook left in the step function
        print_loss = loss.item()
        return loss + 0.0 * print_loss

    with fake_cuda(), fake_mode():
        x = torch.empty((4, 8), dtype=torch.float32, device="cuda")
        return capture_call("mutant[hyg_callback]", HOT_PATH, bad, (x,), fake=True)


def donation_mutation_program(family: str = "DRC", n: int = 6, k: int = 4, r: int = 3,
                              sub: int = 256) -> TracedProgram:
    """A checkpoint encode that computes the parity into a fresh tensor and
    copies it into the stripe it was handed."""
    from repro_torch.core.codes import make_code
    from repro_torch.kernels import ops

    code = make_code(family, n, k, r)
    ka = code.k * code.alpha

    def bad(coded: torch.Tensor) -> torch.Tensor:
        parity = ops.gf_matmul(code.generator[ka:], coded[:ka])
        coded[ka:].copy_(parity)
        return coded

    with fake_cuda(), fake_mode():
        coded = torch.empty((code.n * code.alpha, sub), dtype=torch.uint8, device="cuda")
        program = capture_call("mutant[hyg_no_donation]", CHECKPOINT, bad, (coded,),
                               fake=True, payload_invars=(0,), payload_outvars=(0,),
                               meta={"code": code, "sub_bytes": sub})
    return parity_region(program, code, sub)


__all__ = [
    "COMPUTE_INTO_OPS", "HOST_READ_OPS", "HYG_MUTATIONS", "callback_mutation_program",
    "check_donation", "check_host_transfer", "donation_mutation_program",
    "host_transfers",
]
