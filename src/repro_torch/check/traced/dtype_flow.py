"""uint8 dtype-flow lattice over captured op traces.

The port's counterpart of ``repro.check.traced.dtype_flow``.  GF(2^8)
payload bytes must only ever be combined with XOR / table lookups while they
are in byte form; integer arithmetic (``+ * -`` wrap mod 256) or a float
promotion silently produces wrong parities that no shape check can see.  The
lowered layer's source-level taint pass stops at function boundaries; here
the program is the flat list of ops it dispatched, so the taint follows
payloads through every call layer, the executors, ``kernels.ops`` and the
custom op ``repro_torch::gf_matmul`` alike.

The lattice: a **storage** is tainted when it holds bytes that derive from
GF payload bytes while uint8, and a uint8 tensor is tainted when its storage
is, so views and in-place writes (``^=``, ``out=``) carry taint.  Sources are
the program's declared payload inputs and every uint8 tensor the trace did
not make (the GF multiplication table, the codes' matrices).  Taint flows
through bitwise, indexing, view and copy ops and through the GF custom op
into every uint8 tensor they write; it never grows smaller.  A cast of a
tainted uint8 tensor to another integer type is the sanctioned exit (index
lookups: a torch uint8 index would be a mask).  Violations:

* ``wrap-arith`` — an integer-ring op (add/sub/mul/div/remainder/pow/mm/
  bmm/addmm/sum/prod/cumsum/...) consumes a tainted operand: GF addition is
  XOR, so this wraps.
* ``promotion`` — a tainted uint8 tensor is cast to a floating dtype
  (float, bf16): payload bytes must never enter the float domain.
* ``payload-output`` — a declared payload output is not uint8.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..report import FAIL, Finding
from .base import DTYPE_FAMILY, as_witness, rule
from .capture import KERNEL, TracedProgram, capture_call

R_TD_WRAP = "traced.dtype.wrap-arith"
R_TD_PROMO = "traced.dtype.promotion"
R_TD_OUT = "traced.dtype.payload-output"

WRAP = "wrap-arith"
PROMO = "promotion"

# Integer-ring ops (base names, in-place and out variants alike): a tainted
# operand here wraps mod 2^8 (or a widened ring), which is never GF(2^8).
ARITH_OPS = frozenset({
    "add", "sub", "rsub", "mul", "div", "floor_divide", "true_divide", "remainder",
    "fmod", "pow", "neg", "abs", "mm", "bmm", "addmm", "addbmm", "baddbmm", "addmv", "mv",
    "dot", "vdot", "matmul", "_int_mm", "sum", "nansum", "prod", "cumsum", "cumprod",
    "mean", "addcmul", "addcdiv", "lerp", "index_add", "scatter_add", "scatter_reduce",
    "index_reduce", "_foreach_add", "_foreach_mul", "_foreach_sub",
})
# Casts: the written tensor's dtype decides (exit, promotion or uint8 copy).
CAST_OPS = frozenset({"_to_copy", "to", "copy", "_copy_from", "_copy_from_and_resize"})

_FLOAT_PREFIXES = ("float", "bfloat", "complex")


@dataclasses.dataclass(frozen=True)
class DtypeViolation:
    kind: str  # wrap-arith | promotion
    op: str
    in_dtypes: tuple[str, ...]
    out_dtype: str


def dtype_flow_violations(program: TracedProgram) -> list[DtypeViolation]:
    """Run the lattice over one captured program, op by op."""
    tainted: set[str] = {program.inputs[i].key for i in program.payload_invars
                         if program.inputs[i].dtype == "uint8"}
    seen: set[str] = set()
    found: set[DtypeViolation] = set()
    for op in program.ops:
        for t in op.inputs:
            if t.key not in seen:
                seen.add(t.key)  # a tensor the trace did not make
                if t.dtype == "uint8":
                    tainted.add(t.key)
        seen.update(t.key for t in op.outputs)
        base = op.base
        # a cast reads its source (``copy_``'s second argument), not its destination
        read = op.inputs[1:] if base in CAST_OPS and op.inputs[:1] == op.outputs[:1] \
            else op.inputs
        hot = [t for t in read if t.dtype == "uint8" and t.key in tainted]
        if not hot:
            continue
        out_dtype = op.outputs[0].dtype if op.outputs else ""
        if base in ARITH_OPS:
            found.add(DtypeViolation(WRAP, op.name, tuple(t.dtype for t in op.inputs),
                                     out_dtype))
            continue
        if base in CAST_OPS and out_dtype.startswith(_FLOAT_PREFIXES):
            found.add(DtypeViolation(PROMO, op.name, tuple(t.dtype for t in op.inputs),
                                     out_dtype))
            continue
        tainted.update(t.key for t in op.outputs if t.dtype == "uint8")
    return sorted(found, key=lambda v: (v.kind, v.op, v.in_dtypes))


# ------------------------------------------------------------------- rules
@rule(R_TD_WRAP, DTYPE_FAMILY)
def check_wrap_arith(program: TracedProgram) -> list[Finding]:
    """No integer-ring arithmetic ever consumes a GF payload byte."""
    return [
        Finding(
            R_TD_WRAP, FAIL,
            f"{program.name}: `{v.op}` consumes GF payload bytes "
            f"({', '.join(v.in_dtypes)}) — integer arithmetic wraps mod 2^8; GF "
            f"addition is XOR",
            as_witness(program=program.name, op=v.op, in_dtypes=list(v.in_dtypes),
                       out_dtype=v.out_dtype),
        )
        for v in dtype_flow_violations(program) if v.kind == WRAP
    ]


@rule(R_TD_PROMO, DTYPE_FAMILY)
def check_promotion(program: TracedProgram) -> list[Finding]:
    """No GF payload byte is ever cast to a floating dtype."""
    return [
        Finding(
            R_TD_PROMO, FAIL,
            f"{program.name}: GF payload bytes promoted to {v.out_dtype} via "
            f"`{v.op}` — payloads must never enter the float domain",
            as_witness(program=program.name, op=v.op, out_dtype=v.out_dtype),
        )
        for v in dtype_flow_violations(program) if v.kind == PROMO
    ]


@rule(R_TD_OUT, DTYPE_FAMILY)
def check_payload_output(program: TracedProgram) -> list[Finding]:
    """Declared payload outputs leave the program as uint8."""
    out: list[Finding] = []
    for idx in program.payload_outvars:
        if idx >= len(program.outputs):
            continue
        dt = program.outputs[idx].dtype
        if dt != "uint8":
            out.append(Finding(
                R_TD_OUT, FAIL,
                f"{program.name}: payload output {idx} has dtype {dt}, expected uint8 — "
                f"the byte domain must be preserved end-to-end",
                as_witness(program=program.name, outvar=idx, dtype=dt),
            ))
    return out


# --------------------------------------------------------------- mutations
# mutation name -> owning rule id; each captures a deliberately wrong GF
# program and must FAIL exactly its owner.
DTYPE_MUTATIONS: dict[str, str] = {
    "dtype_wrap_arith": R_TD_WRAP,
    "dtype_float_promote": R_TD_PROMO,
    "dtype_narrow_output": R_TD_OUT,
}


def dtype_mutation_program(mutation: str) -> TracedProgram:
    """Capture the mutated plain GF product owned by `mutation`."""
    from repro_torch.core.gf_torch import gf_matmul_table

    if mutation == "dtype_wrap_arith":
        def bad(m: Any, x: Any) -> Any:
            # integer + instead of XOR when combining parities: wraps
            return gf_matmul_table(m, x) + gf_matmul_table(m, x)
    elif mutation == "dtype_float_promote":
        def bad(m: Any, x: Any) -> Any:
            # payload round-trips through float32 before encoding
            return gf_matmul_table(m, x.float().to(torch.uint8))
    elif mutation == "dtype_narrow_output":
        def bad(m: Any, x: Any) -> Any:
            # payload leaves the program as int16 instead of uint8
            return gf_matmul_table(m, x).to(torch.int16)
    else:
        raise ValueError(f"unknown dtype mutation {mutation!r}")
    m = torch.zeros((3, 6), dtype=torch.uint8)
    x = torch.zeros((6, 256), dtype=torch.uint8)
    return capture_call(f"mutant[{mutation}]", KERNEL, bad, (m, x), fake=False,
                        payload_invars=(0, 1), payload_outvars=(0,))


__all__ = [
    "ARITH_OPS", "CAST_OPS", "DTYPE_MUTATIONS", "DtypeViolation", "check_payload_output",
    "check_promotion", "check_wrap_arith", "dtype_flow_violations",
    "dtype_mutation_program",
]
