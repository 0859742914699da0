"""Erasure-coded distributed checkpointing — the paper's technique as a
first-class framework feature, over dicts of torch tensors.

Training state (params + optimizer state) is serialized, split into k
equal *blocks*, and encoded with a chosen code (RS / MSR / DRC) into n
payloads placed on n failure domains grouped into r *racks*.  On restore:

* all payloads present → direct (systematic) read of the k data blocks;
* one payload missing  → **layered repair** (the paper's degraded read /
  node recovery): the exact RepairPlan runs, with inner-rack vs
  cross-rack traffic accounted — DRC moves Eq. (3)-minimal bytes across
  racks;
* ≥ 2 missing, ≤ n-k    → MDS decode from any k survivors.

Payloads carry CRC32s so silent corruption degrades to the repair path.
The serialized bytes, the padding of ``sub``, the on-disk layout and the
CRCs are those of ``repro.train.checkpoint``, so each package restores the
other's checkpoints (see also :func:`checkpoint_from_arrays`).
"""
from __future__ import annotations

import json
import os
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.code_base import ErasureCode
from repro_torch.core.codes import make_code
from repro_torch.kernels import ops

Device = str | torch.device


# ------------------------------------------------------------- serialization
def _flatten(state: Any) -> list[torch.Tensor]:
    """Leaves in ``jax.tree.flatten`` order: dict keys sorted, recursively;
    lists and tuples in order."""
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, dict):
        return [leaf for key in sorted(state) for leaf in _flatten(state[key])]
    if isinstance(state, (list, tuple)):
        return [leaf for item in state for leaf in _flatten(item)]
    raise TypeError(f"checkpoint leaves must be tensors, got {type(state).__name__}")


def _unflatten(like: Any, leaves: list[torch.Tensor]) -> Any:
    it = iter(leaves)

    def build(node: Any) -> Any:
        if isinstance(node, torch.Tensor):
            return next(it)
        if isinstance(node, dict):
            rebuilt = {key: build(node[key]) for key in sorted(node)}
            return {key: rebuilt[key] for key in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(item) for item in node)
        raise TypeError(f"checkpoint leaves must be tensors, got {type(node).__name__}")

    return build(like)


def _dtype_name(dt: torch.dtype) -> str:
    # torch.float32 -> "float32", torch.bfloat16 -> "bfloat16": the numpy
    # (ml_dtypes) names the reference writes into its meta
    return str(dt).removeprefix("torch.")


def state_to_bytes(state: Any) -> tuple[torch.Tensor, list[dict]]:
    """Serialize the leaves into one uint8 tensor on their device.

    Each leaf contributes its raw little-endian storage: the bytes numpy's
    ``tobytes()`` gives for the same array (bf16 leaves, which have no
    numpy dtype, go through a byte view of their 16-bit storage).
    """
    meta = []
    chunks = []
    for leaf in _flatten(state):
        meta.append({"shape": list(leaf.shape), "dtype": _dtype_name(leaf.dtype)})
        chunks.append(leaf.detach().contiguous().reshape(-1).view(torch.uint8))
    if not chunks:
        return torch.zeros(0, dtype=torch.uint8), meta
    return torch.cat(chunks), meta


def bytes_to_state(buf: torch.Tensor, meta: list[dict], like: Any) -> Any:
    """Inverse of :func:`state_to_bytes`; leaves land on ``buf``'s device."""
    leaves = []
    off = 0
    for m in meta:
        dt = getattr(torch, m["dtype"])
        n = int(np.prod(m["shape"])) if m["shape"] else 1
        nb = n * torch.empty((), dtype=dt).element_size()
        raw = buf[off:off + nb].clone()  # own storage: views need aligned offsets
        leaves.append(raw.view(dt).reshape(m["shape"]))
        off += nb
    return _unflatten(like, leaves)


# ------------------------------------------------------------------ encoding
@dataclass
class EncodedCheckpoint:
    code_spec: tuple[str, int, int, int]
    payloads: dict[int, torch.Tensor]  # node id -> (alpha, sub_bytes) uint8
    total_bytes: int
    meta: list[dict]
    step: int = 0

    @property
    def code(self) -> ErasureCode:
        return make_code(*self.code_spec)


def checkpoint_from_arrays(
    code_spec: tuple[str, int, int, int],
    payloads: dict[int, np.ndarray],
    total_bytes: int,
    meta: list[dict],
    step: int = 0,
    *,
    device: Device = "cuda",
) -> EncodedCheckpoint:
    """Build an :class:`EncodedCheckpoint` from numpy payloads — e.g. the
    fields of a ``repro.train.checkpoint.EncodedCheckpoint`` — so that a
    checkpoint encoded by the reference is restored and repaired here.
    Codes need no carrying: both packages build them from the spec."""
    family, n, k, r = code_spec
    return EncodedCheckpoint(
        code_spec=(str(family), int(n), int(k), int(r)),
        payloads={int(i): torch.from_numpy(np.array(p, dtype=np.uint8)).to(device)
                  for i, p in payloads.items()},
        total_bytes=int(total_bytes),
        meta=[dict(m) for m in meta],
        step=int(step),
    )


# One encode step per (code, sub, device): holds the parity rows of the
# generator on the device.
_ENCODE_STEPS: dict[tuple[str, int, str], Callable[[torch.Tensor], torch.Tensor]] = {}


def make_encode_step(
    code: ErasureCode, sub: int, device: Device = "cuda"
) -> Callable[[torch.Tensor], torch.Tensor]:
    """In-place systematic encode ``coded -> coded``.

    ``coded`` is the full (n*alpha, sub) uint8 stripe; rows [:k*alpha]
    hold data and the step overwrites the parity rows with
    ``generator[k*alpha:] @ data`` in GF(2^8).  The parity rows are a
    contiguous view of the stripe, handed to the kernel as its ``out``:
    the counterpart of the reference's donated buffer, so no parity copy
    is allocated.
    """
    device = torch.device(device)
    key = (repr(code), sub, str(device))
    step = _ENCODE_STEPS.get(key)
    if step is not None:
        return step
    ka = code.k * code.alpha
    gen_parity = torch.from_numpy(np.ascontiguousarray(code.generator[ka:])).to(device)

    def encode(coded: torch.Tensor) -> torch.Tensor:
        if tuple(coded.shape) != (code.n * code.alpha, sub) or not coded.is_contiguous():
            raise ValueError(f"need a contiguous ({code.n * code.alpha}, {sub}) stripe")
        ops.gf_matmul(gen_parity, coded[:ka], out=coded[ka:])
        return coded

    _ENCODE_STEPS[key] = encode
    return encode


def encode_state(
    state: Any, *, family: str = "DRC", n: int = 9, k: int = 6, r: int = 3,
    step: int = 0, device: Device = "cuda",
) -> EncodedCheckpoint:
    """Serialize ``state`` and encode it into n payloads on ``device``."""
    code = make_code(family, n, k, r)
    with obs.span("ckpt.encode", cat="checkpoint", family=family, n=n, k=k, r=r):
        buf, meta = state_to_bytes(state)
        total = int(buf.numel())
        ka = code.k * code.alpha
        sub = (total + ka - 1) // ka
        sub = (sub + 127) // 128 * 128  # byte-identical to the reference's payloads
        stripe = torch.zeros((code.n * code.alpha, sub), dtype=torch.uint8, device=device)
        stripe[:ka].view(-1)[:total] = buf.to(device)
        coded = make_encode_step(code, sub, device)(stripe)
        a = code.alpha
        payloads = {i: coded[i * a:(i + 1) * a] for i in range(code.n)}
        obs.counter_add("ckpt.encoded_bytes", int(coded.numel()), family=family)
    return EncodedCheckpoint(
        code_spec=(family, n, k, r),
        payloads=payloads,
        total_bytes=total,
        meta=meta,
        step=step,
    )


@dataclass
class RestoreReport:
    mode: str  # direct | repair | decode
    repaired_nodes: list[int] = field(default_factory=list)
    cross_rack_blocks: float = 0.0
    inner_rack_blocks: float = 0.0


def restore_state(
    ckpt: EncodedCheckpoint, like: Any, available: set[int] | None = None
) -> tuple[Any, RestoreReport]:
    code = ckpt.code
    if available is None:
        available = set(ckpt.payloads)
    missing = [i for i in range(code.n) if i not in available]
    with obs.span("ckpt.restore", cat="checkpoint", step=ckpt.step,
                  missing=len(missing)):
        report = RestoreReport(mode="direct")
        payloads = {i: p for i, p in ckpt.payloads.items() if i in available}

        data_nodes = list(range(code.k))
        missing_data = [i for i in data_nodes if i not in available]
        if not missing_data:
            data = torch.cat([payloads[i] for i in data_nodes], dim=0)
        elif len(missing) == 1:
            # single-failure: the paper's layered repair (degraded read)
            f = missing[0]
            plan = code.repair_plan(f)
            repaired = plan.execute(payloads)
            t = plan.traffic_blocks()
            report = RestoreReport(
                mode="repair",
                repaired_nodes=[f],
                cross_rack_blocks=t["cross_rack_blocks"],
                inner_rack_blocks=t["inner_rack_blocks"],
            )
            payloads = dict(payloads)
            payloads[f] = repaired
            data = torch.cat([payloads[i] for i in data_nodes], dim=0)
        else:
            if len(available) < code.k:
                raise ValueError(
                    f"unrecoverable: {len(missing)} failures > n-k = {code.n - code.k}"
                )
            chosen = dict(list(sorted(payloads.items()))[: code.k])
            data = code.decode(chosen)
            report = RestoreReport(mode="decode", repaired_nodes=missing)
        obs.counter_add("ckpt.restores", 1, mode=report.mode)
        buf = data.reshape(-1)[: ckpt.total_bytes]
        return bytes_to_state(buf, ckpt.meta, like), report


def repair_node(ckpt: EncodedCheckpoint, failed: int) -> tuple[torch.Tensor, dict]:
    """Node recovery of one payload; returns (payload, traffic stats)."""
    code = ckpt.code
    with obs.span("ckpt.repair_node", cat="checkpoint", failed=failed):
        plan = code.repair_plan(failed)
        payloads = {i: p for i, p in ckpt.payloads.items() if i != failed}
        repaired = plan.execute(payloads)
        return repaired, plan.traffic_blocks()


# ---------------------------------------------------------------------- disk
class CheckpointManager:
    """Disk-backed erasure-coded checkpoints with CRC validation.

    Layout: <dir>/step_<N>/node_<i>.bin (+ meta.json), the reference's.
    Each node file would live on a distinct host/pod in deployment;
    restore tolerates up to n-k missing or corrupt files.  Encode, repair
    and decode run on ``device``.
    """

    def __init__(
        self, directory: str, *, family: str = "DRC", n: int = 9, k: int = 6,
        r: int = 3, keep: int = 3, device: Device = "cuda",
    ):
        self.dir = directory
        self.spec = (family, n, k, r)
        self.keep = keep
        self.device = torch.device(device)
        os.makedirs(directory, exist_ok=True)

    def _stepdir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def save(self, step: int, state: Any) -> EncodedCheckpoint:
        family, n, k, r = self.spec
        ckpt = encode_state(state, family=family, n=n, k=k, r=r, step=step,
                            device=self.device)
        with obs.span("ckpt.save", cat="checkpoint", step=step):
            d = self._stepdir(step)
            os.makedirs(d, exist_ok=True)
            crcs = {}
            for i, payload in ckpt.payloads.items():
                raw = payload.cpu().numpy().tobytes()
                crcs[str(i)] = zlib.crc32(raw)
                with open(os.path.join(d, f"node_{i}.bin"), "wb") as f:
                    f.write(raw)
            meta = {
                "step": step,
                "code": list(ckpt.code_spec),
                "total_bytes": ckpt.total_bytes,
                "payload_shape": list(next(iter(ckpt.payloads.values())).shape),
                "crcs": crcs,
                "leaves": ckpt.meta,
            }
            with open(os.path.join(d, "meta.json"), "w") as f:
                json.dump(meta, f)
            self._gc()
        return ckpt

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                os.path.join(self.dir, name, "meta.json")
            ):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep]:
            d = self._stepdir(s)
            for f in os.listdir(d):
                os.remove(os.path.join(d, f))
            os.rmdir(d)

    def load(self, like: Any, step: int | None = None) -> tuple[Any, int, RestoreReport]:
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        step = step if step is not None else steps[-1]
        with obs.span("ckpt.load", cat="checkpoint", step=step):
            return self._load_step(like, step)

    def _load_step(self, like: Any, step: int) -> tuple[Any, int, RestoreReport]:
        d = self._stepdir(step)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        shape = tuple(meta["payload_shape"])
        payloads = {}
        for i in range(meta["code"][1]):
            path = os.path.join(d, f"node_{i}.bin")
            if not os.path.exists(path):
                continue
            with open(path, "rb") as f:
                raw = f.read()
            if zlib.crc32(raw) != meta["crcs"][str(i)]:
                continue  # corrupt -> treat as failed node
            payloads[i] = np.frombuffer(raw, dtype=np.uint8).reshape(shape)
        ckpt = checkpoint_from_arrays(
            tuple(meta["code"]), payloads, meta["total_bytes"], meta["leaves"],
            step, device=self.device,
        )
        state, report = restore_state(ckpt, like, available=set(payloads))
        return state, step, report
