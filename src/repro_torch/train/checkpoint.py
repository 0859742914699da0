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
other's checkpoints (see also :func:`checkpoint_from_arrays`).  A training
state (``train_step.train_state``) is the reference's tree, each layer
stack a ``weights.Stack`` whose ``(L, ...)`` bytes are its layers' one
after another: the encode writes each piece straight into the stripe, and
nothing is stacked.

A state whose leaves are DTensors is the counterpart of the reference's
sharded ``jax.Array``s: every rank of its mesh calls ``save`` and ``load``.
Rank 0 gathers one leaf at a time (``dist.root_io``; the reference's
``np.asarray``), encodes and writes; on load it restores (repairs or
decodes) once and sends each rank its blocks of each leaf (the reference's
``device_put`` with the state's shardings).
"""
from __future__ import annotations

import json
import os
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import is_fake

from repro_torch import obs
from repro_torch.core.code_base import ErasureCode
from repro_torch.core.codes import make_code
from repro_torch.dist.root_io import gather_to_root, scatter_from_root
from repro_torch.dist.sharding import is_dtensor
from repro_torch.kernels import ops
from repro_torch.models.weights import Stack

Device = str | torch.device


# ------------------------------------------------------------- serialization
def _flatten(state: Any) -> list:
    """Leaves in ``jax.tree.flatten`` order: dict keys sorted, recursively;
    lists and tuples in order.  A ``weights.Stack`` is one leaf."""
    if isinstance(state, (torch.Tensor, Stack)):
        return [state]
    if isinstance(state, dict):
        return [leaf for key in sorted(state) for leaf in _flatten(state[key])]
    if isinstance(state, (list, tuple)):
        return [leaf for item in state for leaf in _flatten(item)]
    raise TypeError(f"checkpoint leaves must be tensors, got {type(state).__name__}")


def _unflatten(like: Any, leaves: list) -> Any:
    it = iter(leaves)

    def build(node: Any) -> Any:
        if isinstance(node, Stack):
            leaf = next(it)
            return leaf if isinstance(leaf, Stack) else Stack(leaf.unbind(0))
        if isinstance(node, torch.Tensor):
            return next(it)
        if isinstance(node, dict):
            rebuilt = {key: build(node[key]) for key in sorted(node)}
            return {key: rebuilt[key] for key in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(item) for item in node)
        raise TypeError(f"checkpoint leaves must be tensors, got {type(node).__name__}")

    return build(like)


def _pieces(leaf: Any) -> list[torch.Tensor]:
    """The tensors a leaf's bytes come from, in order: a ``Stack``'s layers
    (its ``(L, ...)`` bytes are theirs one after another), else the leaf."""
    return leaf.layers if isinstance(leaf, Stack) else [leaf]


def tensors(state: Any) -> list[torch.Tensor]:
    """Every tensor of a state in serialization order, a ``Stack``'s layers
    one by one."""
    return [piece for leaf in _flatten(state) for piece in _pieces(leaf)]


def _dtype_name(dt: torch.dtype) -> str:
    # torch.float32 -> "float32", torch.bfloat16 -> "bfloat16": the numpy
    # (ml_dtypes) names the reference writes into its meta
    return str(dt).removeprefix("torch.")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()  # a DTensor's global size


def _raw(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def leaf_meta(state: Any) -> list[dict]:
    """Each leaf's ``{"shape", "dtype"}``, the reference's ``meta`` entries
    (a ``Stack``'s shape is its ``(L, ...)`` leaf's, a DTensor's global)."""
    return [{"shape": list(leaf.shape), "dtype": _dtype_name(leaf.dtype)}
            for leaf in _flatten(state)]


def state_to_bytes(state: Any) -> tuple[torch.Tensor, list[dict]]:
    """Serialize the leaves into one uint8 tensor on their device.

    Each leaf contributes its raw little-endian storage: the bytes numpy's
    ``tobytes()`` gives for the same array (bf16 leaves, which have no
    numpy dtype, go through a byte view of their 16-bit storage).
    """
    chunks = [_raw(piece) for piece in tensors(state)]
    if not chunks:
        return torch.zeros(0, dtype=torch.uint8), []
    return torch.cat(chunks), leaf_meta(state)


def bytes_to_state(buf: torch.Tensor, meta: list[dict], like: Any) -> Any:  # check: ignore[uninstrumented-entrypoint] pure converter
    """Inverse of :func:`state_to_bytes`; leaves land on ``buf``'s device,
    a ``Stack`` of ``like`` as a ``Stack`` of its layers."""
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


@torch.no_grad()
def copy_state_(live: Any, restored: Any) -> None:
    """Copy a restored state's leaves into the live state's, in place (a
    training job keeps its parameters and optimizer state objects; the
    restore returns fresh leaves).  The two trees must match leaf for leaf
    in shape and dtype; a ``Stack`` is copied layer by layer."""
    dst, src = _flatten(live), _flatten(restored)
    if len(dst) != len(src):
        raise ValueError(f"state has {len(dst)} leaves, the restored one {len(src)}")
    for i, (a, b) in enumerate(zip(dst, src)):
        if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
            raise ValueError(f"leaf {i}: live {a.dtype} {tuple(a.shape)}, "
                             f"restored {b.dtype} {tuple(b.shape)}")
        if isinstance(a, Stack):
            src_layers = b.layers if isinstance(b, Stack) else list(b.unbind(0))
            for x, y in zip(a.layers, src_layers):
                x.copy_(y)
        else:
            a.copy_(b.stacked() if isinstance(b, Stack) else b)


def _sharded(state: Any) -> bool:
    return any(is_dtensor(piece) for piece in tensors(state))


def gather_state(state: Any) -> Any:
    """A state whose leaves are DTensors, whole on rank 0 (each leaf
    gathered alone, ``dist.root_io.gather_to_root``; on the host for
    ``gloo``) and ``None`` on every other rank: the one-process state a
    sharded save writes."""
    leaves = []
    for leaf in _flatten(state):
        whole = [gather_to_root(piece) for piece in _pieces(leaf)]
        leaves.append(Stack(whole) if isinstance(leaf, Stack) and whole[0] is not None
                      else whole[0])
    return _unflatten(state, leaves) if dist.get_rank() == 0 else None


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


def checkpoint_from_arrays(  # check: ignore[uninstrumented-entrypoint] pure converter
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

    if not is_fake(gen_parity):  # a fake matrix must not outlive its mode
        _ENCODE_STEPS[key] = encode
    return encode


def encode_state(
    state: Any, *, family: str = "DRC", n: int = 9, k: int = 6, r: int = 3,
    step: int = 0, device: Device = "cuda",
) -> EncodedCheckpoint | None:
    """Serialize ``state`` and encode it into n payloads on ``device``.

    Each leaf's bytes are written straight into the stripe's data rows, one
    piece at a time (a ``Stack``'s layers in order), so no second copy of
    the state is made.  A state whose leaves are DTensors is encoded by rank
    0 alone: every rank of the mesh calls this, each leaf is gathered to
    rank 0 on its own (``dist.root_io``), and the others get ``None``."""
    code = make_code(family, n, k, r)
    leaves = _flatten(state)
    sharded = _sharded(state)
    mine = not sharded or dist.get_rank() == 0
    with obs.span("ckpt.encode", cat="checkpoint", family=family, n=n, k=k, r=r):
        meta = leaf_meta(state)
        total = sum(_nbytes(piece) for piece in tensors(state))
        ka = code.k * code.alpha
        sub = (total + ka - 1) // ka
        sub = (sub + 127) // 128 * 128  # byte-identical to the reference's payloads
        stripe = flat = None
        if mine:
            stripe = torch.zeros((code.n * code.alpha, sub), dtype=torch.uint8, device=device)
            flat = stripe[:ka].view(-1)
        off = 0
        for leaf in leaves:
            for piece in _pieces(leaf):
                whole = gather_to_root(piece) if sharded else piece
                nb = _nbytes(piece)
                if mine and nb:
                    flat[off:off + nb].copy_(_raw(whole))
                off += nb
        if not mine:
            return None
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


def restore_bytes(
    ckpt: EncodedCheckpoint, available: set[int] | None = None
) -> tuple[torch.Tensor, RestoreReport]:
    """The serialized state (``total_bytes`` uint8 on the payloads' device)
    from the available payloads: direct, layered repair or MDS decode."""
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
        return data.reshape(-1)[: ckpt.total_bytes], report


def restore_state(
    ckpt: EncodedCheckpoint, like: Any, available: set[int] | None = None
) -> tuple[Any, RestoreReport]:
    buf, report = restore_bytes(ckpt, available)
    return bytes_to_state(buf, ckpt.meta, like), report


def scatter_state(buf: torch.Tensor | None, like: Any) -> Any:
    """The serialized state ``buf`` (on rank 0; ``None`` elsewhere) laid
    out as ``like``, whose leaves are DTensors: each piece is cut from rank
    0's bytes and sent to its ranks on its own
    (``dist.root_io.scatter_from_root``).  Every rank of the mesh calls
    this and gets its own blocks."""
    leaves, off = [], 0
    for leaf in _flatten(like):
        got = []
        for piece in _pieces(leaf):
            nb, whole = _nbytes(piece), None
            if buf is not None:
                whole = buf[off:off + nb].clone().view(piece.dtype).reshape(tuple(piece.shape))
            got.append(scatter_from_root(whole, piece))
            off += nb
        leaves.append(Stack(got) if isinstance(leaf, Stack) else got[0])
    return _unflatten(like, leaves)


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

    def save(self, step: int, state: Any) -> EncodedCheckpoint | None:
        """Encode ``state`` and write its payloads and ``meta.json``.  A
        state of DTensors is saved by every rank of its mesh together: rank
        0 gathers each leaf, encodes and writes, and returns the checkpoint;
        the others return ``None`` once the files are written."""
        family, n, k, r = self.spec
        ckpt = encode_state(state, family=family, n=n, k=k, r=r, step=step,
                            device=self.device)
        if ckpt is not None:
            self._write(step, ckpt)
        if _sharded(state):
            dist.barrier()
        return ckpt

    def _write(self, step: int, ckpt: EncodedCheckpoint) -> None:
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

    def steps(self) -> list[int]:  # check: ignore[uninstrumented-entrypoint] directory scan
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
        """The state of ``step`` (the latest by default) in ``like``'s tree.
        Where ``like``'s leaves are DTensors every rank of their mesh calls
        this: rank 0 alone reads the files and restores (repairs or
        decodes) once, then each leaf is laid out into ``like``'s placements
        (``scatter_state``); every rank gets its own blocks and the same
        step and report."""
        if _sharded(like):
            return self._load_sharded(like, step)
        step = self._latest(step)
        with obs.span("ckpt.load", cat="checkpoint", step=step):
            ckpt = self._read(step)
            state, report = restore_state(ckpt, like, available=set(ckpt.payloads))
            return state, step, report

    def _latest(self, step: int | None) -> int:
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        return step if step is not None else steps[-1]

    def _read(self, step: int) -> EncodedCheckpoint:
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
        return checkpoint_from_arrays(
            tuple(meta["code"]), payloads, meta["total_bytes"], meta["leaves"],
            step, device=self.device,
        )

    def _load_sharded(self, like: Any, step: int | None) -> tuple[Any, int, RestoreReport]:
        buf = None
        head: list = [None, None, None]  # step, report, error
        if dist.get_rank() == 0:
            try:
                head[0] = self._latest(step)
                with obs.span("ckpt.load", cat="checkpoint", step=head[0]):
                    ckpt = self._read(head[0])
                    if ckpt.meta != leaf_meta(like):
                        raise ValueError("the checkpoint's leaves differ from the state's")
                    buf, head[1] = restore_bytes(ckpt, set(ckpt.payloads))
            except (OSError, ValueError) as err:  # every rank raises it
                head[2] = f"{type(err).__name__}: {err}"
        dist.broadcast_object_list(head, src=0)
        if head[2] is not None:
            raise RuntimeError(f"rank 0 could not restore the checkpoint: {head[2]}")
        state = scatter_state(buf, like)
        return state, head[0], head[1]
