"""Capture the port's entry points as analyzable op traces.

The counterpart of ``repro.check.traced.capture``.  The reference traces a
jaxpr and lowers it to HLO; the port has neither, and ``torch.export`` or FX
would miss both its point-to-point collectives (``dist.send``/``recv``
cannot be exported) and its kernels (ctypes launches are invisible to
them).  So the artifact is a **dispatch trace**: a ``TorchDispatchMode``
(:class:`Capture`) sits below PyTorch's dispatcher, as
``launch.dryrun.Meter`` does, and records every op the entry point
dispatches — its name, its tensor inputs and outputs (a storage key, dtype,
device, shape and bytes), and for a collective its peer or its group's
global ranks.  The GF kernel is the custom op ``repro_torch::gf_matmul`` and
the flash kernel ``repro_torch::flash_attention``, so each launch is one op
of the trace.

A :class:`TracedProgram` bundles what the rules consume for one entry point:
the ops (a program over a mesh is the union of its per-rank traces, each op
tagged with its rank), a :class:`CollectiveFootprint` of its sends,
receives, gathers and reductions, which tensors hold payload bytes, the
output buffer it was handed (``donated``) and ``meta``.

Keys are storages, so taint and aliasing follow views and in-place writes
(``^=``, ``out=``); every storage a capture meets is kept alive until the
capture ends, so no key is ever reused.

Capture never computes for real: the card's programs run on fake ``cuda``
tensors under ``FakeTensorMode`` (nothing is allocated or launched; a
kernel's custom op takes its fake kernel), except the plain GF product,
which runs on small CPU tensors.  Inside a fake capture an op whose tensors
are all real host tensors (a mesh's table of ranks) runs for real, and a
data-dependent read of a fake value (``_local_scalar_dense`` and the like)
is recorded and answered with a placeholder, so the capture goes on.  On a
PyTorch built without CUDA, :func:`fake_cuda` lends the CUDA device guard a
no-op (``csrc/fake_cuda_guard.cpp``) while a capture runs, without which a
fake card tensor cannot be indexed.  A program over a mesh runs rank by rank
in one process, each rank in its own ``fake`` process group
(:func:`fake_world`), which refuses to start beside any other group.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Callable, Iterator

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import (
    DataDependentOutputException,
    DynamicOutputShapeException,
    FakeTensorMode,
    is_fake,
)
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_leaves

REPAIR = "repair"
KERNEL = "kernel"
HOT_PATH = "hot-path"
CHECKPOINT = "checkpoint"

PROGRAM_KINDS = (REPAIR, KERNEL, HOT_PATH, CHECKPOINT)

# the reference's shapes (src/repro/check/traced/capture.py)
SERVE_ARCH = "xlstm_125m"
SERVE_BATCH, SERVE_SEQ, SERVE_KV = 2, 16, 32


# ---------------------------------------------------------------- the trace
@dataclasses.dataclass(frozen=True)
class TensorRef:
    """One tensor an op read or wrote: its storage's key (``"rank:n"``),
    dtype, device type, shape and bytes (of this view)."""

    key: str
    dtype: str
    device: str
    shape: tuple[int, ...]
    nbytes: int

    @property
    def rows(self) -> int:
        return self.shape[0] if self.shape else 1


@dataclasses.dataclass(frozen=True)
class Op:
    """One dispatched op: ``name`` as ``namespace.op.overload`` (e.g.
    ``aten.add.Tensor``, ``repro_torch.gf_matmul.default``,
    ``c10d.send.default``), its tensor arguments in order, the tensors it
    returned or wrote in place (a view op's output shares its input's
    storage and writes nothing), and for a collective its peer's global rank
    (point to point) or its group's global ranks."""

    rank: int
    name: str
    inputs: tuple[TensorRef, ...]
    outputs: tuple[TensorRef, ...]
    peer: int | None = None
    group: tuple[int, ...] = ()
    view: bool = False  # returns a view of an input and writes nothing

    @property
    def base(self) -> str:
        """The op's name without namespace, overload or in-place ``_``
        (``aten.add_.Tensor`` -> ``add``)."""
        parts = self.name.split(".")
        op = parts[1] if len(parts) > 1 else parts[0]
        return op[:-1] if op.endswith("_") and not op.startswith("_") else op

    @property
    def namespace(self) -> str:
        return self.name.split(".")[0]


@dataclasses.dataclass(frozen=True)
class P2POp:
    """One ``send`` or ``recv``: the rank that ran it, the peer's global
    rank, the rows and bytes of the message."""

    rank: int
    peer: int
    rows: int
    nbytes: int
    dtype: str


@dataclasses.dataclass(frozen=True)
class GroupOp:
    """One gather or reduction: the rank that ran it, the op and its
    group's global ranks."""

    rank: int
    name: str
    group: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class CollectiveFootprint:
    """Every collective the captured program performs, over all ranks."""

    sends: tuple[P2POp, ...] = ()
    recvs: tuple[P2POp, ...] = ()
    gathers: tuple[GroupOp, ...] = ()
    reduces: tuple[GroupOp, ...] = ()


_SEND_OPS = frozenset({"send"})
_RECV_OPS = frozenset({"recv", "recv_"})
_GATHER_OPS = frozenset({
    "allgather_", "_allgather_base_", "allgather_coalesced_",
    "allgather_into_tensor_coalesced_", "all_gather_into_tensor",
    "all_gather_into_tensor_out", "all_gather_into_tensor_coalesced", "broadcast_",
    "broadcast", "alltoall_", "alltoall_base_", "all_to_all_single", "gather_", "scatter_",
})
_REDUCE_OPS = frozenset({
    "allreduce_", "allreduce_coalesced_", "reduce_", "reduce_scatter_",
    "_reduce_scatter_base_", "reduce_scatter_tensor_coalesced_", "all_reduce",
    "all_reduce_coalesced", "reduce_scatter_tensor", "reduce_scatter_tensor_coalesced",
})
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")


def extract_footprint(ops: tuple[Op, ...]) -> CollectiveFootprint:
    """Distill the collectives out of an op trace."""
    sends, recvs, gathers, reduces = [], [], [], []
    for op in ops:
        if op.namespace not in _COLLECTIVE_NAMESPACES:
            continue
        raw = op.name.split(".")[1]
        if raw in _SEND_OPS or raw in _RECV_OPS:
            msg = op.inputs if raw in _SEND_OPS else op.outputs
            p2p = P2POp(rank=op.rank, peer=int(op.peer), rows=sum(t.rows for t in msg),
                        nbytes=sum(t.nbytes for t in msg),
                        dtype=msg[0].dtype if msg else "")
            (sends if raw in _SEND_OPS else recvs).append(p2p)
        elif raw in _GATHER_OPS:
            gathers.append(GroupOp(rank=op.rank, name=raw, group=op.group))
        elif raw in _REDUCE_OPS:
            reduces.append(GroupOp(rank=op.rank, name=raw, group=op.group))
    return CollectiveFootprint(sends=tuple(sends), recvs=tuple(recvs),
                               gathers=tuple(gathers), reduces=tuple(reduces))


@dataclasses.dataclass
class TracedProgram:
    """One captured entry point plus everything the rules need.

    ``inputs`` and ``outputs`` are the program's tensor arguments and
    results over all ranks (rank by rank); ``payload_invars`` and
    ``payload_outvars`` index the ones holding GF payload bytes; ``donated``
    holds the output buffers the caller handed the program to write in
    place (the encode's stripe, the repair body's ``out=``)."""

    name: str  # e.g. "spmd_repair[DRC(6,4,3) failed=0]"
    kind: str  # repair | kernel | hot-path | checkpoint
    ops: tuple[Op, ...]
    footprint: CollectiveFootprint
    inputs: tuple[TensorRef, ...] = ()
    outputs: tuple[TensorRef, ...] = ()
    payload_invars: tuple[int, ...] = ()
    payload_outvars: tuple[int, ...] = ()
    donated: tuple[TensorRef, ...] = ()
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.kind not in PROGRAM_KINDS:
            raise ValueError(f"bad program kind {self.kind!r}")


def signature(program: TracedProgram) -> list[tuple[str, tuple, tuple]]:
    """The program op by op as (name, input dtypes and shapes, output dtypes
    and shapes): what a fake capture and a real one of the same call share."""
    def refs(ts: tuple[TensorRef, ...]) -> tuple:
        return tuple((t.dtype, t.shape) for t in ts)
    return [(op.name, refs(op.inputs), refs(op.outputs)) for op in program.ops]


# ------------------------------------------------------------- the capture
def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _group_ranks(arg: Any) -> tuple[int, ...] | None:
    """Global ranks of a process group passed to a c10d op (a boxed
    ``ProcessGroup``) or named to a functional collective."""
    from torch._C._distributed_c10d import ProcessGroup

    if isinstance(arg, torch.ScriptObject):
        group = ProcessGroup.unbox(arg)
    elif isinstance(arg, str):
        try:
            group = dist.distributed_c10d._resolve_process_group(arg)
        except (KeyError, ValueError, RuntimeError):
            return None
    else:
        return None
    return tuple(dist.get_process_group_ranks(group))


def _placeholder(func: Any, args: tuple) -> Any:
    """What a data-dependent read of a fake value returns in a capture: a
    zero of its dtype (``True`` for a truth value), an empty index list."""
    packet = func._overloadpacket.__name__
    if packet == "_local_scalar_dense":
        t = args[0]
        if t.dtype == torch.bool:
            return True
        return 0.0 if t.dtype.is_floating_point else 0
    if packet in ("equal", "is_nonzero"):
        return True
    if packet == "nonzero":
        return args[0].new_empty((0, args[0].dim()), dtype=torch.long)
    return None


class Capture(TorchDispatchMode):
    """Records every op dispatched below it, tagged with ``rank``.

    With ``fake`` (the entry point runs under ``FakeTensorMode``), ops
    whose tensors are all real host tensors run for real, outside the fake
    mode, and a data-dependent read of a fake value is recorded and
    answered by :func:`_placeholder`."""

    def __init__(self, rank: int = 0, *, fake: bool = False) -> None:
        super().__init__()
        self.rank = rank
        self.fake = fake
        self.ops: list[Op] = []
        self._keys: dict[int, str] = {}
        self._keep: list[Any] = []  # every storage met, alive until the capture ends

    def ref(self, t: torch.Tensor) -> TensorRef:
        st = t.untyped_storage()
        key = self._keys.get(st._cdata)
        if key is None:
            key = f"{self.rank}:{len(self._keys)}"
            self._keys[st._cdata] = key
            self._keep.append(st)
        return TensorRef(key=key, dtype=_dtype_name(t.dtype), device=t.device.type,
                         shape=tuple(int(d) for d in t.shape),
                         nbytes=t.numel() * t.element_size())

    def _run(self, func: Any, args: tuple, kwargs: dict) -> Any:
        leaves = tree_leaves((args, kwargs))
        tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
        host = all(not is_fake(t) and t.device.type == "cpu" for t in tensors) and all(
            torch.device(d).type == "cpu" for d in leaves if isinstance(d, torch.device))
        if self.fake and tensors and host:
            with _disable_current_modes():
                return func(*args, **kwargs)
        try:
            return func(*args, **kwargs)
        except (DataDependentOutputException, DynamicOutputShapeException):
            if not self.fake:
                raise
            out = _placeholder(func, args)
            if out is None:
                raise
            return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        if func.namespace == "prim":  # metadata queries (`prim.device`) read no value
            return out
        named = dict(zip((a.name for a in func._schema.arguments), args)) | kwargs
        written = [t for a in func._schema.arguments
                   if a.alias_info is not None and a.alias_info.is_write
                   for t in tree_leaves(named.get(a.name)) if isinstance(t, torch.Tensor)]
        peer, group = None, ()
        if func.namespace in _COLLECTIVE_NAMESPACES:
            group = next((g for g in map(_group_ranks, named.values()) if g is not None), ())
            raw = func._overloadpacket.__name__
            if raw in _SEND_OPS | _RECV_OPS:
                local = int(named["dst" if raw in _SEND_OPS else "src"])
                peer = group[local] if group else local
            if raw in _RECV_OPS:  # the schema marks no write on the received tensors
                written += [t for t in named["tensors"] if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        outs += [t for t in written if all(t is not o for o in outs)]
        self.ops.append(Op(
            rank=self.rank, name=str(func),
            inputs=tuple(self.ref(t) for t in tree_leaves((args, kwargs))
                         if isinstance(t, torch.Tensor)),
            outputs=tuple(self.ref(t) for t in outs), peer=peer, group=group,
            view=bool(func.is_view)))
        return out


# ------------------------------------------------- fake card, fake world
_BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "traced"
_GUARD_SOURCE = Path(__file__).resolve().parent / "csrc" / "fake_cuda_guard.cpp"
_guard_lock = threading.Lock()


@functools.lru_cache(maxsize=1)
def _guard_lib() -> ctypes.CDLL:
    """``csrc/fake_cuda_guard.cpp`` built with the host's C++ compiler
    against this torch's headers and ``libc10`` (under ``build/traced``,
    named by a hash of the source and the torch version)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("fake card tensors on a CPU-only PyTorch need a C++ compiler")
    root = Path(torch.__file__).resolve().parent
    digest = hashlib.sha256(_GUARD_SOURCE.read_bytes() + torch.__version__.encode())
    target = _BUILD_DIR / f"fake_cuda_guard-{digest.hexdigest()[:16]}.so"
    if not target.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [cxx, "-O1", "-shared", "-fPIC", "-std=c++17", f"-I{root / 'include'}",
             "-o", str(tmp), str(_GUARD_SOURCE), f"-L{root / 'lib'}", "-lc10",
             f"-Wl,-rpath,{root / 'lib'}"],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building the fake CUDA guard failed:\n{proc.stderr}")
        os.replace(tmp, target)
    lib = ctypes.CDLL(str(target))
    lib.fake_cuda_guard_install.restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def fake_cuda() -> Iterator[None]:
    """Let fake ``cuda`` tensors be indexed and copied on a PyTorch built
    without CUDA (a no-op device guard, removed on exit); a CUDA build has
    its own guard and needs nothing."""
    if torch.backends.cuda.is_built():
        yield
        return
    with _guard_lock:
        lib = _guard_lib()
        installed = lib.fake_cuda_guard_install()
    try:
        yield
    finally:
        if installed:
            lib.fake_cuda_guard_remove()


@contextlib.contextmanager
def fake_world(n: int, rank: int) -> Iterator[None]:
    """A ``fake`` default process group of ``n`` ranks with this process as
    ``rank`` (collectives return at once and move nothing).  Refuses to start
    while any default group exists, and on exit destroys only what it made
    (the group and the subgroups made under it)."""
    if dist.is_initialized():
        raise RuntimeError(
            f"a traced capture needs its own fake process group, but a "
            f"{dist.get_backend()!r} group of {dist.get_world_size()} ranks exists: "
            f"capture before it is made or after it is destroyed")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_mode() -> FakeTensorMode:
    """The fake mode of a capture: real tensors met inside it are made fake."""
    return FakeTensorMode(allow_non_fake_inputs=True)


def _program(name: str, kind: str, captures: list[Capture], inputs: list[TensorRef],
             outputs: list[TensorRef], **kw: Any) -> TracedProgram:
    ops = tuple(op for cap in captures for op in cap.ops)
    return TracedProgram(name=name, kind=kind, ops=ops, footprint=extract_footprint(ops),
                         inputs=tuple(inputs), outputs=tuple(outputs), **kw)


def capture_call(name: str, kind: str, fn: Callable[..., Any], args: tuple, *,
                 fake: bool, payload_invars: tuple[int, ...] = (),
                 payload_outvars: tuple[int, ...] = (), donated: tuple[int, ...] = (),
                 meta: dict[str, Any] | None = None) -> TracedProgram:
    """Capture one call ``fn(*args)`` in this process.  ``args`` must be
    made under the fake mode the caller entered when ``fake``; ``donated``
    indexes the tensor arguments the program writes in place.  A real call
    keeps its arguments and result in ``meta["call"]``, for the caller to
    check."""
    cap = Capture(fake=fake)
    flat = [t for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
    inputs = [cap.ref(t) for t in flat]
    with cap:
        out = fn(*args)
    outputs = [cap.ref(t) for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    meta = dict(meta or {})
    if not fake:
        meta["call"] = (args, out)
    return _program(name, kind, [cap], inputs, outputs, payload_invars=payload_invars,
                    payload_outvars=payload_outvars,
                    donated=tuple(inputs[i] for i in donated), meta=meta)


# ------------------------------------------------------- repair entry point
def capture_spmd_repair(family: str, n: int, k: int, r: int, *, failed: int = 0,
                        sub: int = 256) -> TracedProgram:
    """The process-group program ``spmd_repair(..., mesh=)`` runs: the body
    of ``dist.collectives.make_mesh_repair`` on every rank of a fake
    ``(pod, node)`` world of r·w ranks, each rank's (1, alpha, sub) shard a
    fake card tensor, called with ``out=``."""
    from repro_torch.core.codes import make_code
    from repro_torch.dist.collectives import make_mesh_repair, plan_to_spmd
    from repro_torch.launch.mesh import make_repair_mesh

    code = make_code(family, n, k, r)
    plan = code.repair_plan(failed)
    spec = plan_to_spmd(code, plan)
    world = spec.r * spec.w
    captures, inputs, outputs, donated = [], [], [], []
    with fake_cuda():
        for rank in range(world):
            with fake_world(world, rank):
                body = make_mesh_repair(spec, make_repair_mesh(spec.r, spec.w,
                                                               device_type="cpu"))
                with fake_mode():
                    x = torch.empty((1, spec.alpha, sub), dtype=torch.uint8, device="cuda")
                    out = torch.empty_like(x)
                    cap = Capture(rank, fake=True)
                    inputs += [cap.ref(x), cap.ref(out)]
                    with cap:
                        y = body(x, out=out)
                    outputs.append(cap.ref(y))
                    donated.append(cap.ref(out))
                    captures.append(cap)
    return _program(
        f"spmd_repair[{family}({n},{k},{r}) failed={failed}]", REPAIR, captures, inputs,
        outputs, payload_invars=tuple(range(0, 2 * world, 2)),
        payload_outvars=tuple(range(world)), donated=tuple(donated),
        meta={"spec": spec, "plan": plan, "code": code, "sub_bytes": sub, "w": spec.w,
              "r": spec.r})


# ------------------------------------------------------- kernel call sites
def capture_gf_table(rows: int = 3, k: int = 6, sub: int = 256) -> TracedProgram:
    """The plain GF product ``core.gf_torch.gf_matmul_table``, the CPU's
    path of every coding product, on small CPU tensors."""
    from repro_torch.core.gf_torch import gf_matmul_table

    m = torch.zeros((rows, k), dtype=torch.uint8)
    x = torch.zeros((k, sub), dtype=torch.uint8)
    return capture_call(f"gf_matmul_table[{rows}x{k}x{sub}]", KERNEL, gf_matmul_table,
                        (m, x), fake=False, payload_invars=(0, 1), payload_outvars=(0,))


def capture_gf_cuda(rows: int = 3, k: int = 6, sub: int = 1024, *, fake: bool = True,
                    generator: torch.Generator | None = None) -> TracedProgram:
    """``kernels.ops.gf_matmul`` on card tensors: the custom op
    ``repro_torch::gf_matmul`` (fake tensors: its fake kernel, nothing
    launched; real ones, drawn from ``generator``: the kernel)."""
    from repro_torch.kernels import ops

    def call() -> TracedProgram:
        m = torch.empty((rows, k), dtype=torch.uint8, device="cuda")
        x = torch.empty((k, sub), dtype=torch.uint8, device="cuda")
        if not fake:
            m.random_(0, 256, generator=generator)
            x.random_(0, 256, generator=generator)
        return capture_call(f"gf_matmul_cuda[{rows}x{k}x{sub}]", KERNEL, ops.gf_matmul,
                            (m, x), fake=fake, payload_invars=(0, 1), payload_outvars=(0,))

    return _in_mode(call, fake)


def _in_mode(call: Callable[[], TracedProgram], fake: bool) -> TracedProgram:
    if not fake:
        return call()
    with fake_cuda(), fake_mode():
        return call()


# ----------------------------------------------------- serve / train paths
def _model(cfg: Any, fake: bool, generator: torch.Generator | None) -> Any:
    from repro_torch.models import backbone

    if fake:  # as launch.dryrun.build_cell does: parameters allocated, not drawn
        return backbone.Backbone(cfg, device="cuda")
    return backbone.init_model(cfg, generator=generator, device="cuda")


def _tokens(cfg: Any, shape: tuple[int, int], fake: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    tok = torch.empty(shape, dtype=torch.long, device="cuda")
    return tok if fake else tok.random_(0, cfg.vocab, generator=generator)


def capture_serve_prefill(arch: str = SERVE_ARCH, batch: int = SERVE_BATCH,
                          seq: int = SERVE_SEQ) -> TracedProgram:
    """``serve.serve_step.make_prefill_step`` on fake card tensors (chunk =
    seq)."""
    from repro_torch.configs import get_smoke
    from repro_torch.serve.serve_step import make_prefill_step

    cfg = get_smoke(arch)

    def call() -> TracedProgram:
        model = _model(cfg, True, None)
        tok = _tokens(cfg, (batch, seq), True, None)
        step = make_prefill_step(cfg, chunk=seq, device="cuda")
        return capture_call(f"prefill_step[{cfg.name}]", HOT_PATH, step,
                            (model, {"tokens": tok}), fake=True)

    return _in_mode(call, True)


def capture_serve_decode(arch: str = SERVE_ARCH, batch: int = SERVE_BATCH,
                         kv_len: int = SERVE_KV, *, fake: bool = True,
                         generator: torch.Generator | None = None) -> TracedProgram:
    """``serve.serve_step.make_decode_step`` on the card, one token at
    position 0 of a zero decode state."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import backbone
    from repro_torch.serve.serve_step import make_decode_step

    cfg = get_smoke(arch)

    def call() -> TracedProgram:
        model = _model(cfg, fake, generator)
        state = backbone.init_decode_state(cfg, batch, kv_len, device="cuda")
        tok = _tokens(cfg, (batch, 1), fake, generator)
        step = make_decode_step(cfg, device="cuda")
        return capture_call(f"serve_step[{cfg.name}]", HOT_PATH,
                            lambda m, s, t: step(m, s, t, 0), (model, state, tok), fake=fake)

    return _in_mode(call, fake)


def train_device() -> str:
    """Where the train step's capture runs: the card's fake tensors, or on a
    PyTorch built without CUDA fake host tensors, since its autograd engine
    asks for an accelerator before it runs a backward over card tensors."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def capture_train_step(arch: str = SERVE_ARCH, batch: int = SERVE_BATCH,
                       seq: int = SERVE_SEQ) -> TracedProgram:
    """``train.train_step.make_train_step``, the reference's mesh-free
    variant (``fused_xent=False``, ``attn_chunk=seq``), with zero AdamW
    state, on fake tensors on :func:`train_device`."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import backbone
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import TrainConfig, make_train_step

    cfg = get_smoke(arch)
    tcfg = TrainConfig(fused_xent=False, attn_chunk=seq)
    device = train_device()

    def call() -> TracedProgram:
        model = backbone.Backbone(cfg, device=device)
        model.requires_grad_(True)
        opt = init_opt_state(model, tcfg.optimizer)
        tok = torch.empty((batch, seq), dtype=torch.long, device=device)
        step = make_train_step(cfg, tcfg)
        return capture_call(f"train_step[{cfg.name}]", HOT_PATH,
                            lambda m, o, b: step(m, o, b, 0),
                            (model, opt, {"tokens": tok, "labels": tok}), fake=True,
                            meta={"device": device})

    return _in_mode(call, True)


# ------------------------------------------------------- checkpoint encode
def capture_checkpoint_encode(family: str = "DRC", n: int = 6, k: int = 4, r: int = 3,
                              sub: int = 256, *, fake: bool = True,
                              generator: torch.Generator | None = None) -> TracedProgram:
    """The in-place systematic encode checkpointing runs
    (``train.checkpoint.make_encode_step``), handed its stripe."""
    from repro_torch.core.codes import make_code
    from repro_torch.train.checkpoint import make_encode_step

    code = make_code(family, n, k, r)

    def call() -> TracedProgram:
        step = make_encode_step(code, sub, "cuda")
        coded = torch.empty((code.n * code.alpha, sub), dtype=torch.uint8, device="cuda")
        if not fake:
            coded.random_(0, 256, generator=generator)
        program = capture_call(f"ckpt_encode[{family}({n},{k},{r}) sub={sub}]", CHECKPOINT,
                               step, (coded,), fake=fake, payload_invars=(0,),
                               payload_outvars=(0,), meta={"code": code, "sub_bytes": sub})
        return parity_region(program, code, sub)

    return _in_mode(call, fake)


def parity_region(program: TracedProgram, code: Any, sub: int) -> TracedProgram:
    """``program`` handed the parity rows of its first argument, a
    (n·alpha, sub) stripe, as the region it must write in place."""
    rows = (code.n - code.k) * code.alpha
    stripe = program.inputs[0]
    region = dataclasses.replace(stripe, shape=(rows, sub), nbytes=rows * sub)
    return dataclasses.replace(program, donated=(region,))


__all__ = [
    "CHECKPOINT", "HOT_PATH", "KERNEL", "PROGRAM_KINDS", "REPAIR", "Capture",
    "CollectiveFootprint", "GroupOp", "Op", "P2POp", "TensorRef", "TracedProgram",
    "capture_call", "capture_checkpoint_encode", "capture_gf_cuda", "capture_gf_table",
    "capture_serve_decode", "capture_serve_prefill", "capture_spmd_repair",
    "capture_train_step", "extract_footprint", "parity_region", "fake_cuda", "fake_mode", "fake_world", "signature", "train_device",
]
