"""Run the sharded model, prefill, train or decode, in one local process per
mesh device.

One process per device of a ``(data, model)`` or ``(pod, data, model)`` mesh
(``Case.mesh`` of two or three sizes: the pod axis is the reference's
``multi_pod`` mesh, with the batch sharded over ``("pod", "data")`` by
``make_rules(mode, multi_pod=True)``), all on this host, over a
``gloo`` process group that meets through a file (``dist.spawn.spawn_ranks``:
no port is chosen, so concurrent runs do not collide).  Tensors live on
``device``, the card unless the caller asks for the CPU; every rank of a card
run shares the one card, and runs inside ``mesh_collectives.host_staging()``.

    import tempfile
    from repro_torch.dist.model_run import Case, run
    rows = run([Case("dbrx-132b", smoke=True, param_dtype="float32", batch=4, seq=32)],
               workdir=tempfile.mkdtemp(), device="cpu")

Each rank, for each case in turn:

* builds the case's model: seeded (``backbone.init_model`` with a generator
  on ``device`` seeded with ``seed``, the same weights a single process
  draws) or loaded from ``params`` (an ``.npz`` of numpy arrays under the
  port's parameter names).  On a card the ranks build it in rounds, as many
  whole models at once as half the card holds, each keeping only its own
  blocks (``weights.shard_model``) before the next round starts.
  Consecutive cases with the same model reuse it, unless a train case
  updated it;
* runs the case's kind from a barrier to its synchronised end, under
  ``obs.tracing`` and a :class:`CollectiveCounter`:

  - ``prefill``: ``make_prefill_step(cfg, mesh=, rules=make_rules(mode))``
    on the case's inputs (:func:`case_inputs`: tokens, and the vlm's patches
    or the audio frames, the same on every rank); with
    ``all_positions``, ``backbone.forward`` under the mesh once more for
    every position's logits and the MoE's ``aux``;
  - ``train``: ``steps`` steps of ``make_train_step(cfg, train_config(case),
    mesh=, rules=)`` on one batch (:func:`case_batch`), numbered from
    ``TRAIN_WARMUP``, each timed on its own; with ``save_state`` the updated
    parameters and moments, gathered; with ``checkpoint`` the sharded state
    then goes through a ``CheckpointManager`` (DRC(9,6,3)) and back
    (:func:`_checkpoint_round_trip`);
  - ``decode``: a ``ServeEngine`` over the mesh fed the case's ``seq``-token
    prompts one step at a time (the audio family's frames through its
    encoder first), then ``new`` greedy tokens; with
    ``all_positions``, every step's logits.

Each rank writes ``workdir/rank<r>.json``; rank 0 also writes the gathered
arrays: ``case<i>.npy`` (a prefill's logits (B, padded_vocab) in f32, a
decode's at the last prompt position), ``case<i>_all.npy`` (every position's,
or every decode step's) and ``case<i>_state.npz`` (a train case's
``params.<name>``, ``m.<name>``, ``v.<name>``).  :func:`run` returns per
case the arrays and per rank: the collectives by kind (every redistribution
included; a train step's backward apart) and the bytes they were given by
mesh axis (``collective_bytes_by_axis``), those run through
``mesh_collectives`` (``moe_collectives``: the MoE layer's own, and in
training also the cross-entropy's and the global norm's, by phase), the
(token, choice) pairs routed and dropped, the flash kernel's launches, the
bytes staged through the host, peak memory (allocated and reserved: the
ranks share one card), the time, and the time the rank
spent building the model (``build_s``, 0 where it was reused).  A prefill's
first flash call's local shards (``attention.record_flash_inputs``) are also
run through the kernel and its plain version (``flash_max_abs_err``; these
launches are not counted).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import time
import warnings
import zlib
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import obs
from repro_torch.configs import get_config, get_smoke
from repro_torch.dist.mesh_collectives import host_staging, in_backward
from repro_torch.dist.sharding import Rules, axis_rules, is_dtensor, make_rules, use_mesh
from repro_torch.dist.spawn import spawn_ranks
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.kernels.gf_matmul import gf_matmul_batched
from repro_torch.launch.mesh import make_model_mesh
from repro_torch.models import attention, backbone
from repro_torch.models.config import ArchConfig
from repro_torch.models.weights import params_from_arrays, shard_model
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.serve_step import make_prefill_step
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.schedule import ScheduleConfig
from repro_torch.train import checkpoint as ckpt_io
from repro_torch.train.train_step import TrainConfig, make_train_step, train_state

KINDS = ("all_gather", "all_reduce", "reduce_scatter", "all_to_all")
PHASES = ("forward", "backward")


@dataclasses.dataclass(frozen=True)
class Case:
    arch: str
    kind: str = "prefill"  # "prefill", "train" or "decode"
    mode: str = "tp"  # the sharding rules (dist.sharding.MODES)
    mesh: tuple[int, ...] = (2, 4)  # (data, model), or (pod, data, model)
    batch: int = 2
    seq: int = 4096  # the positions of a row; decode: the prompt's
    layers: int | None = None  # depth cut; None: the config's own
    capacity_factor: float | None = None  # None: the config's own
    top_k: int | None = None  # experts a token is routed to; None: the config's own
    moe_sharding: str | None = None  # None: the config's own
    smoke: bool = False
    param_dtype: str | None = None  # None: the config's own
    seed: int = 0
    params: str | None = None  # .npz by parameter name; None: seeded from ``seed``
    all_positions: bool = False  # prefill: every position's logits; decode: every step's
    use_flash: bool | None = None  # None: the kernel on a card; True: its plain version on the CPU
    # train
    steps: int = 1
    microbatches: int = 1
    remat: str | None = None  # None: the config's own
    xent_tile: int = 2048
    save_state: bool = False
    checkpoint: bool = False  # save, lose node 2, load back, one more step
    # decode
    new: int = 4
    kv_len: int = 64


def mesh_axes(case: Case) -> tuple[str, ...]:
    """The case's mesh axis names: ``("pod", "data", "model")`` for three
    sizes, else ``("data", "model")``."""
    return ("pod", "data", "model") if len(case.mesh) == 3 else ("data", "model")


def case_rules(case: Case) -> Rules:
    """The case's sharding rules: ``make_rules(mode)``, ``multi_pod`` on a
    mesh with a pod axis."""
    return make_rules(case.mode, multi_pod=len(case.mesh) == 3)


def case_config(case: Case) -> ArchConfig:
    """The case's architecture with its cuts and overrides applied."""
    cfg = (get_smoke if case.smoke else get_config)(case.arch)
    if case.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=case.layers)
    if case.param_dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=case.param_dtype)
    if case.remat is not None:
        cfg = dataclasses.replace(cfg, remat=case.remat)
    if cfg.moe is not None:
        moe = cfg.moe
        if case.capacity_factor is not None:
            moe = dataclasses.replace(moe, capacity_factor=case.capacity_factor)
        if case.top_k is not None:
            moe = dataclasses.replace(moe, top_k=case.top_k)
        if case.moe_sharding is not None:
            moe = dataclasses.replace(moe, sharding=case.moe_sharding)
        cfg = dataclasses.replace(cfg, moe=moe)
    return cfg


STUB_EMBED_STD = 0.02  # the stub patch and frame embeddings' scale (train/data.py's)


def _text_len(case: Case, cfg: ArchConfig) -> int:
    """The token ids of a row: ``seq`` less the vlm's patches, which come
    first in a prefill or train row (a decode's prompt is text alone)."""
    if case.kind != "decode" and cfg.family == "vlm":
        return case.seq - cfg.vision_tokens
    return case.seq


def _side_inputs(cfg: ArchConfig, rng: np.random.Generator, batch: int) -> dict:
    """The family's stub inputs, f32, drawn after the token ids: the vlm's
    ``vis_embeds`` (batch, vision_tokens, d), the audio ``frames`` (batch,
    encoder_seq, d)."""
    out = {}
    if cfg.family == "vlm" and cfg.vision_tokens:
        out["vis_embeds"] = rng.standard_normal(
            (batch, cfg.vision_tokens, cfg.d_model)).astype(np.float32) * STUB_EMBED_STD
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32) * STUB_EMBED_STD
    return out


def case_inputs(case: Case) -> dict[str, np.ndarray]:
    """A prefill or decode case's inputs, from numpy's generator seeded with
    ``seed`` (so any process, of either package, draws the same): ``tokens``
    (batch, text) int32, then the family's ``vis_embeds`` or ``frames``."""
    cfg = case_config(case)
    rng = np.random.default_rng(case.seed)
    tokens = rng.integers(0, cfg.vocab, size=(case.batch, _text_len(case, cfg)), dtype=np.int32)
    return {"tokens": tokens, **_side_inputs(cfg, rng, case.batch)}


def case_tokens(case: Case) -> np.ndarray:
    """The case's prompts (``case_inputs``' token ids)."""
    return case_inputs(case)["tokens"]


def case_batch(case: Case) -> dict[str, np.ndarray]:
    """A train case's batch: ``tokens`` and the next tokens as ``labels``,
    from (batch, text + 1) tokens drawn by numpy's generator seeded with
    ``seed``, then the family's side inputs; the vlm's labels also cover its
    patch positions, with -1 (no loss) there, so they are (batch, seq)."""
    cfg = case_config(case)
    rng = np.random.default_rng(case.seed)
    rows = rng.integers(0, cfg.vocab, size=(case.batch, _text_len(case, cfg) + 1),
                        dtype=np.int32)
    out = {"tokens": rows[:, :-1], "labels": rows[:, 1:], **_side_inputs(cfg, rng, case.batch)}
    if "vis_embeds" in out:
        out["labels"] = np.concatenate(
            [np.full((case.batch, cfg.vision_tokens), -1, np.int32), out["labels"]], axis=1)
    return out


# a train case's steps are numbered from the end of the WSD schedule's
# warm-up, so that every step updates at the peak rate
TRAIN_LR, TRAIN_WARMUP = 1e-4, 2


def train_config(case: Case) -> TrainConfig:
    """A train case's training: AdamW in the config's state dtype, WSD at
    peak ``TRAIN_LR`` after ``TRAIN_WARMUP`` steps, ``microbatches``, KV
    chunks of 512, lm-head tiles of ``xent_tile`` rows."""
    return TrainConfig(
        optimizer=AdamWConfig(state_dtype=case_config(case).opt_state_dtype),
        schedule=ScheduleConfig(kind="wsd", peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP),
        microbatches=case.microbatches, xent_tile=case.xent_tile)


def seeded_model(case: Case, device: str):
    """The case's seeded model, whole, on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(case.seed)
    return backbone.init_model(case_config(case), generator=gen, device=device)


def _model_key(case: Case) -> tuple:
    return (case.arch, case.mode, case.mesh, case.layers, case.moe_sharding, case.smoke,
            case.param_dtype, case.seed, case.params)


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()  # check: ignore[host-sync] a rank's timer ends on the card


def _build(case: Case, mesh: Any, rank: int, world: int, device: str):
    """The case's model laid out over ``mesh``.  On a card the ranks build
    it in rounds, as many at once as half the card holds whole models, each
    keeping only its blocks before the next round starts."""
    cfg = case_config(case)
    at_once = world
    if device == "cuda":
        whole = sum(p.numel() * p.element_size()
                    for p in backbone.Backbone(cfg, device="meta").parameters())
        at_once = max(1, int(0.5 * torch.cuda.get_device_properties(0).total_memory // whole))
        # the ranks share one card: none starts a whole model while another
        # still holds the last case's state
        dist.barrier()
    model = None
    for first in range(0, world, at_once):
        if first <= rank < first + at_once:
            if case.params is None:
                full = seeded_model(case, device)
            else:
                with np.load(case.params) as f:
                    full = params_from_arrays(cfg, dict(f), device=device)
            model = shard_model(full, mesh, case_rules(case))
            del full
            _sync(device)
            if device == "cuda":
                torch.cuda.empty_cache()
        if at_once < world:
            dist.barrier()
    return model


def _kind(op: Any) -> str:
    """A collective op's kind: ``c10d_functional.all_gather_into_tensor`` and
    ``c10d.allgather_`` are both ``all_gather``."""
    name = getattr(op, "__name__", str(op)).split(".")[0].replace("_", "")
    for kind in KINDS:
        if kind.replace("_", "") in name:
            return kind
    return str(op)


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives that run under it, by kind: the functional
    collectives (``torch.ops._c10d_functional``, which DTensor's
    redistributions and ``mesh_collectives`` call), DTensor's
    ``shard_dim_alltoall`` and the ``c10d`` ops; those the autograd engine
    runs (a backward, its rematerialised forward included) in
    ``backward_counts``, the rest in ``counts``.  ``CommDebugMode`` counts
    the same ops, but its module tracker names a module only through its
    parent's forward call, which the port's functional forward never makes,
    and then fails."""

    def __init__(self, axes: dict[str, str] | None = None) -> None:
        super().__init__()
        self.counts: dict[str, int] = {}
        self.backward_counts: dict[str, int] = {}
        self.axes = dict(axes or {})  # process group name -> mesh axis
        self.bytes_by_axis: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor lowers it to ops on local tensors first
        out = func(*args, **(kwargs or {}))
        if getattr(func, "namespace", None) in ("_c10d_functional", "c10d", "_dtensor"):
            kind = _kind(func)
            if kind in KINDS:
                counts = self.backward_counts if in_backward() else self.counts
                counts[kind] = counts.get(kind, 0) + 1
                self._count_bytes(args)
        return out

    def _count_bytes(self, args) -> None:
        """The bytes of the collective's tensor inputs, under the mesh axis
        whose group ran it (``other`` for a group of no axis)."""
        axis = next((self.axes[a] for a in args if isinstance(a, str) and a in self.axes),
                    "other")
        nbytes = sum(a.numel() * a.element_size() for a in args if isinstance(a, torch.Tensor))
        self.bytes_by_axis[axis] = self.bytes_by_axis.get(axis, 0) + nbytes


def _measured(run_: dict, device: str) -> dict:
    """What every kind of case reports of one :func:`_timed` run on one
    rank."""
    tr, comm = run_["tr"], run_["comm"]
    return {
        "ms": run_["ms"],
        "peak_bytes": torch.cuda.max_memory_allocated() if device == "cuda" else None,
        "peak_reserved_bytes": torch.cuda.max_memory_reserved() if device == "cuda" else None,
        "host_staged_bytes": int(tr.counter_value("mesh.bytes.host_staged")),
        "collectives": comm.counts, "backward_collectives": comm.backward_counts,
        "collective_bytes_by_axis": comm.bytes_by_axis,
        "moe_collectives": {kind: sum(int(tr.counter_value("mesh.collectives", kind=kind,
                                                             phase=phase)) for phase in PHASES)
                            for kind in KINDS},
        "moe_collectives_by_phase": {
            phase: {kind: int(tr.counter_value("mesh.collectives", kind=kind, phase=phase))
                    for kind in KINDS} for phase in PHASES},
        "pairs_routed": int(tr.counter_value("moe.pairs.routed")),
        "pairs_dropped": int(tr.counter_value("moe.pairs.dropped")),
    }


def _group_axes(mesh: Any) -> dict[str, str]:
    """Each mesh axis's process group name -> the axis."""
    return {mesh.get_group(axis).group_name: axis for axis in mesh.mesh_dim_names}


@contextlib.contextmanager
def _timed(device: str, mesh: Any = None):
    """From a barrier to a synchronised end, under ``obs.tracing`` and a
    :class:`CollectiveCounter` (which tells ``mesh``'s axes apart): yields a
    dict that holds, after the block, the tracer (``tr``), the counter
    (``comm``) and the time (``ms``)."""
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    got: dict = {}
    dist.barrier()
    t0 = time.perf_counter()
    axes = _group_axes(mesh) if mesh is not None else None
    with obs.tracing("model_run") as tr, CollectiveCounter(axes) as comm:
        yield got
        _sync(device)
    got.update(tr=tr, comm=comm, ms=(time.perf_counter() - t0) * 1e3)


def _run_prefill(i: int, case: Case, model, mesh: Any, rank: int, device: str,
                 workdir: str) -> dict:
    cfg = case_config(case)
    rules = case_rules(case)
    inputs = {key: torch.from_numpy(val) for key, val in case_inputs(case).items()}
    step = make_prefill_step(cfg, device=device, mesh=mesh, rules=rules,
                             use_flash=case.use_flash)
    launches = flash_attention.launches
    with attention.record_flash_inputs() as captured, _timed(device, mesh) as run_:
        logits = step(model, inputs)
    launches = flash_attention.launches - launches
    full = logits.full_tensor().float().cpu().numpy()
    row = {"rank": rank, **_measured(run_, device),
           "flash_launches": launches, "aux": None, "flash_max_abs_err": None}
    if rank == 0:
        np.save(os.path.join(workdir, f"case{i}.npy"), full)
    if case.all_positions:
        with torch.no_grad(), use_mesh(mesh), axis_rules(rules):
            every, aux = backbone.forward(model, cfg, {key: val.to(device)
                                                       for key, val in inputs.items()},
                                          use_flash=case.use_flash)
            every = every.full_tensor().float().cpu().numpy()
        row["aux"] = float(aux)
        if rank == 0:
            np.save(os.path.join(workdir, f"case{i}_all.npy"), every)
    if captured:
        before = flash_attention.launches
        got = flash_attention(captured["q"], captured["k"], captured["v"],
                              causal=captured["causal"])
        flash_attention.launches = before  # a check, not the main path
        want = flash_attention_ref(captured["q"], captured["k"], captured["v"],
                                   causal=captured["causal"])
        row["flash_max_abs_err"] = float((got.float() - want.float()).abs().max())
        row["flash_shape"] = {key: list(captured[key].shape) for key in ("q", "k")}
    return row


def _gathered(t: torch.Tensor) -> np.ndarray:
    """The whole tensor in f32 on the host (every rank must call it)."""
    return t.detach().full_tensor().float().cpu().numpy()


# what torch warns when a backward crosses an op with no autograd kernel (and
# then goes on, with the gradient that op's fallback gives)
AUTOGRAD_FALLBACK = ".*autograd kernel was not registered.*"


@contextlib.contextmanager
def autograd_fallback_is_an_error():
    """Within the context, a backward through an op that has no autograd
    kernel raises instead of warning."""
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=AUTOGRAD_FALLBACK)
        yield


def _run_train(i: int, case: Case, model, mesh: Any, rank: int, device: str,
               workdir: str) -> dict:
    cfg, tcfg = case_config(case), train_config(case)
    model.requires_grad_(True)
    opt = init_opt_state(model, tcfg.optimizer)
    step_fn = make_train_step(cfg, tcfg, mesh=mesh, rules=case_rules(case))
    batch = {key: torch.from_numpy(val).to(device) for key, val in case_batch(case).items()}
    launches = flash_attention.launches
    steps = []
    for n in range(case.steps):
        with autograd_fallback_is_an_error(), _timed(device, mesh) as run_:
            _, _, metrics = step_fn(model, opt, batch, TRAIN_WARMUP + n)
        steps.append({"step": TRAIN_WARMUP + n,
                      **{key: float(metrics[key])
                         for key in ("loss", "grad_norm", "moe_aux", "xent", "lr")},
                      **_measured(run_, device)})
    if case.save_state:
        state = {f"params.{name}": _gathered(p) for name, p in model.named_parameters()}
        for key in ("m", "v"):
            state.update({f"{key}.{name}": _gathered(t) for name, t in opt[key].items()})
        if rank == 0:
            np.savez(os.path.join(workdir, f"case{i}_state.npz"), **state)
    row = {"rank": rank, "steps": steps, **(steps[-1] if steps else {}),
           "flash_launches": flash_attention.launches - launches}
    if case.checkpoint:
        row["checkpoint"] = _checkpoint_round_trip(
            i, model, opt, TRAIN_WARMUP + case.steps,
            lambda: step_fn(model, opt, batch, TRAIN_WARMUP + case.steps), rank, device, workdir)
    return row


def _local_bits(state: Any) -> list[torch.Tensor]:
    """Each piece of a state's leaves, this rank's block, as host bytes."""
    return [(p.to_local() if is_dtensor(p) else p).detach().contiguous().reshape(-1)
            .view(torch.uint8).cpu().clone() for p in ckpt_io.tensors(state)]


def _checkpoint_round_trip(i: int, model, opt: dict, at_step: int, step, rank: int,
                           device: str, workdir: str) -> dict:
    """The sharded train state through a ``CheckpointManager`` (DRC(9,6,3)
    under ``workdir/ckpt<i>``, rank 0 writing) and back: the save (``save_s``
    on the host clock), a one-process encode of the state gathered to rank 0
    (its payloads' CRCs, ``crcs_one_process``, against the save's), one
    step from the saved state (the uninterrupted step), ``node_2.bin``
    deleted, the load into the layout through the layered repair
    (``load_s``), each rank's restored blocks held to the saved ones bit for
    bit, the state copied back in place, and the same step again (the
    resumed step).  The GF kernel's launches count the save and the load."""
    mgr = ckpt_io.CheckpointManager(os.path.join(workdir, f"ckpt{i}"), device=device)
    live = train_state(model, opt)
    saved = _local_bits(live)
    gf = gf_matmul_batched.launches
    dist.barrier()
    t0 = time.perf_counter()
    mgr.save(at_step, live)
    _sync(device)
    save_s = time.perf_counter() - t0
    gf_save = gf_matmul_batched.launches - gf
    out: dict = {"save_s": save_s}
    whole = ckpt_io.gather_state(live)
    if rank == 0:
        one = ckpt_io.encode_state(whole, device=device)
        out["crcs_one_process"] = {str(n): zlib.crc32(p.cpu().numpy().tobytes())
                                   for n, p in one.payloads.items()}
        del one
    del whole
    gf_matmul_batched.launches = gf + gf_save  # the comparison's launches are not counted
    _, _, metrics = step()
    out["uninterrupted"] = {key: float(metrics[key]) for key in ("loss", "grad_norm")}
    stepdir = mgr._stepdir(at_step)
    if rank == 0:
        with open(os.path.join(stepdir, "meta.json")) as f:
            out["crcs"] = json.load(f)["crcs"]
        os.remove(os.path.join(stepdir, "node_2.bin"))
    dist.barrier()
    like = train_state(model, opt)
    t0 = time.perf_counter()
    restored, at, report = mgr.load(like)
    _sync(device)
    out.update(load_s=time.perf_counter() - t0, step=at, mode=report.mode,
               repaired_nodes=report.repaired_nodes,
               cross_rack_blocks=report.cross_rack_blocks,
               inner_rack_blocks=report.inner_rack_blocks,
               gf_launches=gf_matmul_batched.launches - gf,
               restored_equal=all(torch.equal(a, b)
                                  for a, b in zip(_local_bits(restored), saved)))
    ckpt_io.copy_state_(like, restored)
    del restored
    _, _, metrics = step()
    out["resumed"] = {key: float(metrics[key]) for key in ("loss", "grad_norm")}
    out["ckpt_dir"] = mgr.dir
    return out


def _run_decode(i: int, case: Case, model, mesh: Any, rank: int, device: str,
                workdir: str) -> dict:
    cfg = case_config(case)
    engine = ServeEngine(cfg, model, batch=case.batch, kv_len=case.kv_len, device=device,
                         mesh=mesh, rules=case_rules(case))
    inputs = case_inputs(case)
    prompts = torch.from_numpy(inputs["tokens"])
    launches = flash_attention.launches
    every = []
    with _timed(device, mesh) as prefill:
        if "frames" in inputs:  # the audio decoder reads the encoder's output
            engine.encode(torch.from_numpy(inputs["frames"]))
        for t in range(case.seq):  # one step at a time: every step's logits
            every.append(engine.prefill(prompts[:, t:t + 1]))
    with _timed(device, mesh) as generate:
        tokens = []
        for _ in range(case.new):
            tokens.append(engine.generate(1))
            every.append(engine.last_logits)
    row = {"rank": rank, **_measured(generate, device), "prefill": _measured(prefill, device),
           "tokens": torch.cat(tokens, dim=1).cpu().tolist(),
           "flash_launches": flash_attention.launches - launches}
    if rank == 0:
        np.save(os.path.join(workdir, f"case{i}.npy"), every[case.seq - 1].float().cpu().numpy())
        if case.all_positions:
            np.save(os.path.join(workdir, f"case{i}_all.npy"),
                    torch.stack(every).float().cpu().numpy())
    return row


_RUNNERS = {"prefill": _run_prefill, "train": _run_train, "decode": _run_decode}


def _rank_rows(rank: int, world: int, device: str, workdir: str,
               cases: list[Case]) -> list[dict]:
    # gloo cannot all-gather card tensors: stage that one collective
    staging = host_staging() if device == "cuda" else contextlib.nullcontext()
    with staging:
        rows, model, key, meshes = [], None, None, {}
        for i, case in enumerate(cases):
            mesh = meshes.get(case.mesh)
            if mesh is None:
                mesh = meshes[case.mesh] = make_model_mesh(case.mesh, mesh_axes(case),
                                                           device_type=device)
            build_s = 0.0
            if _model_key(case) != key:
                model = None
                if device == "cuda":
                    torch.cuda.empty_cache()
                t0 = time.perf_counter()
                model, key = _build(case, mesh, rank, world, device), _model_key(case)
                build_s = time.perf_counter() - t0
            rows.append({**_RUNNERS[case.kind](i, case, model, mesh, rank, device, workdir),
                         "build_s": build_s})
            if case.kind == "train":  # the model was updated: the next case builds its own
                model, key = None, None
    return rows


def run(cases: list[Case], *, workdir: str, device: str = "cuda") -> list[dict]:
    """Run ``cases`` in one process per mesh device (every case's mesh must
    have the same size) and return one merged result per case."""
    worlds = {math.prod(case.mesh) for case in cases}
    if len(worlds) != 1:
        raise ValueError(f"cases of one run need one world size, got {sorted(worlds)}")
    unknown = [case.kind for case in cases if case.kind not in _RUNNERS]
    if unknown:
        raise ValueError(f"unknown case kinds {unknown}; available: {sorted(_RUNNERS)}")
    world = worlds.pop()
    # the ranks share one card: expandable segments keep each allocator's
    # reserve near what it holds (their slack, 1.5 GB a rank in dbrx's
    # training, ran the card out of memory)
    env = {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"} if device == "cuda" else None
    per_rank = spawn_ranks(_rank_rows, world, workdir, (list(cases),), device=device, env=env)
    merged = []
    for i, case in enumerate(cases):
        rows = [per_rank[rank][i] for rank in range(world)]
        out = {
            "case": dataclasses.asdict(case), "world": world,
            "ranks": rows,
            "ms": max(row.get("ms", 0.0) for row in rows),
            "flash_launches": sum(row["flash_launches"] for row in rows),
            "aux": rows[0].get("aux"),
        }
        path = os.path.join(workdir, f"case{i}")
        if case.kind != "train":
            out["logits"] = np.load(path + ".npy")
        if case.all_positions and case.kind != "train":
            out["logits_all"] = np.load(path + "_all.npy")
        if case.kind == "train":
            out["steps_ms"] = [max(row["steps"][n]["ms"] for row in rows)
                               for n in range(case.steps)]
            if case.save_state:
                with np.load(path + "_state.npz") as f:
                    out["state"] = dict(f)
        if case.kind == "decode":
            out["tokens"] = np.array(rows[0]["tokens"], dtype=np.int32)
        merged.append(out)
    return merged
